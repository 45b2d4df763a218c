"""The captured programs' bodies on the CPU (``models/programs.py``: on the
card ``verify()`` and ``verify_rlc_device()`` replay one CUDA graph per key;
the CPU runs the same bodies eagerly).

(i) ``_verify_body`` and ``_rlc_body`` in the default, hintless, ``off``
and ``exact`` modes, after the host-side preparation (``_inputs``) and one
warm-up run, under a dispatch mode that raises on every op a CUDA graph
cannot capture: a read of a device value (``_local_scalar_dense``: .item(),
bool(), int()), ``nonzero`` and ``masked_select``, indexing with a boolean
mask (a shape that depends on the data), and a tensor made from host data
(``lift_fresh``: on the card a copy from pageable host memory). The
kernels' plain versions, which the CPU runs where the card launches a
kernel, run with the mode suspended, as a launch is opaque to it on the
card. (ii), ``verify_rlc_device`` + ``rlc_finalize`` against
``JaxVerifier``, is in test_torch_programs_jax.py. (iii) the fixed-shape ``_final`` against the JAX package's ``_final_impl``
at 0, 1, some and R live slots, with idle slots that alias row 0; (iv) the
gated pairing's plain version at enable false and true; (v) a body called
twice on buffers refilled with another batch gives each batch's verdicts."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes  # noqa: E402

from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_blake, cuda_curve, cuda_field, cuda_pairing  # noqa: E402
from plutus_halo2_tpu_torch.ops import pairing as tp  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu_torch.tools.pairing_probe import S, check_rows  # noqa: E402
from test_torch_rlc import B, GROUP, _scalar_byte, setup  # noqa: E402,F401  (the RLC tests' fixture)

aten = torch.ops.aten
_UNCAPTURABLE = {aten._local_scalar_dense.default, aten.nonzero.default, aten.masked_select.default,
                 aten.lift_fresh.default}
_INDEXING = {aten.index.Tensor, aten.index_put.default, aten.index_put_.default, aten._index_put_impl_.default}
# the plain versions the kernel wrappers run on CPU tensors
_PLAIN = ((cuda_blake, "transcript_hashes_plain"), (cuda_field, "pow_plain"), (cuda_curve, "msm_plain"),
          (cuda_curve, "decompress_hinted_plain"), (cuda_curve, "aggregate_subgroup_check_plain"),
          (cuda_pairing, "pairing_check_plain"))


@pytest.fixture
def plain_as_launches(monkeypatch):
    """The plain versions run with the dispatch mode suspended: on the card
    each is one kernel launch, which the mode cannot see into."""
    def opaque(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with _disable_current_modes():
                return fn(*args, **kwargs)
        return run

    for mod, name in _PLAIN:
        monkeypatch.setattr(mod, name, opaque(getattr(mod, name)))


class NoHostSync(TorchDispatchMode):
    """Raises on the ops a CUDA graph cannot capture (see the module's
    docstring); counts the ops it let through."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _UNCAPTURABLE:
            raise AssertionError(f"{func} in a program body")
        if func in _INDEXING and any(t is not None and t.dtype in (torch.bool, torch.uint8) for t in args[1]):
            raise AssertionError(f"{func} with a boolean mask in a program body")
        self.ops += 1
        return func(*args, **(kwargs or {}))


def test_the_mode_catches_each_uncapturable_op():
    x = torch.arange(4)
    for fn in (lambda: bool(x.any()), lambda: int(x.sum()), lambda: x.nonzero(), lambda: x[x > 1],
               lambda: x.masked_fill(x > 1, 0).masked_select(x > 0), lambda: torch.tensor([1, 2])):
        with pytest.raises(AssertionError), NoHostSync():
            fn()
    with NoHostSync() as m:  # what the bodies use instead
        torch.where(x > 1, x, 4).scatter(0, torch.arange(2), x[:2])
    assert m.ops > 0


def _batch(tv, proof, tampered_rows=(), scalar_rows=()):
    proofs = np.stack([proof] * B)
    for r in tampered_rows:
        proofs[r, 100] ^= 0x40  # its third point no longer decodes
    for r in scalar_rows:
        proofs[r, _scalar_byte(tv, 0)] ^= 0x40  # only the pairing rejects it
    return proofs


@pytest.mark.parametrize("mode,hinted", [("aggregate", True), ("aggregate", False), ("off", False),
                                         ("exact", True)])
def test_bodies_capture_no_host_sync(setup, plain_as_launches, mode, hinted):
    plan, _jplan, proof, pis, _tv = setup
    tv = TorchVerifier(plan, device="cpu", subgroup_check=mode)
    proofs = _batch(tv, proof, tampered_rows=[6], scalar_rows=[1])
    hints = tv.compute_y_hints(proofs) if hinted else None
    g = torch.Generator().manual_seed(5)
    args = tv._on_device(*tv._inputs(proofs, pis, hints, tv.subgroup_weights(g)))
    weights = tv.rlc_weights(B, g)
    want = [True, False, True, True, True, True, False, True]
    assert tv._verify_body(*args).tolist() == want  # the warm-up: fills the per-device caches
    with NoHostSync() as m:
        got = tv._verify_body(*args)
    assert got.tolist() == want
    assert m.ops > 1000
    with NoHostSync() as m:
        got = tv._rlc_body(*args, weights, group=GROUP, R=B)
    assert got[0].tolist() == want
    assert int(got[1]) == 4  # the scalar row's group re-checked through the gated pairing


@pytest.mark.parametrize("n_live", [0, 1, 3, 8])
def test_final_matches_jax_final_impl(setup, n_live):
    from plutus_halo2_tpu.models.verifier_jax import JaxVerifier

    import jax.numpy as jnp

    _plan, _jplan, _proof, _pis, tv = setup
    R = 8
    rng = np.random.default_rng(n_live)
    verdicts0 = torch.from_numpy(rng.integers(0, 2, B).astype(bool))
    live_rows = rng.permutation(B)[:n_live]
    idx = torch.zeros(R, dtype=torch.int64)  # the idle slots alias row 0
    idx[:n_live] = torch.from_numpy(live_rows)
    live = torch.arange(R) < n_live
    row_ok = torch.from_numpy(rng.integers(0, 2, R).astype(bool))
    row_ok[n_live:] = ~verdicts0[0]  # an idle slot's verdict would flip row 0
    got = tv._final(verdicts0, idx, live, row_ok)
    idx_w = np.where(live.numpy(), idx.numpy(), B)
    want = np.asarray(JaxVerifier._final_impl(jnp.asarray(verdicts0.numpy()), jnp.asarray(idx_w),
                                              jnp.asarray(row_ok.numpy())))
    assert got.tolist() == want.tolist()
    expect = verdicts0.clone()
    expect[torch.from_numpy(live_rows)] = row_ok[:n_live]
    assert got.tolist() == expect.tolist()
    assert got.shape == (B,)


def test_gated_pairing_plain_version():
    pp = cuda_pairing.PreparedPair(tp.prepare_g2(rc.g2_mul(rc.G2_GEN, S)), tp.prepare_g2(rc.G2_GEN))
    el, er, want = check_rows(6, 6, torch.device("cpu"))
    assert not bool(want.all())
    on = cuda_pairing.pairing_check(el, er, pp, enable=torch.tensor(True))  # CPU: the plain version
    off = cuda_pairing.pairing_check(el, er, pp, enable=torch.tensor(0, dtype=torch.int32))
    assert on.tolist() == want.tolist()
    assert off.tolist() == [True] * 6


def test_body_on_refilled_buffers_gives_each_batchs_verdicts(setup):
    """The RLC body (core, aggregation, both pairings, the scatter) on
    buffers holding a mixed batch, then refilled with an honest one."""
    plan, _jplan, proof, pis, _tv = setup
    tv = TorchVerifier(plan, device="cpu")
    g = torch.Generator().manual_seed(9)
    sw = tv.subgroup_weights(g)
    weights = tv.rlc_weights(B, g)
    mixed = _batch(tv, proof, tampered_rows=[2], scalar_rows=[7])
    honest = _batch(tv, proof)
    static = [a.clone() for a in tv._inputs(mixed, pis, tv.compute_y_hints(mixed), sw)]  # the buffers
    for proofs, want, n_sus in ((mixed, [True, True, False, True, True, True, True, False], 4),
                                (honest, [True] * B, 0)):
        for s, a in zip(static, tv._inputs(proofs, pis, tv.compute_y_hints(proofs), sw)):
            s.copy_(a)
        got = tv._rlc_body(*static, weights, group=GROUP, R=B)
        assert got[0].tolist() == want
        assert int(got[1]) == n_sus
