"""The port's spec verifier and its parts (plutus_halo2_tpu_torch/refimpl/
{transcript,lagrange,multiopen,pairing,verifier}.py) and the trace tools
(utils/tracing.py), against the JAX package's, exactly (every value is an
integer or a point; there is no tolerance):

- verify(plan, proof, inputs, collect_traces=True) on the honest and the
  invalid proof of every committed set: the same verdict and an identical
  traces dict (parse errors included);
- Transcript reads and squeezes, the Lagrange helpers, build_msm_halo2,
  build_msm_gwc and eval_msm, the Miller loop and the final
  exponentiation on seeded inputs;
- format_traces and diff_traces give identical output;
- the spec's el and er equal TorchVerifier(device="cpu").core's el and -er
  (tracing.device_traces) on simple_mul in both flavors, diff_traces
  empty."""

import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu.models import atms as j_atms  # noqa: E402
from plutus_halo2_tpu.models import circuits as j_circuits  # noqa: E402
from plutus_halo2_tpu.refimpl import lagrange as jlag  # noqa: E402
from plutus_halo2_tpu.refimpl import multiopen as jmo  # noqa: E402
from plutus_halo2_tpu.refimpl import pairing as jpair  # noqa: E402
from plutus_halo2_tpu.refimpl import transcript as jtr  # noqa: E402
from plutus_halo2_tpu.refimpl.keygen import plan_from_vk as j_plan_from_vk  # noqa: E402
from plutus_halo2_tpu.refimpl.verifier import verify as j_verify  # noqa: E402
from plutus_halo2_tpu.utils import tracing as jtracing  # noqa: E402
from plutus_halo2_tpu.utils.serialization import vk_from_json as j_vk_from_json  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import curve as rc  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import lagrange, multiopen, pairing, transcript  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.field import Q, fr_to_le_bytes  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.verifier import verify  # noqa: E402
from plutus_halo2_tpu_torch.utils import tracing  # noqa: E402
from plutus_halo2_tpu_torch.utils.artifacts import SETS, load_set, read_set  # noqa: E402

# the JAX package's circuits, as its own tests build them: the 408-party
# construction of atms_228_408 (tests/test_artifacts.py), two parties else
_ATMS2 = ([(0, 1)] * 2, [None] * 2, 0, 1)
J_CIRCUITS = {
    "simple_mul": lambda: j_circuits.SimpleMulCircuit(),
    "simple_mul_gwc19": lambda: j_circuits.SimpleMulCircuit(),
    "lookup_table": lambda: j_circuits.LookupRangeCircuit(values=(3, 9, 14), bits=4),
    "atms": lambda: j_atms.AtmsCircuit(*_ATMS2),
    "atms_with_lookups": lambda: j_atms.AtmsLookupCircuit(*_ATMS2),
    "atms_228_408": lambda: j_atms.AtmsCircuit([(0, 1)] * 408, [None] * 408, 0, 228),
    "atms_50_90": lambda: j_atms.AtmsCircuit(*_ATMS2),
    "atms_with_lookups_50_90": lambda: j_atms.AtmsLookupCircuit(*_ATMS2),
}


@functools.lru_cache(maxsize=None)
def _sets(name):
    """(port plan, JAX plan, honest proof, invalid twin, public inputs)."""
    plan, proof, bad, pis = load_set(name)
    jplan = j_plan_from_vk(J_CIRCUITS[name](), j_vk_from_json(read_set(name)["vk.json"]), flavor=plan.flavor)
    return plan, jplan, proof, bad, pis


@pytest.mark.parametrize("which", ["honest", "invalid"])
@pytest.mark.parametrize("name", list(SETS))
def test_spec_verifier_matches_jax(name, which):
    plan, jplan, proof, bad, pis = _sets(name)
    row = proof if which == "honest" else bad
    ok, traces = verify(plan, row, pis, collect_traces=True)
    j_ok, j_traces = j_verify(jplan, row, pis, collect_traces=True)
    assert ok == j_ok == (which == "honest")
    assert traces == j_traces
    if which == "honest":
        assert sorted(traces) == sorted(["x", "y", "hEval", "vanishing_s", "instance_eval", "el", "er"])


def test_spec_verifier_rejects_bad_arguments_as_jax():
    """A wrong public-input count and a truncated proof: parse errors, the
    same message in both."""
    plan, jplan, proof, _bad, pis = _sets("simple_mul")
    for args in ((proof, pis[:-1]), (proof[:-40], pis)):
        ok, traces = verify(plan, *args)
        assert (ok, traces) == j_verify(jplan, *args)
        assert not ok and "parse_error" in traces


def _points(rng, n):
    return [rc.g1_mul(rc.G1_GEN, rng.randrange(1, Q)) for _ in range(n)]


def test_transcript_matches_jax():
    """Reads and squeezes through a seeded proof of five (point, scalar)
    pairs, a scalar absorbed past q, and the end-of-proof guard."""
    rng = random.Random(2)
    pairs = [(p, rng.randrange(Q)) for p in _points(rng, 5)]
    proof = b"".join(rc.g1_compress(p) + fr_to_le_bytes(s) for p, s in pairs)
    t, jt = transcript.Transcript(proof, 12345), jtr.Transcript(proof, 12345)
    assert t.common_scalar(Q + 7) == jt.common_scalar(Q + 7)
    for p, s in pairs:
        assert t.read_point() == jt.read_point() == p
        assert t.read_scalar() == jt.read_scalar() == s
        assert t.squeeze_challenge() == jt.squeeze_challenge()
    assert bytes(t.acc) == bytes(jt.acc)
    with pytest.raises(ValueError, match="not enough bytes"):
        t.read_scalar()
    assert transcript.blake2b_256(b"abc") == jtr.blake2b_256(b"abc")


def test_lagrange_matches_jax():
    rng = random.Random(3)
    omega, omega_inv = 0x1234567, pow(0x1234567, Q - 2, Q)
    x, xn, bary = rng.randrange(Q), rng.randrange(Q), rng.randrange(Q)
    rots = lagrange.rotated_omegas(omega, omega_inv, -3, 2)
    assert rots == jlag.rotated_omegas(omega, omega_inv, -3, 2)
    assert lagrange.rotate_omega(omega, omega_inv, 9, -2) == jlag.rotate_omega(omega, omega_inv, 9, -2)
    basis = lagrange.lagrange_polynomial_basis(x, xn, bary, rots)
    assert basis == jlag.lagrange_polynomial_basis(x, xn, bary, rots)
    pts = [(rng.randrange(Q), rng.randrange(Q)) for _ in range(4)]
    assert lagrange.lagrange_evaluation(pts, x) == jlag.lagrange_evaluation(pts, x)
    assert lagrange.powers(6, x) == jlag.powers(6, x)


def test_build_msm_halo2_matches_jax():
    """Two point sets (one point, two points) over five commitments."""
    rng = random.Random(4)
    coms = _points(rng, 5)
    sets = [[rng.randrange(Q)], [rng.randrange(Q), rng.randrange(Q)]]
    cmap = [(c, i % 2, sets[i % 2], [rng.randrange(Q) for _ in sets[i % 2]]) for i, c in enumerate(coms)]
    x1p, x4p = lagrange.powers(3, rng.randrange(Q)), lagrange.powers(3, rng.randrange(Q))
    args = (x1p, rng.randrange(Q), rng.randrange(Q), x4p, *_points(rng, 2), [rng.randrange(Q) for _ in sets],
            cmap, sets)
    msm = multiopen.build_msm_halo2(*args)
    assert msm == jmo.build_msm_halo2(*args)
    assert multiopen.eval_msm(msm) == jmo.eval_msm(msm)


def test_build_msm_gwc_matches_jax():
    """Queries over three rotations in interleaved order, one commitment
    queried at two of them."""
    rng = random.Random(5)
    coms = _points(rng, 4)
    rots = ["cur", "next", "cur", "prev", "next"]
    queries = [(rot, coms[i % 4], rng.randrange(Q)) for i, rot in enumerate(rots)]
    args = (rng.randrange(Q), rng.randrange(Q), queries, _points(rng, 3), [rng.randrange(Q) for _ in range(3)])
    left, right = multiopen.build_msm_gwc(*args)
    assert (left, right) == jmo.build_msm_gwc(*args)
    assert multiopen.group_queries_by_rotation(queries) == jmo.group_queries_by_rotation(queries)
    assert multiopen.eval_msm(right) == jmo.eval_msm(right)


def test_pairing_matches_jax():
    """Miller loops and the final exponentiation on seeded points, and the
    bilinearity check e(aP, Q) e(-P, aQ) == 1."""
    rng = random.Random(6)
    a = rng.randrange(1, Q)
    p, q = rc.g1_mul(rc.G1_GEN, rng.randrange(1, Q)), rc.g2_mul(rc.G2_GEN, rng.randrange(1, Q))
    f = pairing.miller_loop(p, q)
    assert f == jpair.miller_loop(p, q)
    assert pairing.final_exponentiation(f) == jpair.final_exponentiation(f)
    assert pairing.miller_loop(None, q) == pairing.FP12_ONE
    pairs = [(rc.g1_mul(p, a), q), (rc.g1_neg(p), rc.g2_mul(q, a))]
    assert pairing.pairing_check(pairs) and jpair.pairing_check(pairs)
    assert pairing.final_verify(f, f) and not pairing.final_verify(f, pairing.miller_loop(p, rc.G2_GEN))


def test_format_and_diff_traces_match_jax():
    plan, _jplan, proof, _bad, pis = _sets("simple_mul")
    traces = verify(plan, proof, pis, collect_traces=True)[1]
    other = dict(traces, x=traces["x"] + 1, el=None, extra=3)
    other["parse_error"] = "text"
    assert tracing.format_traces(traces) == jtracing.format_traces(traces)
    assert tracing.format_traces(other) == jtracing.format_traces(other)
    assert "el: G1(x=0x" in tracing.format_traces(traces)
    assert tracing.diff_traces(traces, other) == jtracing.diff_traces(traces, other) == ["x", "el"]
    assert tracing.diff_traces(traces, traces) == []


@pytest.mark.parametrize("name", ["simple_mul", "simple_mul_gwc19"])
def test_spec_pairing_sides_equal_torch_core(name):
    """The spec's el / er against core()'s el / -er on the honest proof and
    on a proof with a corrupted scalar (which decodes, then fails only the
    pairing): diff_traces finds no key."""
    plan, _jplan, proof, _bad, pis = _sets(name)
    v = TorchVerifier(plan, device="cpu", subgroup_check="off")
    bad = bytearray(proof)
    bad[list(v.layout.scalar_offsets.values())[0] + 3] ^= 0x40
    rows = np.stack([np.frombuffer(proof, np.uint8), np.frombuffer(bytes(bad), np.uint8)])
    device = tracing.device_traces(v, rows, v.encode_public_inputs([pis] * 2))
    for row, dev in zip(rows, device):
        ok, spec = verify(plan, bytes(row), pis, collect_traces=True)
        assert tracing.diff_traces(spec, dev) == []
        assert spec["el"] == dev["el"] and spec["er"] == dev["er"]
    assert [verify(plan, bytes(r), pis)[0] for r in rows] == [True, False]
