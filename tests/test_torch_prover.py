"""The port's proof generators against the JAX package's, on the CPU: the
plain versions of the Fr polynomial kernels (ops/poly.py) against the JAX
package's Python-int path and its host C++ runtime (native/), the port's
refimpl/poly.py, Jubjub and Rescue against the JAX modules, keygen's VK
text, a ProvingKey made from the JAX key's state, and prove()'s bytes, for
simple_mul (halo2-book and GWC19) and lookup_table. Inputs come from seeded
numpy generators; every comparison is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu import native  # noqa: E402
from plutus_halo2_tpu.models import circuits as jcircuits  # noqa: E402
from plutus_halo2_tpu.models.plan import FLAVOR_GWC as J_GWC, FLAVOR_HALO2 as J_HALO2  # noqa: E402
from plutus_halo2_tpu.refimpl import jubjub as jjub, poly as jpoly, rescue as jres  # noqa: E402
from plutus_halo2_tpu.refimpl.keygen import keygen as jkeygen  # noqa: E402
from plutus_halo2_tpu.refimpl.prover import prove as jprove  # noqa: E402
from plutus_halo2_tpu.refimpl.srs import TrapdoorSRS as JSRS  # noqa: E402
from plutus_halo2_tpu.utils.serialization import vk_to_json as jvk_to_json  # noqa: E402

from plutus_halo2_tpu_torch.models import circuits  # noqa: E402
from plutus_halo2_tpu_torch.models.plan import FLAVOR_GWC, FLAVOR_HALO2  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_poly, poly as tpoly  # noqa: E402
from plutus_halo2_tpu_torch.refimpl import jubjub, poly, rescue  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.field import Q  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.keygen import PK_STATE_KEYS, keygen, proving_key_from_state  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.prover import prove  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.srs import TrapdoorSRS  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.transcript import ProverTranscript, Transcript  # noqa: E402
from plutus_halo2_tpu_torch.utils.serialization import vk_to_json  # noqa: E402


def _vals(n, seed):
    rng = np.random.default_rng(seed)
    out = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(n)]
    out[: min(n, 3)] = [0, 1, Q - 1][: min(n, 3)]
    return out


@pytest.fixture
def python_path(monkeypatch):
    """The JAX package's refimpl/poly.py with its native runtime off."""
    monkeypatch.setattr(jpoly, "_NATIVE_MIN_N", 1 << 40)
    return jpoly


def _run_plain(fn, a, k):
    t = tpoly.to_words(a, "cpu")
    if fn == "ntt":
        return tpoly.from_words(cuda_poly.fr_ntt(t, k))
    if fn == "mul":
        return tpoly.from_words(cuda_poly.fr_mul_array(t, tpoly.to_words(list(reversed(a)), "cpu")))
    if fn == "scale":
        return tpoly.from_words(cuda_poly.fr_scale_array(t, k))
    return tpoly.from_words(cuda_poly.fr_powers_mul_array(t, k))


@pytest.mark.parametrize("lg", range(2, 13))
@pytest.mark.parametrize("fn", ["ntt", "mul", "scale", "powers_mul"])
def test_plain_poly_kernels_against_the_jax_package(python_path, fn, lg):
    """The plain versions of the four kernels on CPU tensors, equal to the
    JAX package's Python-int path and to its host C++ runtime."""
    n = 1 << lg
    a = _vals(n, lg)
    k = jpoly.domain_omega(lg) if fn == "ntt" else _vals(4, 100 + lg)[3]
    got = _run_plain(fn, a, k)
    if fn == "ntt":
        want, nat = python_path.ntt(list(a), k), native.ntt(a, k)
    elif fn == "mul":
        want, nat = [x * y % Q for x, y in zip(a, reversed(a))], native.mul_array(a, list(reversed(a)))
    elif fn == "scale":
        want, nat = python_path.poly_scale(a, k), native.scale_array(a, k)
    else:
        want = [x * pow(k, i, Q) % Q for i, x in enumerate(a)]
        nat = native.powers_mul_array(a, k)
    assert got == want
    if native.available():
        assert got == nat


@pytest.mark.parametrize("n", [4, 64, 128, 256, 1024])
@pytest.mark.parametrize("fn", ["ntt", "intt", "coset_evaluate", "coset_interpolate", "divide_linear"])
def test_refimpl_poly_against_the_jax_package(fn, n):
    """The port's refimpl/poly.py (device "cpu": the plain versions from 128
    elements) against the JAX package's, on both sides of the threshold."""
    k = n.bit_length() - 1
    w, a = poly.domain_omega(k), _vals(n, n)
    if fn == "ntt":
        assert poly.ntt(a, w, "cpu") == jpoly.ntt(a, w)
    elif fn == "intt":
        assert poly.intt(a, w, "cpu") == jpoly.intt(a, w)
    elif fn == "coset_evaluate":
        ew = poly.domain_omega(k + 2)
        assert poly.coset_evaluate(a, 4 * n, ew, device="cpu") == jpoly.coset_evaluate(a, 4 * n, ew)
    elif fn == "coset_interpolate":
        ew = poly.domain_omega(k)
        assert poly.coset_interpolate(a, ew, device="cpu") == jpoly.coset_interpolate(a, ew)
    else:
        z = a[5 % n]
        p = poly.poly_add(a, [(-poly.poly_eval(a, z)) % Q])
        assert poly.poly_divide_linear(p, z) == jpoly.poly_divide_linear(p, z)


def test_poly_default_device_is_the_card(monkeypatch):
    """From 128 elements a poly call with no device goes to the card, and
    raises where there is none; below, the Python-int path runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        poly.ntt(_vals(128, 1), poly.domain_omega(7))
    a = _vals(64, 2)
    assert poly.ntt(a, poly.domain_omega(6)) == jpoly.ntt(a, jpoly.domain_omega(6))


@pytest.mark.parametrize("case", ["keygen", "sign", "verify", "reject", "generator"])
def test_jubjub_against_the_jax_package(case):
    sk, pk = jubjub.keygen(b"party-7")
    if case == "keygen":
        assert (sk, pk) == jjub.keygen(b"party-7")
        return
    if case == "generator":
        assert jubjub.GEN == jjub.GEN and jubjub.D == jjub.D and jubjub.ORDER == jjub.ORDER
        return
    msg = _vals(4, 7)[3]
    sig = jubjub.sign(sk, msg, rescue.hash_fr, b"seed")
    if case == "sign":
        assert sig == jjub.sign(sk, msg, jres.hash_fr, b"seed")
    elif case == "verify":
        assert jubjub.verify(pk, msg, sig, rescue.hash_fr) and jjub.verify(pk, msg, sig, jres.hash_fr)
    else:
        assert not jubjub.verify(pk, msg + 1, sig, rescue.hash_fr)
        assert not jjub.verify(pk, msg + 1, sig, jres.hash_fr)


@pytest.mark.parametrize("length", [0, 1, 2, 3, 5, 8])
def test_rescue_hash_against_the_jax_package(length):
    xs = _vals(length, 40 + length)
    assert rescue.hash_fr(xs) == jres.hash_fr(xs)
    assert rescue.RC == jres.RC and rescue.ALPHA_INV == jres.ALPHA_INV


def test_prover_transcript_round_trips_through_the_verifier_transcript():
    """Scalars and points written by ProverTranscript read back through
    Transcript with the same challenges."""
    from plutus_halo2_tpu_torch.refimpl.curve import G1_GEN, g1_mul

    pt = ProverTranscript(123)
    pt.common_scalar(5)
    pt.write_point(g1_mul(G1_GEN, 9))
    c1 = pt.squeeze_challenge()
    pt.write_scalar(77)
    c2 = pt.squeeze_challenge()
    vt = Transcript(pt.finalize(), 123)
    vt.common_scalar(5)
    assert vt.read_point() == g1_mul(G1_GEN, 9)
    assert vt.squeeze_challenge() == c1
    assert vt.read_scalar() == 77 and vt.squeeze_challenge() == c2


CASES = {  # name -> (port circuit, JAX circuit, port flavor, JAX flavor, inputs)
    "simple_mul": (lambda: circuits.SimpleMulCircuit(), lambda: jcircuits.SimpleMulCircuit(), FLAVOR_HALO2, J_HALO2,
                   [42, 42, 42]),
    "simple_mul_gwc19": (lambda: circuits.SimpleMulCircuit(), lambda: jcircuits.SimpleMulCircuit(), FLAVOR_GWC,
                         J_GWC, [42, 42, 42]),
    "lookup_table": (lambda: circuits.LookupRangeCircuit(values=(3, 9, 14), bits=4),
                     lambda: jcircuits.LookupRangeCircuit(values=(3, 9, 14), bits=4), FLAVOR_HALO2, J_HALO2, [7]),
}


def _both(name, seed=b"test-srs"):
    """(port key, plan, circuit), (JAX key, plan, circuit) over one SRS."""
    pc, jc, pf, jf, _inputs = CASES[name]
    port_c, jax_c = pc(), jc()
    pk, plan = keygen(port_c, flavor=pf, srs=TrapdoorSRS.from_seed(seed), device="cpu")
    jpk, jplan = jkeygen(jax_c, flavor=jf, srs=JSRS.from_seed(seed))
    return (pk, plan, port_c), (jpk, jplan, jax_c)


@pytest.mark.parametrize("name", list(CASES))
def test_keygen_vk_text_equals_the_jax_package(name):
    (_pk, plan, _c), (_jpk, jplan, _jc) = _both(name)
    assert vk_to_json(plan.vk) == jvk_to_json(jplan.vk)


@pytest.mark.parametrize("name", list(CASES))
def test_prove_bytes_equal_the_jax_package(name):
    (pk, plan, c), (jpk, jplan, jc) = _both(name)
    inputs = CASES[name][4]
    for seed in (b"plutus-halo2-tpu-proof", b"another-seed"):
        assert prove(pk, plan, c, inputs, seed=seed, device="cpu") == jprove(jpk, jplan, jc, inputs, seed=seed)


@pytest.mark.parametrize("name", ["simple_mul", "lookup_table"])
def test_proving_key_from_jax_state_proves_the_same_bytes(name):
    (pk, plan, c), (jpk, _jplan, _jc) = _both(name, seed=b"state-srs")
    state = {key: getattr(jpk, key) for key in PK_STATE_KEYS if key != "tau"}
    state["fixed_values"] = [np.array(col, dtype=object) for col in state["fixed_values"]]
    state["tau"] = jpk.srs.tau
    pk2 = proving_key_from_state(state, CASES[name][0]())
    inputs = CASES[name][4]
    assert prove(pk2, plan, c, inputs, device="cpu") == prove(pk, plan, c, inputs, device="cpu")
    with pytest.raises(ValueError, match="lacks"):
        proving_key_from_state({k: v for k, v in state.items() if k != "tau"}, c)


def test_prove_default_device_is_the_card(monkeypatch):
    (pk, plan, c), _jax = _both("simple_mul")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        prove(pk, plan, c, [42, 42, 42])
    with pytest.raises(RuntimeError, match="CUDA"):
        keygen(circuits.LookupRangeCircuit(values=(3, 9, 14), bits=4), srs=TrapdoorSRS.from_seed(b"x"))
