"""ATMS 50/90 with lookups in the GWC19 flavor
(``plutus_halo2_tpu_torch/artifacts/atms_with_lookups_50_90_gwc19_*``, the
source's own deployment) through ``TorchVerifier.verify()`` on the CPU,
eager, every stage through its plain version, at B = 5:

- rows: the honest proof, its committed invalid twin, a bit flipped in a
  proof point, a bit flipped in a proof scalar, and a scalar written as
  s + q (the transcript absorbs it as written);
- the port's verdicts equal, row by row, those of the port's spec verifier
  (``refimpl/verifier.py``) and of the benchmark's plain reference
  (``portbench/reference/verifier.py``), which share no code;
- ``core()``'s el and -er equal the spec's exactly wherever the spec
  reaches the pairing equation;
- the two multi-open MSMs have K = 4 (the W_i) and 38, the reference's
  live terms plus the VK's one identity commitment; the benchmark's copy
  of the set is the port's;
- the JAX package's spec verifier accepts the honest proof and rejects
  its twin, as the port does;
- ``examples/atms.set_name`` gives a GWC19 set a name of its own.

Nothing is proven here. The ``gpu``-marked test holds the graph form at
B = 1024 against the eager form on the card: ``python -m pytest
tests/test_torch_gwc_atms.py -m gpu --noconftest`` (JAX is imported only
inside the CPU test that needs it)."""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu_torch.examples.atms import set_name  # noqa: E402
from plutus_halo2_tpu_torch.models.layout import build_layout  # noqa: E402
from plutus_halo2_tpu_torch.models.plan import FLAVOR_GWC, FLAVOR_HALO2  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.ops.curve import CheckedWeights  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.field import Q  # noqa: E402
from plutus_halo2_tpu_torch.refimpl.verifier import verify as spec_verify  # noqa: E402
from plutus_halo2_tpu_torch.utils import tracing  # noqa: E402
from plutus_halo2_tpu_torch.utils.artifacts import SETS, load_set, read_set  # noqa: E402
from portbench import spec as bench_spec  # noqa: E402
from portbench.reference import verifier as ref  # noqa: E402
from portbench.reference.artifacts import plan_from_spec  # noqa: E402
from portbench.reference.artifacts import vk_from_json as ref_vk_from_json  # noqa: E402

NAME = "atms_with_lookups_50_90_gwc19"
KINDS = ("honest", "invalid_twin", "point_bit", "scalar_bit", "noncanonical_scalar")


@functools.lru_cache(maxsize=None)
def _rows():
    """(port plan, (5, PLEN) uint8 rows in KINDS order, public inputs)."""
    plan, proof, bad, pis = load_set(NAME)
    lay = build_layout(plan)
    point, scalar = list(lay.point_offsets.values())[2], list(lay.scalar_offsets.values())[3]
    rows = np.stack([np.frombuffer(p, np.uint8) for p in (proof, bad, proof, proof, proof)]).copy()
    rows[2, point + 20] ^= 0x08
    rows[3, scalar + 5] ^= 0x10
    s = int.from_bytes(proof[scalar: scalar + 32], "little") + Q  # s < q, so s + q < 2^256
    rows[4, scalar: scalar + 32] = np.frombuffer(s.to_bytes(32, "little"), np.uint8)
    return plan, rows, pis


@pytest.fixture(scope="module")
def gwc_atms():
    plan, rows, pis = _rows()
    files = read_set(NAME)
    config = json.loads((bench_spec.HERE / "configs" / f"{NAME}.json").read_text())
    circuit = bench_spec.load_module(bench_spec.HERE / "configs" / f"{NAME}.py", NAME)
    ref_plan = plan_from_spec(circuit.spec(), ref_vk_from_json(files["vk.json"]), config["flavor"],
                              circuit.NUM_PUBLIC_INPUTS)
    specs = [spec_verify(plan, bytes(r), pis, collect_traces=True) for r in rows]
    outcomes = [ref.verify(ref_plan, bytes(r), pis) for r in rows]
    v = TorchVerifier(plan, device="cpu")
    pis_t = v.encode_public_inputs([pis] * len(rows))
    hints = v.compute_y_hints(rows)
    weights = v.subgroup_weights(torch.Generator().manual_seed(7))
    verdicts = v.verify(rows, pis_t, hints, sub_weights=weights).tolist()
    counts = list(v.msm_term_counts)
    sides = tracing.device_traces(v, rows, pis_t, hints, CheckedWeights(weights))
    return dict(plan=plan, rows=rows, pis=pis, config=config, specs=specs, outcomes=outcomes,
                verdicts=verdicts, counts=counts, sides=sides)


def test_the_set_is_gwc19_at_the_sources_shape(gwc_atms):
    plan, config = gwc_atms["plan"], gwc_atms["config"]
    lay = build_layout(plan)
    assert SETS[NAME][2] == plan.flavor == FLAVOR_GWC == config["flavor"]
    assert plan.vk.k == config["k"] == 20
    assert (len(lay.point_offsets), len(lay.scalar_offsets), lay.proof_len) == (
        config["proof_points"], config["proof_scalars"], config["proof_bytes"])
    assert [n for n, _l in lay.squeezes][-2:] == ["v", "u"]
    copy = bench_spec.HERE / "configs" / config["artifacts"]
    for suffix in ("proof.hex", "proof_invalid.hex", "public_input.hex", "vk.json"):
        assert (copy.parent / f"{copy.name}_{suffix}").read_text() == read_set(NAME)[suffix], suffix


def test_verdicts_equal_both_plain_verifiers(gwc_atms):
    spec = [ok for ok, _t in gwc_atms["specs"]]
    assert spec == [o.accepted for o in gwc_atms["outcomes"]] == gwc_atms["verdicts"]
    assert spec == [True, False, False, False, False]


def test_pairing_sides_equal_the_spec(gwc_atms):
    compared = 0
    for kind, (_ok, traces), side in zip(KINDS, gwc_atms["specs"], gwc_atms["sides"]):
        if "el" in traces:
            assert (side["el"], side["er"]) == (traces["el"], traces["er"]), kind
            compared += 1
    assert compared >= 3  # the honest row, the twin and the scalar flips reach the equation


def test_two_msms_at_the_references_term_counts(gwc_atms):
    """The port de-duplicates a side's terms by commitment and keeps a VK
    commitment that is the identity (the all-zero q_cd column's): the
    reference's merge drops it, so its right side has one live term
    fewer than the kernel's K."""
    honest = gwc_atms["outcomes"][0]
    left, right = (len(m) for m in honest.msms)
    identity = [i for i, c in enumerate(gwc_atms["plan"].vk.fixed_commitments) if c is None]
    assert identity == [6]
    assert gwc_atms["counts"] == [4, 38] == [left, right + len(identity)]
    assert gwc_atms["config"]["msm_terms_by_side"] == {"left": 4, "right": 38}
    assert gwc_atms["config"]["msm_terms"] == sum(gwc_atms["counts"])


def test_the_jax_spec_verifier_agrees():
    from plutus_halo2_tpu.models import atms as j_atms
    from plutus_halo2_tpu.refimpl.keygen import plan_from_vk as j_plan_from_vk
    from plutus_halo2_tpu.refimpl.verifier import verify as j_verify
    from plutus_halo2_tpu.utils.serialization import vk_from_json as j_vk_from_json

    _plan, rows, pis = _rows()
    jplan = j_plan_from_vk(j_atms.AtmsLookupCircuit([(0, 1)] * 2, [None] * 2, 0, 1),
                           j_vk_from_json(read_set(NAME)["vk.json"]), flavor=FLAVOR_GWC)
    assert [j_verify(jplan, bytes(r), pis)[0] for r in rows[:2]] == [True, False]


@pytest.mark.parametrize("args,name", [
    ((90, 50, True, FLAVOR_GWC), "atms_with_lookups_50_90_gwc19"),
    ((90, 50, False, FLAVOR_GWC), "atms_50_90_gwc19"),
    ((2, 1, True, FLAVOR_GWC), "atms_with_lookups_gwc19"),
    ((90, 50, True, FLAVOR_HALO2), "atms_with_lookups_50_90"),
    ((90, 50, True), "atms_with_lookups_50_90"),
    ((90, 50, False), "atms_50_90"),
    ((408, 228, False), "atms_228_408"),
    ((2, 1, False), "atms"),
    ((2, 1, True), "atms_with_lookups"),
])
def test_set_names(args, name):
    assert set_name(*args) == name


@pytest.mark.gpu
def test_graph_form_equals_eager_on_the_card():
    """B = 1024 rows cycling over the five kinds: verify()'s captured graph
    (replayed) and core()'s, against the same bodies run eagerly on the
    card, on the same inputs and weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    plan, rows, pis = _rows()
    B = 1024
    batch = np.ascontiguousarray(rows[np.arange(B) % len(rows)])
    v = TorchVerifier(plan, device="cuda")
    pis_t = v.encode_public_inputs([pis] * B)
    hints = v.compute_y_hints(batch)
    weights = v.subgroup_weights(torch.Generator().manual_seed(11))
    graph = [v.verify(batch, pis_t, hints, sub_weights=weights).cpu() for _ in range(2)]
    assert (v.programs.captures, v.programs.replays) == (1, 1)
    v.graphs = False
    eager = v.verify(batch, pis_t, hints, sub_weights=weights).cpu()
    v.graphs = True
    want = torch.tensor([True, False, False, False, False]).repeat(B // 5 + 1)[:B]
    assert torch.equal(graph[1], eager) and torch.equal(graph[0], eager) and torch.equal(eager, want)
    assert v.msm_term_counts == [4, 38]

    def body(proof, pis_d, hints_d, sub_w):
        return v.core(proof, pis_d, hints_d, CheckedWeights(sub_w))

    args = v._inputs(batch, pis_t, hints, weights)
    key = ("core", *v._key("verify", args))
    for _ in range(2):  # the capture, then a replay
        replayed = v.programs.run(key, body, args)
    direct = body(*v._on_device(*args))
    for a, b in zip(replayed, direct):
        assert torch.equal(a, b)
