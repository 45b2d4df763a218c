"""The port's recorder (``utils/tracing.py``) on the CPU.

Tracing off records nothing and leaves a program's key as it was, and on
gives the traced program a key of its own; a traced call's spans share its
record and nest under ``ph2.call``; an eager body's stages tile it (each
top-level stage starts where the one before it ends, from the body's
start to its end, children inside their parents) for ``verify()`` and
``verify_rlc_device()`` in both multi-open flavors (GWC19's left MSM the
stage ``msm_w``); a call carries its MSM term counts; self times subtract
children; the ring counts what it overwrites; and under the profiler each
span is a host op of its name. The pairing, MSM, subgroup and Fp pow
kernels' plain versions are replaced by cheap stand-ins of their shapes:
these tests read the stages, not the verdicts (the graph form's on the
card: test_torch_tracing_gpu.py)."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from plutus_halo2_tpu_torch.models import programs  # noqa: E402
from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier  # noqa: E402
from plutus_halo2_tpu_torch.ops import cuda_curve, cuda_pairing  # noqa: E402
from plutus_halo2_tpu_torch.utils import tracing  # noqa: E402
from plutus_halo2_tpu_torch.utils.artifacts import load_set  # noqa: E402

B = 2
TOP = {"verify": ["transcript", "decompress", "fr_side", "multiopen", "pairing"],
       "rlc": ["transcript", "decompress", "subgroup", "fr_side", "multiopen", "rlc_msm", "pairing", "post",
               "recheck", "final"]}


@pytest.fixture
def recorder():
    """The process's recorder, empty and on; off and empty again after."""
    tracing.RECORDER.clear()
    tracing.enable()
    yield tracing.RECORDER
    tracing.disable()
    tracing.RECORDER.clear()


@pytest.fixture
def stand_ins(monkeypatch):
    """Cheap stand-ins for the heavy kernels' plain versions, of their
    output shapes."""
    monkeypatch.setattr(cuda_pairing, "pairing_check",
                        lambda el, er, pair, enable=None: torch.ones(el.shape[0], dtype=torch.bool))
    monkeypatch.setattr(cuda_curve, "msm", lambda pts, sc: pts[:, 0].contiguous())
    monkeypatch.setattr(cuda_curve, "aggregate_subgroup_check",
                        lambda pts, w: torch.ones(pts.shape[0], dtype=torch.bool))
    monkeypatch.setattr(cuda_curve, "decompress_hintless",
                        lambda raw: (torch.zeros((*raw.shape[:2], 3, 25), dtype=torch.int64),
                                     torch.ones(raw.shape[:2], dtype=torch.bool)))


def _setup(name: str):
    plan, proof, bad, pis = load_set(name)
    tv = TorchVerifier(plan, device="cpu")
    tv.msm = cuda_curve.msm  # the stand-in (the verifier binds its MSM when built)
    batch = np.stack([np.frombuffer(proof, np.uint8), np.frombuffer(bad, np.uint8)])
    return tv, batch, tv.encode_public_inputs([pis] * B)


def _call(tv, entry, batch, pis):
    gen = torch.Generator().manual_seed(5)
    if entry == "verify":
        return tv.verify(batch, pis, tv.compute_y_hints(batch), gen)
    return tv.verify_rlc_device(batch, pis, tv.rlc_weights(B, gen), None, group=1, generator=gen)


def test_off_records_nothing(stand_ins):
    tracing.RECORDER.clear()
    assert not tracing.enabled()
    tv, batch, pis = _setup("simple_mul")
    _call(tv, "verify", batch, pis)
    assert tracing.calls() == [] and tracing.active_stages() is None


class _FakeProgram:
    """models/programs.Program's interface, without a card."""

    def __init__(self, verifier, body, args, traced=False):
        self.traced, self.nodes, self.msm_term_counts = traced, {"kernel": 3}, [4, 38]

    def take_first(self):
        return "first"

    def replay(self, args, call=None):
        return ("replay", call)


def test_tracing_at_capture_is_part_of_the_key(monkeypatch):
    """Off, a program's key is the verifier's key as it was; a traced call
    runs a program of its own key, captured traced, and records its
    capture."""
    monkeypatch.setattr(programs, "Program", _FakeProgram)
    progs = programs.Programs(SimpleNamespace(device=-1))  # torch.cuda.device(-1): no card touched
    key = ("verify", 8, "aggregate", 1, True, "cuda")
    assert progs.run(key, None, ()) == "first"
    assert list(progs.cache) == [key] and not progs.cache[key].traced
    assert progs.run(key, None, ()) == ("replay", None)
    rec = tracing.Recorder(capacity=8)
    with rec.call("verify", torch.device("cpu")) as call:
        assert progs.run(key, None, (), call) == "first"
    assert list(progs.cache) == [key, (*key, "traced")] and progs.cache[(*key, "traced")].traced
    assert call.captured and call.nodes == {"kernel": 3} and call.msm_terms == (4, 38)
    assert [(s.name, s.parent) for s in call.spans] == [("ph2.call", None)]
    with rec.call("verify", torch.device("cpu")) as again:
        assert progs.run(key, None, (), again) == ("replay", again)
    assert (progs.captures, progs.replays) == (2, 2)


def test_spans_share_the_call_and_nest(stand_ins, recorder):
    tv, batch, pis = _setup("simple_mul")
    for entry in ("verify", "rlc", "verify"):
        _call(tv, entry, batch, pis)
    calls = tracing.calls()
    assert [c.id for c in calls] == [0, 1, 2]
    assert [c.entry for c in calls] == ["verify", "verify_rlc_device", "verify"]
    for c in calls:
        assert [(s.name, s.parent) for s in c.spans] == [("ph2.call", None), ("ph2.load", 0)]
        outer, load = c.spans
        assert outer.start <= load.start <= load.end <= outer.end
        d = c.device
        assert outer.start <= d["call_start"] <= d["graph_start"] <= d["graph_end"] <= d["call_end"] <= outer.end
        assert c.stages and all(outer.start <= s.start <= s.end <= outer.end for s in c.stages)
    assert calls[0].spans[0].end <= calls[1].spans[0].start


@pytest.mark.parametrize("entry", ["verify", "rlc"])
@pytest.mark.parametrize("name", ["simple_mul", "simple_mul_gwc19"], ids=["halo2", "gwc19"])
def test_eager_stages_tile_the_body(stand_ins, recorder, name, entry):
    tv, batch, pis = _setup(name)
    _call(tv, entry, batch, pis)
    (c,) = tracing.calls()
    plan = c.plan
    top = [p for p in plan if p[1] is None]
    assert [p[0] for p in top] == TOP[entry]
    assert top[0][2] == 0 and top[-1][3] == max(p[3] for p in plan)
    for a, b in zip(top, top[1:]):
        assert a[3] == b[2]  # a stage's exit is the next one's entry
    children = [(p[0], plan[p[1]][0]) for p in plan if p[1] is not None]
    # GWC19: the two sides' MSMs, the left (the W_i) first as msm_w
    msms = ["msm"] if name == "simple_mul" else ["msm_w", "msm"]
    assert children == [("fr_pow", "fr_side")] + [(m, "multiopen") for m in msms]
    for p in plan:
        if p[1] is not None:
            assert plan[p[1]][2] < p[2] < p[3] < plan[p[1]][3]
    stages = {s.name: s for s in c.stages}
    assert abs(c.top_ms() - c.graph_ms) <= 0.01 * c.graph_ms
    assert stages["transcript"].start >= c.device["graph_start"] and stages["pairing"].end <= c.device["graph_end"]


@pytest.mark.parametrize("name,stages,terms", [
    ("simple_mul", ["transcript", "decompress", "fr_side", "fr_pow", "multiopen", "msm", "pairing"], (16,)),
    ("simple_mul_gwc19", ["transcript", "decompress", "fr_side", "fr_pow", "multiopen", "msm_w", "msm", "pairing"],
     (3, 17)),
], ids=["halo2", "gwc19"])
def test_multiopen_stages_and_term_counts(stand_ins, recorder, name, stages, terms):
    """verify()'s stages in the order they open: the halo2-book flavor's
    as they were, GWC19's with its left MSM as msm_w; the multi-open's
    self time leaves out every MSM child; the call carries the body's
    de-duplicated MSM term counts."""
    tv, batch, pis = _setup(name)
    _call(tv, "verify", batch, pis)
    (c,) = tracing.calls()
    assert [p[0] for p in c.plan] == stages
    msms = sum(c.stage_ms(m) for m in ("msm_w", "msm"))
    assert c.self_ms("multiopen") == pytest.approx(c.stage_ms("multiopen") - msms)
    assert c.msm_terms == tuple(tv.msm_term_counts) == terms


def test_self_time_subtracts_children():
    c = tracing.Call(0, "verify", None, None)
    S = tracing.Stage
    c.stages = [S("fr_side", None, 0.0, 0.010, 10.0), S("fr_pow", 0, 0.002, 0.005, 3.0),
                S("multiopen", None, 0.010, 0.020, 10.0), S("msm", 2, 0.011, 0.013, 2.0),
                S("msm", 2, 0.014, 0.017, 3.0)]
    assert c.self_ms("fr_side") == 7.0 and c.self_ms("multiopen") == 5.0
    assert c.stage_ms("msm") == 5.0 and c.top_ms() == 20.0 and c.self_ms("msm") == 5.0
    c.stages[3].name = "msm_w"  # GWC19's left side: a child all the same
    assert c.self_ms("multiopen") == 5.0 and c.stage_ms("msm_w") == 2.0 and c.stage_ms("msm") == 3.0


def test_stages_nest_and_tile():
    """Stages on a clock of their own: marks in order, a child's pair of
    its own, the next top-level stage starting at the last one's end."""
    marks = []
    st = tracing.Stages(marks.append)
    st.begin()
    st.stage("a", lambda: st.stage("a1", lambda: None))
    st.stage("b", lambda: None)
    st.end()
    assert marks == [0, 1, 2, 3, 4]
    assert st.plan == [["a", None, 0, 3], ["a1", 0, 1, 2], ["b", None, 3, 4]]


def test_ring_counts_what_it_overwrites():
    rec = tracing.Recorder(capacity=4)
    for _ in range(6):
        with rec.call("verify", torch.device("cpu")) as c:
            c.run_eager(lambda: None, lambda: ())
    calls = rec.calls()
    assert rec.overwritten == 2 and [c.id for c in calls] == [2, 3, 4, 5]
    assert all(c.device is not None for c in calls)
    rec.clear()
    assert rec.calls() == [] and rec.overwritten == 0


def test_spans_are_host_ops_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    rec = tracing.Recorder(capacity=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.call("verify", torch.device("cpu")) as c:
            with c.span("ph2.load"):
                torch.ones(3).add_(1)
    names = {e.name: e for e in prof.events() if e.name.startswith("ph2.")}
    assert set(names) == {"ph2.call", "ph2.load"}
    assert not any(e.is_user_annotation for e in names.values())
    with rec.call("verify", torch.device("cpu")) as c:  # no profiler: spans alone
        with c.span("ph2.load"):
            pass
    assert [s.name for s in rec.calls()[1].spans] == ["ph2.call", "ph2.load"]
