"""The port's own trace as the benchmark reads it (``spans.py`` and the
metrics that import it), on a made-up recorder and run: the harness's
calls paired with the port's, each reader's value, the notes, a port
without the recorder giving nothing, and ``spec.cell`` turning the port's
tracing on for a traced run's metrics only. The port's tracing state is
restored after each test."""

import importlib
import sys
from types import SimpleNamespace

import pytest

import portbench
from plutus_halo2_tpu_torch.utils import tracing
from portbench import spec
from portbench.run import Context, Record

CELL = "atms_with_lookups_50_90.exact.b64"
STEP = 0.060  # s between the calls' starts
NEW = ("host.launch_ms", "program.queue_ms", "program.kernel_nodes", "program.device_ms", "program.gap_share",
       "glue.fr_side_ms", "glue.multiopen_ms")


def _forget_spans():
    """The next import of portbench.spans runs it again."""
    sys.modules.pop("portbench.spans", None)
    if hasattr(portbench, "spans"):
        del portbench.spans


@pytest.fixture
def spans():
    """portbench.spans imported afresh (which turns the port's tracing on);
    the tracing state as it was, and the module forgotten, after the test."""
    was = tracing.enabled()
    _forget_spans()
    mod = importlib.import_module("portbench.spans")
    yield mod
    _forget_spans()
    (tracing.enable if was else tracing.disable)()


def _call(cid, t, captured=False):
    c = tracing.Call(cid, "verify", None, None)
    c.spans = [tracing.Span("ph2.call", t, None), tracing.Span("ph2.load", t + 0.0001, 0),
               tracing.Span("ph2.launch", t + 0.0006, 0)]
    c.spans[0].end, c.spans[1].end, c.spans[2].end = t + 0.002, t + 0.0005, t + 0.0010
    c.nodes = {"kernel": 33930}
    if captured:
        c.captured = True
        return c
    g0 = t + 0.0007
    c.device = {"call_start": t + 0.0002, "graph_start": g0, "graph_end": g0 + 0.050, "call_end": g0 + 0.0501}
    c.graph_ms = 50.0
    S = tracing.Stage
    c.stages = [S("transcript", None, g0, g0 + 0.005, 5.0), S("fr_side", None, g0 + 0.005, g0 + 0.025, 20.0),
                S("fr_pow", 1, g0 + 0.006, g0 + 0.007, 1.0), S("multiopen", None, g0 + 0.025, g0 + 0.040, 15.0),
                S("msm", 3, g0 + 0.030, g0 + 0.033, 3.0), S("pairing", None, g0 + 0.040, g0 + 0.050, 10.0)]
    return c


def _run(calls_before=3):
    """A capture in the warm-up, then window calls STEP apart, in flight 1;
    the traced sub-window starts after `calls_before` of them."""
    port = [_call(0, 9.0, captured=True)] + [_call(i + 1, 10 + STEP * i) for i in range(5)]
    records = [Record(0, 9.0 - 1e-4, 9.5, 9.6, warmup=True)]
    for c in port[1:]:
        t = c.spans[0].start
        records.append(Record(0, t - 1e-4, t + 0.003, c.device["call_end"] + 0.001))
    records[2].t_done += 0.010  # one slow call
    ctx = Context(64, 1.0, 1.0, 11.0, records, t_trace=10 + STEP * calls_before - 0.001)
    rec = SimpleNamespace(calls=lambda: port, overwritten=0,
                          clock=lambda: {0: {"references": 2, "uncertainty_s": 9e-6, "drift": 2e-6}})
    return ctx, rec


def test_pairs_the_harness_calls_with_the_ports(spans, monkeypatch):
    ctx, rec = _run()
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    pairs = spans.window(ctx)
    assert [c.id for _r, c in pairs] == [1, 2, 3]
    assert all(r.t_issue <= c.spans[0].start <= r.t_issued for r, c in pairs)


def test_readers(spans, monkeypatch):
    ctx, rec = _run()
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    got = {n: spec.metric_module(n).read(ctx) for n in NEW}
    gap = STEP - 0.0506  # call_end(n) = t + 0.0508 to call_start(n + 1) = t + STEP + 0.0002
    want = {"host.launch_ms": 0.4, "program.queue_ms": 0.7, "program.kernel_nodes": 33930,
            "program.device_ms": 50.0, "program.gap_share": 100 * 2 * gap / (2 * STEP + 0.0506),
            "glue.fr_side_ms": 19.0, "glue.multiopen_ms": 12.0}
    assert got == pytest.approx(want)
    notes = "\n".join(ctx.notes)
    assert "[spans] speeds: slow" in notes and "1 calls, calls 1-1" in notes and "2 calls, calls 0-2" in notes
    assert "2 gaps" in notes and "harness 2 gaps" in notes
    assert ("0 call_start before their ph2.call, 0 call_end after the harness's verdicts, of 3 calls" in notes
            and "0 records overwritten; 0 captures after the warm-up" in notes and "at most 0.000 %" in notes)


def test_queue_leaves_out_the_wait_behind_the_graph_ahead(spans, monkeypatch):
    """Two in flight: a call's graph starts when the one ahead of it ends,
    and only the time after that end (or after its own start, if later)
    is the port's own queue."""
    ctx, rec = _run()
    port = rec.calls()
    nxt = port[2]
    ahead_end = nxt.spans[0].start + 0.030  # the graph ahead ends 30 ms into this call
    port[1].device["graph_end"] = ahead_end
    nxt.device["graph_start"] = ahead_end + 0.0004
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    assert spans.queue_ms(ctx, nxt) == pytest.approx(0.4)
    assert spans.queue_ms(ctx, port[3]) == pytest.approx(0.7)  # the graph ahead ended before this call began
    assert spans.queue_ms(ctx, port[1]) == pytest.approx(0.7)  # the call before it is the warm-up's capture


def test_health_counts_what_breaks(spans, monkeypatch):
    ctx, rec = _run()
    port = rec.calls()
    port[2].device["call_start"] = port[2].spans[0].start - 0.001  # before its call began
    port[3].stages[-1].ms = 11.0  # the stages no longer add up to the graph's span
    port.append(_call(9, 10.5, captured=True))  # a capture inside the window
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    spec.metric_module("program.device_ms").read(ctx)
    notes = "\n".join(ctx.notes)
    assert "1 call_start before their ph2.call" in notes and "at most 2.000 %" in notes
    assert "1 captures after the warm-up" in notes


def test_nothing_without_the_recorder(spans, monkeypatch):
    ctx, _rec = _run()
    monkeypatch.setattr(spans, "recorder", lambda: None)
    assert all(spec.metric_module(n).read(ctx) is None for n in NEW) and not ctx.notes
    ctx, rec = _run()
    ctx.t_trace = None  # an untraced run
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    assert all(spec.metric_module(n).read(ctx) is None for n in NEW)


def test_a_traced_cell_turns_the_ports_tracing_on(spans):
    _forget_spans()
    tracing.disable()
    cell = spec.cell(CELL, False)
    assert not tracing.enabled() and "portbench.spans" not in sys.modules
    assert {m["name"] for m, _mod in cell.metrics} == {"proofs_per_s", "batch_p95_ms", "setup_s"}
    cell = spec.cell(CELL, True)
    assert tracing.enabled()
    assert set(NEW) <= {m["name"] for m, _mod in cell.metrics}
