"""The multi-open's per-layer metrics (``multiopen.device_ms``,
``multiopen.msm_w_ms``, ``multiopen.msm_terms``) on a made-up recorder
and run of a GWC19 cell: the whole stage, the left-side MSM stage and the
captured term counts of the window's calls; nothing from a port whose
calls lack the ``msm_w`` stage or the counts; the metrics read in the new
cell's traced run alone."""

from types import SimpleNamespace

import pytest

from plutus_halo2_tpu_torch.utils import tracing
from portbench import spec
from portbench.run import Context, Record
from portbench.tests.test_portbench_spans import _call as _book_call
from portbench.tests.test_portbench_spans import spans  # noqa: F401  (the fixture)

CELL = "atms_with_lookups_50_90_gwc19.exact.b1024"
NEW = ("multiopen.device_ms", "multiopen.msm_w_ms", "multiopen.msm_terms")
STEP = 0.030


def _call(cid, t, i, gwc=True):
    """A replayed call of the halo2-book test's whose stages are a GWC19
    multi-open of 8 + i ms: glue, msm_w 2 ms (GWC19 only) and msm 5 ms."""
    c = _book_call(cid, t)
    c.msm_terms = (4, 38) if gwc else (36,)
    g0, mo = c.device["graph_start"], (8.0 + i) / 1e3
    S = tracing.Stage
    c.stages = [S("fr_side", None, g0, g0 + 0.003, 3.0), S("multiopen", None, g0 + 0.003, g0 + 0.003 + mo, mo * 1e3)]
    if gwc:
        c.stages.append(S("msm_w", 1, g0 + 0.004, g0 + 0.006, 2.0))
    c.stages += [S("msm", 1, g0 + 0.006, g0 + 0.011, 5.0), S("pairing", None, g0 + 0.003 + mo, g0 + 0.050, 9.0)]
    return c


def _run(gwc=True, counts=True):
    port = [_call(i, 10 + STEP * i, i, gwc) for i in range(5)]
    if not counts:
        for c in port:
            del c.msm_terms  # a port whose calls carry no counts
    records = [Record(0, c.spans[0].start - 1e-4, c.spans[0].start + 0.003, c.device["call_end"] + 0.001)
               for c in port]
    ctx = Context(1024, 1.0, 1.0, 11.0, records, t_trace=10 + STEP * 3 - 0.001)
    rec = SimpleNamespace(calls=lambda: port, overwritten=0,
                          clock=lambda: {0: {"references": 2, "uncertainty_s": 9e-6, "drift": 2e-6}})
    return ctx, rec


def test_readers(spans, monkeypatch):
    ctx, rec = _run()
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    got = {n: spec.metric_module(n).read(ctx) for n in NEW}
    assert got == pytest.approx({"multiopen.device_ms": 9.0, "multiopen.msm_w_ms": 2.0, "multiopen.msm_terms": 42})
    # glue.multiopen_ms keeps its meaning: the stage less both MSM children
    assert spec.metric_module("glue.multiopen_ms").read(ctx) == pytest.approx(2.0)
    notes = "\n".join(ctx.notes)
    assert "[spans] stages, median device ms of 3 calls" in notes and "msm_w 2.000 (self 2.000)" in notes


def test_nothing_without_the_stage_or_the_counts(spans, monkeypatch):
    ctx, rec = _run(gwc=False, counts=False)
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    assert spec.metric_module("multiopen.msm_w_ms").read(ctx) is None
    assert spec.metric_module("multiopen.msm_terms").read(ctx) is None
    assert spec.metric_module("multiopen.device_ms").read(ctx) == pytest.approx(9.0)
    ctx, _rec = _run()
    monkeypatch.setattr(spans, "recorder", lambda: None)  # a port without the recorder
    assert all(spec.metric_module(n).read(ctx) is None for n in NEW)


def test_the_new_cell_reads_them(spans):
    names = {m["name"] for m, _mod in spec.cell(CELL, True).metrics}
    assert set(NEW) <= names
    assert {"kernels.msm_roofline", "kernels.pairing_roofline", "glue.device_ms"} <= names
    for other in (w["name"] for w in spec.benchmark()["workloads"] if w["name"] != CELL):
        assert not set(NEW) & {m["name"] for m, _mod in spec.cell(other, True).metrics}
