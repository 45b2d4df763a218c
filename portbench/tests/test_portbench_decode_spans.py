"""``decode.device_ms`` on a made-up recorder and run: the ``decompress``
stage plus the ``subgroup`` stage where a call has one, the ``decompress``
stage alone where it has none (the hinted paths fuse the subgroup test),
nothing without the recorder, and every cell reading it."""

import pytest

from plutus_halo2_tpu_torch.utils import tracing
from portbench import spec
from portbench.tests.test_portbench_spans import _run as _book_run
from portbench.tests.test_portbench_spans import spans  # noqa: F401  (the fixture)

NAME = "decode.device_ms"


def _run(subgroup=True):
    """The halo2-book test's run, each replayed call i with a decompress
    stage of 1 + i / 10 ms and, if `subgroup`, a subgroup stage of 0.5 ms."""
    ctx, rec = _book_run()
    S = tracing.Stage
    for i, c in enumerate(rec.calls()):
        if c.device is None:
            continue
        g0 = c.device["graph_start"]
        decode = [S("decompress", None, g0 + 0.0050, g0 + 0.0060, 1.0 + i / 10)]
        if subgroup:
            decode.append(S("subgroup", None, g0 + 0.0060, g0 + 0.0065, 0.5))
        c.stages[1:1] = decode
        for s in c.stages:
            if s.parent is not None:
                s.parent += len(decode)
    return ctx, rec


@pytest.mark.parametrize("subgroup, want", [(True, 1.7), (False, 1.2)])
def test_reads_the_decode_stages(spans, monkeypatch, subgroup, want):
    ctx, rec = _run(subgroup)
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    assert spec.metric_module(NAME).read(ctx) == pytest.approx(want)  # calls 1-3: 1.1, 1.2, 1.3 ms
    # the other stage readers keep their values
    assert spec.metric_module("glue.fr_side_ms").read(ctx) == pytest.approx(19.0)
    assert spec.metric_module("glue.multiopen_ms").read(ctx) == pytest.approx(12.0)


def test_nothing_without_the_stage_or_the_recorder(spans, monkeypatch):
    ctx, rec = _book_run()  # calls with no decompress stage
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    assert spec.metric_module(NAME).read(ctx) is None
    ctx, _rec = _run()
    monkeypatch.setattr(spans, "recorder", lambda: None)
    assert spec.metric_module(NAME).read(ctx) is None


def test_every_cell_reads_it(spans):
    for w in spec.benchmark()["workloads"]:
        assert NAME in {m["name"] for m, _mod in spec.cell(w["name"], True).metrics}
