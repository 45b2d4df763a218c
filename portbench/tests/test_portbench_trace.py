"""The traced sub-window's reading, on a made-up profiler record: only what
lies between the markers counts, the harness's host spans and their
mirrors on the device's timeline are not device activity, a sub-window
that lost a marker or holds a kernel count that is not whole is refused,
and the metrics read the rest as stated."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import spec, trace
from portbench.run import Context


def _ev(name, start, dur, device=True):
    return SimpleNamespace(name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           time_range=SimpleNamespace(start=start, elapsed_us=lambda d=dur: d))


def _prof(events):
    return SimpleNamespace(events=lambda: events)


def _shot(marks=True, extra_kernel=False):
    ev = [_ev("void fill_kernel", 0, 5)]
    if marks:
        ev.append(_ev("spin_kernel", 10, 10))
    ev += [_ev("portbench.issue", 21, 8, device=False), _ev("portbench.issue", 21, 100),
           _ev("void pairing_kernel<32>(long const*)", 30, 10), _ev("void at::native::add_kernel", 40, 5),
           _ev("void at::native::add_kernel", 42, 5), _ev("void at::native::sub_kernel", 50, 3), _ev("Memcpy HtoD (Pinned -> Device)", 25, 2),
           _ev("void msm_kernel<5>(long const*)", 60, 10), _ev("void at::native::mul_kernel", 75, 5)]
    if extra_kernel:
        ev.append(_ev("void at::native::odd_kernel", 85, 1))
    ev += [_ev("spin_kernel", 100, 10), _ev("void fill_kernel", 115, 5)]
    return _prof(ev), [3, 4], 1


def test_reads_between_the_markers():
    tr = trace.read(_shot())
    assert (tr.start, tr.end, tr.batches, tr.layouts) == (20, 100, 2, [3, 4])
    assert len(tr.kernels) == 6 and len(tr.device) == 7
    assert tr.host == [("portbench.issue", 21.0, 8.0)]
    assert trace.busy_us(tr.device) == 2 + 10 + 7 + 3 + 10 + 5
    gaps = trace.idle_gaps(tr)
    assert gaps[0] == (20, 25) and gaps[-1] == (80, 100)
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0].startswith("void pairing_kernel") and b["idle_gaps"][0] == ["host: between calls", 20e-6]
    assert ["portbench.issue", 3e-6] in b["idle_gaps"]


@pytest.mark.parametrize("shot", [_shot(marks=False), _shot(extra_kernel=True)], ids=["lost_marker", "not_whole"])
def test_refuses_a_broken_sub_window(shot):
    assert trace.read(shot) is None


def test_metrics_read_the_trace():
    from portbench.roofline import INT32_OPS_PER_S as OPS, Work

    tr = trace.read(_shot())
    ctx = Context(8, 1.0, 1.0, 1.0, [], tr)
    ctx.work = {3: {"pairing": Work(OPS * 5e-6, 0), "msm": Work(0, 0)},
                4: {"pairing": Work(OPS * 5e-6, 0), "msm": Work(OPS * 1e-6, 0)}}
    read = {n: spec.metric_module(n).read(ctx) for n in
            ("glue.device_ms", "glue.kernels_per_batch", "kernels.pairing_roofline", "kernels.msm_roofline")}
    assert read["glue.device_ms"] == pytest.approx((7 + 3 + 5) / 1e3 / 2)
    assert read["glue.kernels_per_batch"] == 2
    assert read["kernels.pairing_roofline"] == pytest.approx(100.0)
    assert read["kernels.msm_roofline"] == pytest.approx(10.0)
