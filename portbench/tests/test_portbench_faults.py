"""`correct` comes out false when the timed path is broken underneath, and
the control fails the comparison at a cell's own size.

The faults drive a whole run on the CPU (the port's plain versions, which
the chip's look is skipped for), at a batch of 8 that a test run can hold:
once sound, once with a verdict altered where it is produced, once with
half of every batch left out (its rows replaced by the other half's). A
step that returns its state unchanged and an exchange between chips left
out are not faults this system can have: it keeps no state across calls and
runs on one chip."""

import numpy as np
import pytest

from portbench import control, run, spec

CELL = "simple_mul.rlc8.b1024"
SEED = 2**31 + 4242


def _run(wrap=None):
    cell = spec.cell(CELL, False)
    cell.traffic.update(batch=8, layouts=2, invalid_per_batch=2, in_flight=1)
    return run.run_cell(cell, SEED, 0.5, False, device="cpu", wrap_entry=wrap, log=lambda *a, **k: None)


class _Altered:
    """A verdict flipped where it is produced: row 0 of every batch."""

    def __init__(self, entry):
        self.entry = entry

    def issue(self, batch):
        return self.entry.issue(batch)

    def finish(self, out):
        v = np.array(self.entry.finish(out), copy=True)
        v[0] = ~v[0]
        return v


class _HalfLeftOut:
    """Half of every batch left out: its second half's rows replaced by the
    first half's, so they are never verified."""

    def __init__(self, entry):
        self.entry = entry

    def issue(self, batch):
        import dataclasses

        def half(t):
            if t is None:
                return None
            t = t.clone()
            t[t.shape[0] // 2:] = t[: t.shape[0] - t.shape[0] // 2]
            return t

        return self.entry.issue(dataclasses.replace(batch, proofs=half(batch.proofs), hints=half(batch.hints)))

    def finish(self, out):
        return self.entry.finish(out)


@pytest.mark.parametrize("fault", [None, _Altered, _HalfLeftOut], ids=["sound", "altered", "half_left_out"])
def test_fault_turns_correct_false(monkeypatch, fault):
    monkeypatch.setattr(run, "WARMUP_ROUNDS", 1)
    res = _run(fault)
    assert res["checks"]["batches_checked"]["value"] >= 2
    assert res["correct"] is (fault is None)
    assert (res["checks"]["wrong_verdicts"]["value"] > 0) is (fault is not None)


@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(name):
    got = control.readings(spec.cell(name, False), SEED, batches=32)
    assert not got["correct"] and got["checks"]["wrong_verdicts"]["value"] > 0
