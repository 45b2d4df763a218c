"""What decides ``correct``: every verdict vector the run's calls returned,
window and drain alike, against the plain reference's verdicts on the same
rows (``reference/verifier.py``, run once on each distinct input after the
window).

Numbers compared, each with its limit: ``wrong_verdicts`` (proofs whose
verdict differs from the reference's; a vector of the wrong shape counts
every row) at most 0, ``unanswered`` (proofs of calls that returned no
verdicts) at most 0, ``batches_checked`` at least 1. An exact comparison:
its limits are 0."""

from __future__ import annotations

import numpy as np

LIMITS = {"wrong_verdicts": ("max", 0), "unanswered": ("max", 0), "batches_checked": ("min", 1)}


def expected_verdicts(layouts, outcomes) -> list[np.ndarray]:
    """The reference's verdict vector of each layout."""
    accepted = np.array([o.accepted for o in outcomes])
    return [accepted[np.asarray(lay.rows)] for lay in layouts]


def compare(records, expected) -> dict:
    """{name: number} over the run's batch records (each with `layout` and
    `verdicts`, None where a call returned none)."""
    wrong = unanswered = checked = 0
    for rec in records:
        want = expected[rec.layout]
        if rec.verdicts is None:
            unanswered += len(want)
            continue
        got = np.asarray(rec.verdicts).reshape(-1)
        checked += 1
        if got.shape != want.shape:
            wrong += len(want)
        else:
            wrong += int((got.astype(bool) != want).sum())
    return {"wrong_verdicts": wrong, "unanswered": unanswered, "batches_checked": checked}


def judged(numbers: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": n, "max" | "min": limit}})."""
    out, ok = {}, True
    for name, (rule, limit) in LIMITS.items():
        v = numbers[name]
        out[name] = {"value": v, rule: limit}
        ok &= v <= limit if rule == "max" else v >= limit
    return ok, out
