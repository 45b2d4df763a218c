"""The control of ``correct``: the reference put in the port's place with
one stated guarantee broken, judged by the run's own comparison
(``check.py``) on a cell's own traffic, at its own batch size.

The configurations state one guarantee: an exact verdict per proof. The
control breaks it as a tempting shortcut would: group verdicts without the
exact re-check, as an RLC verifier that skipped it gives them. A row is
accepted when it decodes and no row of its group of ``GROUP`` (the RLC
group of the cells) fails its pairing equation; a row rejected while
decoding carries no weight, so it fails no group. Honest rows that share a
group with a failing one come out rejected.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--batches 200]

Prints one JSON line per seed: the compared numbers and ``correct``. The
benchmark's own runs never run it; it needs no card."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import check, spec, traffic
from .reference.verifier import DECODE, EQUATION
from .reference.verifier import verify as reference_verify

GROUP = 8  # proofs a group verdict


class Record:
    def __init__(self, layout: int, verdicts):
        self.layout, self.verdicts = layout, verdicts


def group_verdicts(rows, outcomes) -> np.ndarray:
    """The control's verdict vector of one batch."""
    stage = [outcomes[int(r)].stage for r in rows]
    out = np.array([s != DECODE for s in stage])
    for g in range(0, len(rows), GROUP):
        if EQUATION in stage[g: g + GROUP]:
            out[g: g + GROUP] = False
    return out


def readings(cell, seed: int, batches: int) -> dict:
    """The control's numbers over `batches` calls cycling the cell's
    layouts of `seed`, with the reference's verdicts expected."""
    gen = traffic.generate(cell.config, cell.circuit(), cell.traffic, seed, cell.artifacts)
    outcomes = [reference_verify(gen.plan, p, gen.public_inputs) for p in gen.distinct]
    records = [Record(i % len(gen.layouts), group_verdicts(gen.layouts[i % len(gen.layouts)].rows, outcomes))
               for i in range(batches)]
    numbers = check.compare(records, check.expected_verdicts(gen.layouts, outcomes))
    correct, checks = check.judged(numbers)
    return {"workload": cell.name, "seed": seed, "batches": batches, "group": GROUP, "correct": correct,
            "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control of correct, on a cell's traffic")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--batches", type=int, default=200)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload, False)
    for s in args.seeds.split(","):
        print(json.dumps(readings(cell, int(s), args.batches)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
