"""The ``verify_rlc_device`` entry: ``TorchVerifier.verify_rlc_device()``
at the mix's RLC group (one pairing check a group on weighted aggregates,
the rows of failing groups re-checked on the device), then
``rlc_finalize()`` on the verdicts and the suspect count, copied to the
host behind the call (``program.Readback``); it re-checks on the host when
more rows failed than the device re-checks."""

from __future__ import annotations

import numpy as np

from portbench.program import Readback


class Entry:
    def __init__(self, verifier, traffic: dict, generator):
        self.verifier = verifier
        self.group = int(traffic["rlc_group"])
        self.generator = generator  # the aggregate subgroup test's weights, drawn in each call

    def issue(self, batch):
        out = self.verifier.verify_rlc_device(batch.proofs, batch.pis, batch.rlc_weights, batch.hints,
                                              group=self.group, generator=self.generator)
        return Readback(out[:2]), out[2:]

    def finish(self, issued):
        readback, rest = issued
        verdicts = self.verifier.rlc_finalize(*readback.wait(), *rest)
        return np.array(verdicts, copy=True)  # a copy: the pinned buffer goes back to its cache
