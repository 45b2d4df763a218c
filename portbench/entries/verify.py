"""The ``verify`` entry: ``TorchVerifier.verify()`` on a batch, one
pairing check a proof; the verdict vector is copied to the host behind the
call (``program.Readback``) and comes back as numpy."""

from __future__ import annotations

from portbench.program import Readback


class Entry:
    def __init__(self, verifier, traffic: dict, generator):
        self.verifier = verifier
        self.generator = generator  # the aggregate subgroup test's weights, drawn in each call

    def issue(self, batch):
        out = self.verifier.verify(batch.proofs, batch.pis, batch.hints, generator=self.generator)
        return Readback([out])

    def finish(self, readback):
        return readback.wait()[0].numpy().copy()  # a copy: the pinned buffer goes back to its cache
