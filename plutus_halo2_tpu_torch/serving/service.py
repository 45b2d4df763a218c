"""Batched proof-verification service over TorchVerifier: the port of
``plutus_halo2_tpu/serving/service.py``.

Replaces the reference's submit-and-poll flow against Cardano
(aiken-verifier/submitter/src/{main.rs,api.rs}) with a submit-and-poll flow
against a GPU batch queue:

  submitter: mint tx, redeemer = [proof, i1..i3],   here: submit(ProofBundle)
             NFT name = blake2b256(proof ∥ inputs)        tag = same hash
  on-chain validator gate: NFT name must equal      here: optional expected_tag
             blake2b256(proof ∥ inputs)                   checked per submission
             (validators/verifier.ak:12-31)
  Blockfrost submit_transaction (api.rs:52-73)      here: batch dispatch to
                                                          TorchVerifier
  wait_for_tx 5s polling (api.rs:75-80)             here: Future.result()

Batches are fixed-size; partial batches are padded by repeating the last
bundle. A background thread lingers briefly to coalesce concurrent
submissions."""

from __future__ import annotations

import hashlib
import logging
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from ..models.layout import build_layout
from ..models.verifier_torch import TorchVerifier

log = logging.getLogger(__name__)

_CLOSE = object()  # queue sentinel waking the worker on close()


@dataclass(frozen=True)
class ProofBundle:
    """One verification request: proof bytes + public-input scalars."""

    proof: bytes
    public_inputs: tuple

    @property
    def tag(self) -> bytes:
        """blake2b_256(proof ∥ inputs) — the reference's NFT-name derivation
        (submitter/src/main.rs:96-99), reused as the submission id."""
        h = hashlib.blake2b(digest_size=32)
        h.update(self.proof)
        for v in self.public_inputs:
            h.update(int(v).to_bytes(32, "big"))
        return h.digest()


class VerificationService:
    """Accumulate ProofBundles into fixed-size batches and verify on device.

    Args:
      plan: the CircuitPlan all submissions must target.
      batch_size: the batch every dispatch verifies.
      linger_s: how long to wait for more submissions before dispatching a
        partial (padded) batch.
      device: torch device; None resolves to "cuda" and raises without a GPU
        (pass "cpu" for the plain versions).
      y_hints: compute untrusted decompression hints on the host per dispatch
        (TorchVerifier.compute_y_hints) so the device skips the sqrt ladder;
        the device re-checks every hint.
      rlc_group: opt-in batch-pairing semantics — one random-linear-
        combination pairing check per `rlc_group` proofs instead of one per
        proof (TorchVerifier.verify_rlc). Per-proof verdicts stay exact for
        rejected rows (failing groups are re-checked row by row); acceptance
        carries the standard RLC soundness error <= rlc_group / 2^128. Must
        divide batch_size.
    """

    def __init__(self, plan, batch_size: int = 128, linger_s: float = 0.02,
                 device=None, y_hints: bool = True, rlc_group: int | None = None):
        self.plan = plan
        self.batch_size = int(batch_size)
        self.linger_s = linger_s
        self._verifier = TorchVerifier(plan, device=device)
        self._y_hints = y_hints
        if rlc_group is not None and (rlc_group < 1 or self.batch_size % rlc_group):
            raise ValueError(f"rlc_group {rlc_group} must divide batch_size {self.batch_size}")
        self._rlc_group = rlc_group
        self._proof_len = build_layout(plan).proof_len
        self._n_pi = plan.vk.num_public_inputs
        self._q: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self.dispatches = 0
        self.verified = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, bundle: ProofBundle, expected_tag: bytes | None = None) -> Future:
        """Enqueue a bundle; the Future resolves to (tag, accepted: bool).

        Malformed bundles (wrong proof length / public-input arity) are
        rejected here so one bad submission cannot poison a whole batch.

        expected_tag is the analog of the on-chain validator's NFT-name gate
        (validators/verifier.ak:12-31): when supplied, the bundle is accepted
        only if blake2b256(proof ∥ inputs) matches — a mismatch resolves to
        (tag, False) without touching the device."""
        if self._closed.is_set():
            raise RuntimeError("service closed")
        fut: Future = Future()
        if len(bundle.proof) != self._proof_len:
            fut.set_exception(ValueError(
                f"proof length {len(bundle.proof)} != expected {self._proof_len}"))
            return fut
        if len(bundle.public_inputs) != self._n_pi:
            fut.set_exception(ValueError(
                f"{len(bundle.public_inputs)} public inputs != expected {self._n_pi}"))
            return fut
        if expected_tag is not None and bundle.tag != expected_tag:
            fut.set_result((bundle.tag, False))
            return fut
        self._q.put((bundle, fut))
        if self._closed.is_set():
            # close() may have raced past the earlier check; make sure the
            # worker wakes up to drain this item before exiting.
            self._q.put(_CLOSE)
        return fut

    def close(self):
        """Drain the queue and stop the worker."""
        self._closed.set()
        self._q.put(_CLOSE)
        self._worker.join()

    # -- worker ---------------------------------------------------------

    def _take_batch(self):
        items = []
        got = self._q.get()  # blocks; close() wakes us with the sentinel
        if got is _CLOSE:
            return items
        items.append(got)
        deadline = threading.Event()
        # linger: give concurrent submitters a chance to fill the batch
        t = threading.Timer(self.linger_s, deadline.set)
        t.start()
        while len(items) < self.batch_size and not deadline.is_set():
            try:
                got = self._q.get(timeout=self.linger_s / 4 or 0.005)
                if got is _CLOSE:
                    break
                items.append(got)
            except queue.Empty:
                pass
        t.cancel()
        return items

    @staticmethod
    def _resolve(fut: Future, *, result=None, exc=None):
        """Resolve a future, tolerating client-side cancellation — a cancelled
        Future must never kill the worker thread (set_result raises
        InvalidStateError on it)."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:  # noqa: BLE001 — cancelled/already-resolved future
            pass

    def _dispatch(self, items):
        bundles = [b for b, _ in items]
        padded = bundles + [bundles[-1]] * (self.batch_size - len(bundles))
        v = self._verifier
        try:
            proofs = np.stack([np.frombuffer(b.proof, dtype=np.uint8) for b in padded])
            pis = v.encode_public_inputs([list(b.public_inputs) for b in padded])
            hints = v.compute_y_hints(proofs) if self._y_hints else None
            proofs_d = torch.as_tensor(proofs, device=v.device)
            pis_d = torch.as_tensor(pis, device=v.device)
            if self._rlc_group is not None:
                out = v.verify_rlc(proofs_d, pis_d, hints, group=self._rlc_group)
            else:
                out = v.verify(proofs_d, pis_d, hints).cpu().numpy()
        except Exception as exc:  # resolve futures rather than hang clients
            log.exception("verification dispatch failed")
            for _, fut in items:
                self._resolve(fut, exc=exc)
            return
        self.dispatches += 1
        self.verified += len(bundles)
        for (bundle, fut), verdict in zip(items, out[: len(bundles)]):
            self._resolve(fut, result=(bundle.tag, bool(verdict)))

    def _run(self):
        try:
            while not (self._closed.is_set() and self._q.empty()):
                items = self._take_batch()
                if not items:
                    continue
                self._dispatch(items)
        finally:
            # worker exiting (close() or a fatal error): fail anything left
            # in the queue so no client blocks forever on an orphaned Future.
            while True:
                try:
                    got = self._q.get_nowait()
                except queue.Empty:
                    break
                if got is _CLOSE:
                    continue
                _, fut = got
                self._resolve(fut, exc=RuntimeError("service worker exited"))
