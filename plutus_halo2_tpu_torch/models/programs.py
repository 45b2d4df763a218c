"""Captured programs: the counterpart of the JAX package's compiled verify
programs (``plutus_halo2_tpu/models/verifier_jax.py``'s ``_prog``, one
``jax.jit`` per stage and static key, every dispatch asynchronous).

On the card each of ``TorchVerifier.verify()`` and ``verify_rlc_device()``
runs as one CUDA graph per key (the entry point, B, the subgroup mode and
its rounds, hinted or hintless, the RLC group and re-check width, the
device). The JAX package splits its programs only so that the Mosaic
payloads are compiled once and shared between call sites; a graph has
nothing to share, so the port captures one program per entry point.

The first call of a key copies its inputs into static buffers on the
device, runs the body once eagerly on a side stream (the warm-up: it fills
every per-device cache the kernel wrappers keep, and its outputs are that
call's result), then captures the body over the same buffers with
``torch.cuda.graph``. Every later call copies its inputs into the static
buffers (an input from the host through a pinned staging buffer, without
blocking), replays the graph and returns clones of the static outputs, which
the next replay overwrites: callers may issue calls back to back before they
read one.

The kernel wrappers count their launches in Python, which a replay does not
run: a program keeps what its capture counted, takes it back (a capture
launches nothing) and adds it on every replay, and it restores the
verifier's ``msm_term_counts`` likewise. Each graph keeps a private memory
pool (``pool_bytes``: ``torch.cuda.memory_reserved`` before and after its
capture; 0.27-1.5 GiB a key at B = 1024 on an H100, a dozen keys under
6 GiB, PERF.md), for as long as its verifier lives. A capture or a replay
that fails raises: there is no eager fallback.

At capture a program counts its graph's nodes by type (``nodes``: kernel,
memcpy, memset, event and other nodes), the in-program count of the
kernels a replay runs, and keeps the de-duplicated K of each of the body's
MSM calls (``msm_term_counts``: the multi-open's, one a side under GWC19,
then the RLC aggregation's); a traced call carries both. While tracing is
on (``utils/tracing.py``) a key is captured apart from its untraced twin,
with an event-record node at each stage boundary, and each replay is a
traced call: its spans, its device events before the staging and after
the clones, and the stage nodes re-pointed to its own events
(``Program.replay``)."""

from __future__ import annotations

import ctypes
import gc

import torch

from ..ops import _build, cuda_blake, cuda_curve, cuda_field, cuda_fr, cuda_pairing
from ..utils import tracing

# the kernel wrappers a program body can launch, whose `launches` a replay adds to
COUNTED = (cuda_blake.transcript_hashes, cuda_field.fr_pow, cuda_curve.msm, cuda_curve.decompress_hinted,
           cuda_curve.decompress_hintless, cuda_curve.aggregate_subgroup_check, cuda_pairing.pairing_check,
           cuda_fr.mul, cuda_fr.add, cuda_fr.sub, cuda_fr.sum_lazy, cuda_fr.dot_lazy)


def _counts() -> list[int]:
    return [f.launches for f in COUNTED]


def _map(fn, out):
    return tuple(fn(o) for o in out) if isinstance(out, tuple) else fn(out)


NODE_TYPES = ("kernel", "memcpy", "memset", "event", "other")


def census(raw_graph: int, max_events: int):
    """A captured graph's nodes counted by NODE_TYPES, and its first
    max_events event-record nodes with the events they record (handles)."""
    counts = (ctypes.c_longlong * len(NODE_TYPES))()
    nodes, events = (ctypes.c_void_p * max(max_events, 1))(), (ctypes.c_void_p * max(max_events, 1))()
    found = ctypes.c_int()
    _build.check(_build.library().ph2_graph_census(
        raw_graph, ctypes.addressof(counts), ctypes.addressof(nodes), ctypes.addressof(events), max_events,
        ctypes.addressof(found)), "ph2_graph_census")
    n = min(found.value, max_events)
    return dict(zip(NODE_TYPES, counts)), list(nodes[:n]), list(events[:n])


class _Input:
    """One static input buffer on the device, and the pinned host buffer
    that inputs from the host pass through."""

    def __init__(self, like: torch.Tensor, device: torch.device):
        self.static = torch.empty(like.shape, dtype=like.dtype, device=device)
        self.staging = None
        self.copied = None  # recorded after the staging buffer's last copy to the device

    def load(self, src: torch.Tensor):
        if src.shape != self.static.shape:
            raise ValueError(f"a program's input is {tuple(self.static.shape)}, got {tuple(src.shape)}")
        if src.device.type == "cuda":
            self.static.copy_(src, non_blocking=True)
            return
        if self.staging is None:
            self.staging = torch.empty(self.static.shape, dtype=self.static.dtype, pin_memory=True)
            self.copied = torch.cuda.Event()
        else:
            self.copied.synchronize()  # the previous call's copy has left the staging buffer
        self.staging.copy_(src)
        self.static.copy_(self.staging, non_blocking=True)
        self.copied.record()


class Program:
    """One entry point's body captured at one key, with its static inputs
    and outputs, the launches of one run and its graph's node census;
    `traced`: its stage boundaries are event-record nodes (`stage_plan`,
    `mark_nodes` in mark order)."""

    def __init__(self, verifier, body, args, traced: bool = False):
        dev = verifier.device
        self.verifier = verifier
        self.inputs = [None if a is None else _Input(a, dev) for a in args]
        self._load(args)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = body(*self._statics())
        main.wait_stream(side)
        _map(lambda t: t.record_stream(main), first)
        self.first = first

        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = _counts()
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for the census and the stage nodes
        stages = tracing.CaptureStages() if traced else None
        # no cyclic collection inside the capture: one that frees an
        # unreachable verifier destroys its graphs, which the capturing
        # thread may not do (the capture fails); it runs after instead
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.out = body(*self._statics()) if stages is None else stages.run(body, *self._statics())
        finally:
            if gc_on:
                gc.enable()
        self.nodes, marks, handles = census(self.graph.raw_cuda_graph(), 0 if stages is None else 2 * stages.count)
        self.stage_plan = None if stages is None else [tuple(p) for p in stages.plan]
        if stages is not None:
            at = dict(zip(handles, marks))
            missing = [i for i, e in enumerate(stages.events) if e.cuda_event not in at]
            if missing:
                raise RuntimeError(f"the captured graph lacks the event nodes of stage marks {missing}")
            self.mark_nodes = (ctypes.c_void_p * stages.count)(*[at[e.cuda_event] for e in stages.events])
            self._mark_events = stages.events  # the nodes' events until a replay re-points them
        self.graph.instantiate()
        self.exec_ptr = self.graph.raw_cuda_graph_exec()
        if stages is not None:
            tracing.RECORDER.prepare(dev, tracing.MARKS + stages.count)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = [a - b for a, b in zip(_counts(), before)]
        self._count(-1)  # the capture launched nothing
        self.msm_term_counts = list(verifier.msm_term_counts)

    def _statics(self):
        return [None if i is None else i.static for i in self.inputs]

    def _load(self, args):
        for i, a in zip(self.inputs, args):
            if (i is None) != (a is None):
                raise ValueError("a program's optional input was given where it was captured without, "
                                 "or left out where it was captured with")
            if i is not None:
                i.load(a)

    def _count(self, sign: int):
        for f, n in zip(COUNTED, self.launches):
            f.launches += sign * n

    def take_first(self):
        """The warm-up's outputs, once (the first call's result)."""
        out, self.first = self.first, None
        return out

    def replay(self, args, call=None):
        """One run over args; `call` (tracing.Call) records it, a traced
        program's call only. Before a traced replay the graph's stage nodes
        are re-pointed to the call's events (a host-only update of the
        instantiated graph; replays already queued keep theirs)."""
        if call is None:
            self._load(args)
            self.graph.replay()
        else:
            with call.span("ph2.load"):
                call.event(tracing.CALL_START)
                self._load(args)
            call.plan, call.nodes, call.msm_terms = self.stage_plan, self.nodes, tuple(self.msm_term_counts)
            n = len(self.mark_nodes)
            _build.check(_build.library().ph2_graph_set_events(self.exec_ptr, ctypes.addressof(self.mark_nodes),
                                                               call.marks(n), n), "ph2_graph_set_events")
            with call.span("ph2.launch"):
                self.graph.replay()
        self._count(1)
        self.verifier.msm_term_counts = list(self.msm_term_counts)
        out = _map(torch.clone, self.out)
        if call is not None:
            call.event(tracing.CALL_END)
        return out


class Programs:
    """A verifier's programs by key; `captures` and `replays` count the
    calls of each kind."""

    def __init__(self, verifier):
        self.verifier = verifier
        self.cache: dict = {}
        self.captures = 0
        self.replays = 0

    def run(self, key: tuple, body, args, call=None):
        """body(*args' static buffers) through the program of `key`: captured
        on the key's first call (whose result is the warm-up's), replayed on
        every later one. A traced call (`call`, a tracing.Call) runs the
        key's traced program, a key of its own."""
        if call is not None:
            key = (*key, "traced")
        with torch.cuda.device(self.verifier.device):
            prog = self.cache.get(key)
            if prog is None:
                prog = self.cache[key] = Program(self.verifier, body, args, traced=call is not None)
                if call is not None:
                    call.captured, call.nodes, call.msm_terms = True, prog.nodes, tuple(prog.msm_term_counts)
                self.captures += 1
                return prog.take_first()
            out = prog.replay(args, call)
            self.replays += 1
            return out

    def pool_bytes(self) -> dict:
        """Each kept program's pool bytes, by key."""
        return {k: p.pool_bytes for k, p in self.cache.items()}
