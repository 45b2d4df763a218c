"""Multi-device verification: batch data-parallel verification, the
point-sharded MSM, two-axis (dp x mp) meshes and multi-process
initialization. The port of ``plutus_halo2_tpu/parallel/mesh.py``.

A mesh is an array of torch devices with axis names (``Mesh``). Devices may
repeat: four entries of ``cuda:0`` are a virtual mesh on one card, the part
the JAX tests' virtual CPU devices play, and ``["cpu"] * n`` is one on the
CPU. Where the JAX package runs one SPMD program on every device (``jit``
with shardings, ``shard_map``), the port runs one verifier per distinct
device: shards on distinct devices run on one host thread each (inside
``torch.cuda.device``, so that every kernel launches on that device's
stream), and shards that share a device run in turn on it, so that no two
threads launch on one device or interleave its stage events.

A mesh built while a ``torch.distributed`` process group is up spans the
processes: its entries are every rank's devices in rank order, each process
runs the shards it owns, and verdicts are all-gathered. An MSM axis whose
entries lie in more than one process gathers its partial sums with
``dist.all_gather`` inside a process subgroup of just those processes
(``Mesh.process_groups``), wherever the group lies and however many entries
each of them owns, as the JAX package's ``shard_map`` all-gathers over its
mp axis; one whose entries lie in one process takes no collective."""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from ..models.verifier_torch import resolve_device
from ..ops import cuda_curve
from ..ops import curve as tc
from ..ops.limb import FP_SPEC


def _norm(device) -> torch.device:
    """A device with its index: "cuda" names the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Devices (an object array of torch.device, one dim per axis) with axis
    names, and the rank of the process that owns each entry. `groups`
    seeds the cache of ``process_groups`` (axis name -> its groups)."""

    def __init__(self, devices, axis_names, ranks=None, distributed: bool = False, groups=None):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.vectorize(_norm, otypes=[object])(arr) if arr.size else arr
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes {self.axis_names}")
        self.ranks = np.zeros(arr.shape, int) if ranks is None else np.asarray(ranks).reshape(arr.shape)
        self.distributed = distributed
        self.rank = dist.get_rank() if distributed else 0
        self._groups = dict(groups or {})

    def process_groups(self, axis_name: str) -> list:
        """One process group per line of entries along `axis_name` (the
        entries that share every other axis's index), in line order: None
        where the line's entries lie in one process (no collective), else
        ``dist.new_group`` of the line's ranks. Made on the first call and
        kept on the mesh. ``new_group`` must be called by every rank of the
        process group, in one order, also by ranks outside the new group:
        so call this on every rank, as the mesh's entry points do."""
        if axis_name not in self._groups:
            i = self.axis_names.index(axis_name)
            lines = np.moveaxis(self.ranks, i, -1).reshape(-1, self.ranks.shape[i])
            self._groups[axis_name] = [
                dist.new_group(sorted(set(line))) if self.distributed and len(set(line)) > 1 else None
                for line in lines.tolist()]
        return self._groups[axis_name]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]}, ranks {self.ranks.ravel().tolist()})"


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, device=None, timeout_s: float | None = None) -> torch.device:
    """Join this process to a torch.distributed process group and return
    its device. Arguments default to the standard env vars (``env://``:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK), so one binary runs under
    any launcher. The device is the card (``cuda:{LOCAL_RANK or rank}``
    modulo the card count, NCCL) unless the caller asks for the CPU (gloo).
    A no-op, returning the device, if the group is already up."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        r = int(os.environ.get("LOCAL_RANK", rank if rank is not None else os.environ.get("RANK", 0)))
        device = torch.device("cuda", r % torch.cuda.device_count())
    if dist.is_initialized():
        return device
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method or "env://", **kwargs)
    return device


def _entries(devices) -> tuple[list, list, bool]:
    """(devices, owning ranks, distributed) of a mesh's entries: this
    process's devices (every card when None), and with a process group up
    every rank's, in rank order."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [str(_norm(d)) for d in devices]
    if not dist.is_initialized():
        return local, [0] * len(local), False
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, local)
    return ([d for devs in every for d in devs],
            [r for r, devs in enumerate(every) for _d in devs], True)


def make_mesh(devices=None, axis: str = "batch") -> Mesh:
    devs, ranks, distributed = _entries(devices)
    return Mesh(np.array(devs, dtype=object), (axis,), ranks, distributed)


def make_mesh_2d(dp: int | None = None, mp: int = 1, devices=None,
                 axes: tuple = ("dp", "mp")) -> Mesh:
    """Two-axis mesh: `dp` (outer, data-parallel over proofs) x `mp` (inner,
    model-parallel over MSM points). The entries are ordered by rank, so
    with more than one process the dp axis runs across processes, and an mp
    group stays inside one process wherever mp divides its device count;
    else the group spans processes and gathers its MSM partials in a process
    subgroup (``process_groups``)."""
    devs, ranks, distributed = _entries(devices)
    n = len(devs)
    if dp is None:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"dp*mp = {dp * mp} != {n} devices")
    return Mesh(np.array(devs, dtype=object).reshape(dp, mp), axes,
                np.array(ranks).reshape(dp, mp), distributed)


def _slots(mesh: Mesh, axis_name: str):
    """(devices, ranks), each (n, m): the n positions along the named axis
    and the m entries of each position."""
    i = mesh.axis_names.index(axis_name)
    n = mesh.devices.shape[i]
    return np.moveaxis(mesh.devices, i, 0).reshape(n, -1), np.moveaxis(mesh.ranks, i, 0).reshape(n, -1)


def _home(mesh: Mesh, devs, ranks):
    """The first of a position's entries that this process owns, or None."""
    mine = [d for d, r in zip(devs, ranks) if r == mesh.rank]
    return mine[0] if mine else None


def shard_batch(mesh: Mesh, *arrays, axis_name: str = "batch"):
    """Split each array's leading dim into one chunk per position along the
    named axis (B must divide evenly): per array, a list of chunks, each on
    its position's first device that this process owns, None where it owns
    none. None arrays stay None."""
    devs, ranks = _slots(mesh, axis_name)
    n = devs.shape[0]
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        t = torch.as_tensor(a)
        if t.shape[0] % n:
            raise ValueError(f"batch {t.shape[0]} does not split into {n} equal shards")
        per = t.shape[0] // n
        out.append([None if (home := _home(mesh, devs[c], ranks[c])) is None
                    else t[c * per : (c + 1) * per].to(home) for c in range(n)])
    return tuple(out)


def _on(device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


# verifier -> {(device, subgroup mode, rounds): the verifier's replica
# there}, built on a mesh's first call and reused by every later one
_REPLICAS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _replica(verifier, d: torch.device):
    """The verifier itself on its own device, else its replica on `d`, built
    once from its host constants (the layout and the device constants are
    the costly part of a verifier)."""
    if d == _norm(verifier.device):  # here: a thread's current card is its own
        return verifier
    key = (str(d), verifier.subgroup_check, verifier.subgroup_rounds)
    reps = _REPLICAS.setdefault(verifier, {})
    if key not in reps:
        reps[key] = type(verifier)(verifier.plan, device=d, subgroup_check=verifier.subgroup_check,
                                   subgroup_rounds=verifier.subgroup_rounds, _state=verifier.state)
    return reps[key]


def _run(verifier, jobs, threads: bool) -> dict:
    """jobs: [(slot, device, fn(verifier on that device) -> result)] ->
    {slot: result}. One verifier per distinct device (``_replica``); a
    device's jobs run in turn, distinct devices on a thread each when
    `threads`."""
    _REPLICAS.setdefault(verifier, {})  # before the threads: each adds its own key
    by_dev: dict = {}
    for slot, d, fn in jobs:
        by_dev.setdefault(str(d), (d, []))[1].append((slot, fn))

    def run_device(d, items):
        with _on(d):
            rep = _replica(verifier, d)
            return {slot: fn(rep) for slot, fn in items}

    out = {}
    if threads and len(by_dev) > 1:
        with ThreadPoolExecutor(max_workers=len(by_dev)) as pool:
            futs = [pool.submit(run_device, d, items) for d, items in by_dev.values()]
            for f in futs:
                out.update(f.result())
    else:
        for d, items in by_dev.values():
            out.update(run_device(d, items))
    return out


def _gather_rows(mesh: Mesh, local: dict, n: int) -> np.ndarray:
    """Per-position verdicts, from every process where the mesh spans
    several, concatenated in row order."""
    if mesh.distributed:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, local)
        merged = {}
        for part in every:
            for c, v in part.items():
                merged.setdefault(c, v)
        local = merged
    return np.concatenate([local[c] for c in range(n)])


def _weights(verifier, mesh: Mesh, sub_rng):
    """The aggregate mode's weights, drawn once for the whole batch (on rank
    0 where the mesh spans processes)."""
    sw = verifier.subgroup_weights(sub_rng)
    if mesh.distributed and sw is not None:
        box = [sw.numpy() if mesh.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        sw = torch.from_numpy(box[0])
    return sw


def data_parallel_verify(verifier, mesh: Mesh, proof_bytes, public_inputs,
                         axis_name: str = "batch", sub_rng=None, y_hints=None) -> np.ndarray:
    """Batch-DP verification: the proof batch splits over the mesh axis,
    every shard runs the verifier's whole program on its device, with no
    traffic between shards. In the default aggregate subgroup mode one set
    of fresh weights is drawn and handed to every shard (the JAX package
    replicates it). Hintless unless `y_hints` are given. Returns the (B,)
    bool verdicts in row order."""
    sw = _weights(verifier, mesh, sub_rng)
    proofs, pis, hints = shard_batch(mesh, proof_bytes, public_inputs, y_hints, axis_name=axis_name)
    devs, ranks = _slots(mesh, axis_name)
    jobs = [(c, _home(mesh, devs[c], ranks[c]),
             lambda v, c=c: v.verify(proofs[c], pis[c], None if hints is None else hints[c],
                                     sub_weights=sw).cpu().numpy())
            for c in range(len(proofs)) if proofs[c] is not None]
    return _gather_rows(mesh, _run(verifier, jobs, threads=not mesh.distributed), len(proofs))


def verify_2d(verifier, mesh: Mesh, proof_bytes, public_inputs,
              dp_axis: str = "dp", mp_axis: str = "mp", sub_rng=None) -> np.ndarray:
    """Two-axis verification (hintless): the proof batch splits over
    `dp_axis`, and each dp group's multi-open MSMs split their points over
    the group's `mp_axis` devices (the verifier's ``msm`` hook, set to
    ``shard_map_msm`` for the call and restored). A group's scalar work
    runs once, on the group's first device that this process owns (on every
    process of a group that spans several, as in the JAX package's
    shard_map). Call it on every rank of a distributed mesh: the mp groups'
    process subgroups are made on the first call."""
    if sorted(mesh.axis_names) != sorted((dp_axis, mp_axis)):
        raise ValueError(f"verify_2d needs a mesh of axes ({dp_axis!r}, {mp_axis!r}), got {mesh.axis_names}")
    groups = mesh.process_groups(mp_axis)  # line c is dp position c's mp group, as _slots' row c
    sw = _weights(verifier, mesh, sub_rng)
    proofs, pis = shard_batch(mesh, proof_bytes, public_inputs, axis_name=dp_axis)
    devs, ranks = _slots(mesh, dp_axis)

    def group(v, c):
        prev = v.msm
        v.msm = functools.partial(shard_map_msm, axis=Mesh(devs[c], (mp_axis,), ranks[c], mesh.distributed,
                                                           groups={mp_axis: [groups[c]]}))
        try:
            return v.verify(proofs[c], pis[c], None, sub_weights=sw).cpu().numpy()
        finally:
            v.msm = prev

    jobs = [(c, _home(mesh, devs[c], ranks[c]), lambda v, c=c: group(v, c))
            for c in range(len(proofs)) if proofs[c] is not None]
    return _gather_rows(mesh, _run(verifier, jobs, threads=not mesh.distributed), len(proofs))


def _comm_device() -> torch.device:
    return _norm("cuda") if dist.get_backend() == "nccl" else torch.device("cpu")


def shard_map_msm(points, scalars, axis: Mesh):
    """Point-sharded batched MSM over a one-axis mesh: entry j computes the
    partial MSM of its 1/n slice of the point axis on its device (the MSM
    kernel), and the partials combine on the input's device
    by a point-add tree (``ops/curve.tree_sum``; projective addition is no
    elementwise sum of limbs). Where the axis's entries lie in several
    processes, each process computes its own entries' slices, pads its
    partials to the most entries a process owns with identity points, and
    the partials are gathered with ``dist.all_gather`` in the axis's process
    subgroup (``Mesh.process_groups``); a process that owns no entry of the
    axis does not call it.

    points: (B, K, 3, 25), scalars: (B, K, 17). K is padded to a multiple of
    the axis size with identity points and zero scalars. Returns (B, 3, 25)
    on points.device."""
    devs, ranks = list(axis.devices.ravel()), axis.ranks.ravel().tolist()
    n = len(devs)
    B, K = points.shape[0], points.shape[1]
    k0 = -(-K // n)
    pad = k0 * n - K
    if pad:
        points = torch.cat([points, tc.identity((B, pad), points.device)], 1)
        scalars = torch.cat([scalars, scalars.new_zeros((B, pad, scalars.shape[2]))], 1)
    group = axis.process_groups(axis.axis_names[0])[0]
    mine = [j for j in range(n) if ranks[j] == axis.rank]
    if not mine or (group is None and len(mine) != n):
        raise ValueError(f"process {axis.rank} owns {len(mine)} of the MSM axis's entries (ranks {ranks})")

    def part(j):
        with _on(devs[j]):
            return cuda_curve.msm(points[:, j * k0 : (j + 1) * k0].to(devs[j]).contiguous(),
                                  scalars[:, j * k0 : (j + 1) * k0].to(devs[j]).contiguous())

    parts = torch.stack([part(j).to(points.device) for j in mine], 1)  # (B, n_local, 3, L)
    if group is not None:
        width = max(ranks.count(r) for r in set(ranks))
        if len(mine) < width:
            parts = torch.cat([parts, tc.identity((B, width - len(mine)), points.device)], 1)
        sent = parts.to(_comm_device()).contiguous()
        got = [torch.empty_like(sent) for _ in range(dist.get_world_size(group))]
        dist.all_gather(got, sent, group=group)
        parts = torch.cat(got, 1).to(points.device)
    return tc.tree_sum(parts)


def sharded_msm(mesh: Mesh, points, scalars, axis_name: str = "shard"):
    """Standalone point-sharded MSM over a one-axis mesh: points (K, 3, 25),
    scalars (K, 17), any K (padded as ``shard_map_msm`` pads). Returns the
    (3, 25) projective sum on the mesh's first device that this process
    owns. Call it on every rank of a distributed mesh (its process subgroup
    is made on the first call)."""
    if mesh.axis_names != (axis_name,):
        raise ValueError(f"sharded_msm needs a one-axis mesh named {axis_name!r}, got {mesh.axis_names}")
    home = _home(mesh, mesh.devices.ravel(), mesh.ranks.ravel())
    pts = torch.as_tensor(points, device=home)[None]
    scs = torch.as_tensor(scalars, device=home)[None]
    if pts.shape[-2:] != (3, FP_SPEC.L):
        raise ValueError(f"points must be (K, 3, {FP_SPEC.L}), got {tuple(pts.shape[1:])}")
    return shard_map_msm(pts, scs, mesh)[0]
