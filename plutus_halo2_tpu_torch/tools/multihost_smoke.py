"""Multi-process smoke of the port's mesh layer: the port of
``tools/multihost_smoke.py``.

Spawns worker processes joined by one ``torch.distributed`` process group
(``parallel/mesh.init_distributed``: gloo on the CPU with ``--cpu``, else
NCCL with one card per rank, which needs a card for each process). Each
worker owns ``--local`` mesh entries (``cpu`` with ``--cpu``, else the
process's card), builds a mesh across the processes (``make_mesh``: every
rank's entries, in rank order) and

  - verifies a global batch of the committed simple_mul proof with one
    corrupted row, data-parallel across every entry of every rank
    (``data_parallel_verify`` in the default hintless aggregate mode, the
    weights drawn on rank 0): the all-gathered verdicts must equal the
    expected vector on every rank;
  - computes a point-sharded MSM across the ranks (``sharded_msm``: each
    entry the MSM of its slice, the partials gathered with
    ``dist.all_gather`` in the axis's process group) at a K that does not
    split evenly, against the spec's MSM.

``launch`` also runs ``verify_2d`` on a dp x mp = 2 mesh over the ranks'
entries (mp groups across processes where a rank owns one entry), which the
tests use with one entry a rank and with unequal entries per rank.

As the reference does, the same global batch runs on one process (one
slice of the cores, ``--local`` entries) and on two (a slice each, twice the
entries): each process is pinned to its own slice of the cores this process
may use (``os.sched_setaffinity``) with ``torch.set_num_threads`` at the
slice's size, and the 1 -> 2 process scaling efficiency is t1 / (2 t2),
t the mean wall of ``--iters`` verifications after a first one (t2 the
slower rank's). With fewer than two cores per process the run is not
pinned and no efficiency is given (the summary says why). The summary
``{ok, verdicts, t1, t2, scaling_efficiency_1to2, backend, batch, ...}`` is
written to ``--out`` (default ``chiprun_out/multihost_smoke.json`` in the
repository; never the JAX package's ``MULTIHOST_SMOKE.json``). Every wait is
bounded: a worker that has not ended within ``--timeout`` seconds fails the
run and is killed.

    python3 -m plutus_halo2_tpu_torch.tools.multihost_smoke [--cpu] [--local N] [--batch B]
        [--iters N] [--timeout S] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import random
import tempfile
import time
from pathlib import Path

NPROC = 2
BAD_ROW = 3
MSM_K = 7  # split over the entries unevenly: one slice is padded
OUT = Path(__file__).resolve().parents[2] / "chiprun_out" / "multihost_smoke.json"


def worker(rank: int, nproc: int, init_method: str, batch: int, cpu: bool, out_path: str,
           local: int = 1, checks=("dp", "msm"), cores=None, iters: int = 0):
    """One rank with `local` mesh entries: the checks named in `checks`
    ("dp": the DP verification, timed over `iters` more calls; "2d":
    verify_2d at mp 2; "msm": the cross-rank MSM); writes its results as
    JSON to out_path. `cores`: the cores to pin this process to."""
    if cores:
        os.sched_setaffinity(0, cores)
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..models.verifier_torch import TorchVerifier
    from ..ops import _build
    from ..ops import curve as tc
    from ..ops.limb import FR_SPEC
    from ..parallel.mesh import (data_parallel_verify, init_distributed, make_mesh, make_mesh_2d,
                                 sharded_msm, verify_2d)
    from ..refimpl import curve as rc
    from ..refimpl.field import Q
    from ..utils.artifacts import load_set

    # pinned: the slice's cores; else one thread, where the plain versions'
    # many small ops only contend
    torch.set_num_threads(len(cores) if cores else 1)
    device = init_distributed(init_method, nproc, rank, device="cpu" if cpu else None, timeout_s=300)
    try:
        plan, proof, _invalid, pis = load_set("simple_mul")
        v = TorchVerifier(plan, device=device)
        proofs = np.stack([np.frombuffer(proof, np.uint8)] * batch).copy()
        proofs[BAD_ROW % batch, 100] ^= 0x40
        want = [i != BAD_ROW % batch for i in range(batch)]
        pis_l = v.encode_public_inputs([pis] * batch)
        entries = [device] * local
        mesh = make_mesh(entries)
        if device.type == "cuda":
            _build.library()  # the build is set-up, not part of the wall
        res = {"rank": rank, "device": str(device), "local": local, "mesh": repr(mesh), "want": want,
               "threads": torch.get_num_threads()}
        if "dp" in checks:
            gen = torch.Generator().manual_seed(7)
            dist.barrier()
            t0 = time.perf_counter()
            got = data_parallel_verify(v, mesh, proofs, pis_l, sub_rng=gen)
            res["first_s"] = time.perf_counter() - t0
            res["verdicts"] = got.tolist()
            walls = []
            for _ in range(iters):
                dist.barrier()
                t0 = time.perf_counter()
                again = data_parallel_verify(v, mesh, proofs, pis_l, sub_rng=gen)
                walls.append(time.perf_counter() - t0)
                if again.tolist() != want:
                    res["verdicts"] = again.tolist()
            res["wall_s"] = sum(walls) / len(walls) if walls else res["first_s"]
        if "2d" in checks:
            grid = make_mesh_2d(mp=2, devices=entries)
            res["mesh_2d"] = repr(grid)
            res["verdicts_2d"] = verify_2d(v, grid, proofs, pis_l, sub_rng=torch.Generator().manual_seed(3)).tolist()
        if "msm" in checks:
            rng = random.Random(11)  # the same inputs on every rank
            host = [rc.g1_mul(rc.G1_GEN, rng.randrange(1, 2**64)) for _ in range(MSM_K)]
            scal = [rng.randrange(Q) for _ in range(MSM_K)]
            pts = np.stack([tc.host_point_to_mont(p) for p in host])
            scs = np.stack([FR_SPEC.encode(s) for s in scal])
            msm = sharded_msm(make_mesh(entries, axis="shard"), pts, scs)
            res["msm_ok"] = tc.host_point_from_mont(msm.cpu().numpy()) == rc.g1_msm(scal, host)
        with open(out_path, "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def core_slices(nproc: int) -> tuple[list | None, str]:
    """(one list of cores per process, or None, and why): this process's
    cores split into `nproc` equal slices, None with fewer than 2 a slice."""
    cores = sorted(os.sched_getaffinity(0))
    per = len(cores) // nproc
    if per < 2:
        return None, f"{len(cores)} cores for {nproc} processes: fewer than 2 a process, not pinned"
    return [cores[i * per : (i + 1) * per] for i in range(nproc)], f"{per} cores a process"


def launch(nproc: int, batch: int, cpu: bool, timeout_s: float, local=1, checks=("dp", "msm"),
           cores=None, iters: int = 0) -> list[dict]:
    """Run `nproc` workers (spawned) in one process group; every rank's
    results, or RuntimeError if a worker failed or outlived `timeout_s`.
    `local`: entries per rank (an int, or one count per rank); `cores`:
    one list of cores per rank to pin it to."""
    ctx = multiprocessing.get_context("spawn")
    per_rank = [local] * nproc if isinstance(local, int) else list(local)
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(nproc)]
        procs = [ctx.Process(target=worker, args=(r, nproc, init, batch, cpu, outs[r], per_rank[r], tuple(checks),
                                                  cores[r] if cores else None, iters))
                 for r in range(nproc)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout_s
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            if hung:
                raise RuntimeError(f"workers {hung} did not end within {timeout_s} s")
            failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
            if failed:
                raise RuntimeError(f"workers failed (rank: exit code): {failed}")
            results = []
            for path in outs:
                with open(path) as f:
                    results.append(json.load(f))
            return results
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)


def check(results: list[dict]):
    for r in results:
        for key in ("verdicts", "verdicts_2d"):
            if key in r and r[key] != r["want"]:
                raise RuntimeError(f"rank {r['rank']}: {key} {r[key]} != {r['want']}")
        if "msm_ok" in r and not r["msm_ok"]:
            raise RuntimeError(f"rank {r['rank']}: the cross-rank MSM differs from the spec's")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU (the plain versions)")
    ap.add_argument("--local", type=int, default=4, help="mesh entries per process")
    ap.add_argument("--batch", type=int, default=None, help="global batch (default 1024, 16 with --cpu)")
    ap.add_argument("--iters", type=int, default=2, help="timed verifications after the first")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds each launch may take")
    ap.add_argument("--out", default=str(OUT), help="the summary's JSON file")
    args = ap.parse_args(argv)
    if not args.cpu:
        import torch

        from ..models.verifier_torch import resolve_device

        resolve_device(None)
        if torch.cuda.device_count() < NPROC:
            raise SystemExit(f"multihost_smoke: NCCL needs a card per rank ({NPROC}), found "
                             f"{torch.cuda.device_count()}; run with --cpu for gloo on the CPU")
    batch = args.batch or (16 if args.cpu else 1024)
    slices, pinning = core_slices(NPROC)
    print(f"[pinning] {pinning}")
    summary = {"backend": "gloo" if args.cpu else "nccl", "batch": batch, "local": args.local,
               "iters": args.iters, "pinning": pinning}
    walls = {}
    for nproc in (1, NPROC):
        results = launch(nproc, batch, args.cpu, args.timeout, args.local, ("dp", "msm"),
                         slices[:nproc] if slices else None, args.iters)
        check(results)
        for r in results:
            print(f"[{nproc} process{'es' if nproc > 1 else ''}] rank {r['rank']} on {r['device']} x{r['local']} "
                  f"({r['threads']} threads): verdicts exact, cross-rank MSM exact, wall {r['wall_s']:.3f} s "
                  f"(first {r['first_s']:.3f} s; {r['mesh']})")
        walls[nproc] = max(r["wall_s"] for r in results)
        summary["verdicts"] = results[0]["verdicts"]
    summary["t1"], summary["t2"] = walls[1], walls[NPROC]
    summary["scaling_efficiency_1to2"] = walls[1] / (NPROC * walls[NPROC]) if slices else None
    summary["ok"] = True
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
