"""Multi-process smoke of the port's mesh layer: the port of
``tools/multihost_smoke.py``.

Spawns worker processes joined by one ``torch.distributed`` process group
(``parallel/mesh.init_distributed``: gloo on the CPU with ``--cpu``, else
NCCL with one card per rank, which needs a card for each process). Each
worker builds a mesh across the processes (``make_mesh``: every rank's
device, in rank order) and

  - verifies a global batch of the committed simple_mul proof with one
    corrupted row, data-parallel across the ranks (``data_parallel_verify``
    in the default hintless aggregate mode, the weights drawn on rank 0):
    the all-gathered verdicts must equal the expected vector on every rank;
  - computes a point-sharded MSM across the ranks (``sharded_msm``: each
    rank the MSM of its slice, the partials gathered with
    ``dist.all_gather``) at a K that does not split evenly, against the
    spec's MSM.

The same global batch runs on one process and on two, and each worker's
wall for the verification is printed. Every wait is bounded: a worker that
has not ended within ``--timeout`` seconds fails the run and is killed.

    python3 -m plutus_halo2_tpu_torch.tools.multihost_smoke [--cpu] [--batch B] [--timeout S]
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import random
import tempfile
import time

NPROC = 2
BAD_ROW = 3
MSM_K = 7  # split over the ranks unevenly: one slice is padded


def worker(rank: int, nproc: int, init_method: str, batch: int, cpu: bool, out_path: str):
    """One rank: the DP verification and the cross-rank MSM; writes its
    results as JSON to out_path."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..models.verifier_torch import TorchVerifier
    from ..ops import _build
    from ..ops import curve as tc
    from ..ops.limb import FR_SPEC
    from ..parallel.mesh import data_parallel_verify, init_distributed, make_mesh, sharded_msm
    from ..refimpl import curve as rc
    from ..refimpl.field import Q
    from ..utils.artifacts import load_set

    if cpu:  # the plain versions run many small ops, where threads only contend
        torch.set_num_threads(1)
    device = init_distributed(init_method, nproc, rank, device="cpu" if cpu else None, timeout_s=300)
    try:
        plan, proof, _invalid, pis = load_set("simple_mul")
        v = TorchVerifier(plan, device=device)
        proofs = np.stack([np.frombuffer(proof, np.uint8)] * batch).copy()
        proofs[BAD_ROW % batch, 100] ^= 0x40
        want = [i != BAD_ROW % batch for i in range(batch)]
        pis_l = v.encode_public_inputs([pis] * batch)
        mesh = make_mesh([device])
        if device.type == "cuda":
            _build.library()  # the build is set-up, not part of the wall
        dist.barrier()
        t0 = time.perf_counter()
        got = data_parallel_verify(v, mesh, proofs, pis_l, sub_rng=torch.Generator().manual_seed(7))
        wall = time.perf_counter() - t0

        rng = random.Random(11)  # the same inputs on every rank
        host = [rc.g1_mul(rc.G1_GEN, rng.randrange(1, 2**64)) for _ in range(MSM_K)]
        scal = [rng.randrange(Q) for _ in range(MSM_K)]
        pts = np.stack([tc.host_point_to_mont(p) for p in host])
        scs = np.stack([FR_SPEC.encode(s) for s in scal])
        msm = sharded_msm(make_mesh([device], axis="shard"), pts, scs)
        msm_ok = tc.host_point_from_mont(msm.cpu().numpy()) == rc.g1_msm(scal, host)
        with open(out_path, "w") as f:
            json.dump({"rank": rank, "device": str(device), "mesh": repr(mesh), "verdicts": got.tolist(),
                       "want": want, "wall_s": wall, "msm_ok": msm_ok}, f)
    finally:
        dist.destroy_process_group()


def launch(nproc: int, batch: int, cpu: bool, timeout_s: float) -> list[dict]:
    """Run `nproc` workers (spawned) in one process group; every rank's
    results, or RuntimeError if a worker failed or outlived `timeout_s`."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(nproc)]
        procs = [ctx.Process(target=worker, args=(r, nproc, init, batch, cpu, outs[r])) for r in range(nproc)]
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
        if r["verdicts"] != r["want"]:
            raise RuntimeError(f"rank {r['rank']}: verdicts {r['verdicts']} != {r['want']}")
        if not r["msm_ok"]:
            raise RuntimeError(f"rank {r['rank']}: the cross-rank MSM differs from the spec's")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU (the plain versions)")
    ap.add_argument("--batch", type=int, default=None, help="global batch (default 1024, 8 with --cpu)")
    ap.add_argument("--timeout", type=float, default=900.0, help="seconds each launch may take")
    args = ap.parse_args(argv)
    if not args.cpu:
        import torch

        from ..models.verifier_torch import resolve_device

        resolve_device(None)
        if torch.cuda.device_count() < NPROC:
            raise SystemExit(f"multihost_smoke: NCCL needs a card per rank ({NPROC}), found "
                             f"{torch.cuda.device_count()}; run with --cpu for gloo on the CPU")
    batch = args.batch or (8 if args.cpu else 1024)
    summary = {"backend": "gloo" if args.cpu else "nccl", "batch": batch}
    for nproc in (1, NPROC):
        results = launch(nproc, batch, args.cpu, args.timeout)
        check(results)
        for r in results:
            print(f"[{nproc} process{'es' if nproc > 1 else ''}] rank {r['rank']} on {r['device']}: "
                  f"verdicts exact, cross-rank MSM exact, wall {r['wall_s']:.3f} s ({r['mesh']})")
        summary[f"wall_s_{nproc}"] = [r["wall_s"] for r in results]
    summary["ok"] = True
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
