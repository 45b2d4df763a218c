"""Entry points: the port of ``__graft_entry__.py``.

``entry()`` returns a batched verification step on the flagship path
(simple_mul, halo2-book KZG, the default hintless aggregate subgroup test)
with its example arguments; ``dryrun_multichip(n)`` runs the reference's
three multi-device legs over ``parallel/mesh.py``. Both build from the
committed simple_mul set (``utils/artifacts.load_set``), where the
reference's ``_build`` proves at run time. Both run on the card unless
the caller asks for the CPU (``device="cpu"``), and raise without one.

    python3 -m plutus_halo2_tpu_torch.entry [--cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .models.verifier_torch import TorchVerifier, resolve_device
from .parallel.mesh import data_parallel_verify, make_mesh, make_mesh_2d, verify_2d
from .utils.artifacts import load_set

# the reference's leg cost model: a later leg starts only with this much
# headroom in the budget, at least its floor
LEG_FLOOR_S = 60.0


def _check(ok: bool, what: str):
    """The legs' verdict asserts, kept under ``python -O``."""
    if not ok:
        raise AssertionError(what)


def _build(batch: int, device, name: str = "simple_mul"):
    """(verifier, (batch, PLEN) uint8 proofs, (batch, n_pi, 17) public
    inputs): the committed set's honest proof on every row, the default
    verifier (aggregate subgroup test, 1 round) on `device`."""
    plan, proof, _invalid, pis = load_set(name)
    verifier = TorchVerifier(plan, device=device)
    proofs = np.stack([np.frombuffer(proof, np.uint8)] * batch)
    return verifier, proofs, verifier.encode_public_inputs([pis] * batch)


def entry(device=None):
    """Returns (fn, example_args): fn(*example_args) runs a batched proof
    verification step (batch 4) on one card (default semantics: y-hintless
    decompression and the aggregate subgroup test with fixed weights from a
    seeded generator) and returns the (4,) bool verdicts on the device. fn
    is ``TorchVerifier.verify``; the arguments are the proofs and public
    inputs on the verifier's device, no y-hints, no generator, and
    ``sub_weights``."""
    verifier, proofs, pis = _build(4, resolve_device(device))
    dev = verifier.device
    sw = verifier.subgroup_weights(torch.Generator().manual_seed(0))
    return verifier.verify, (torch.from_numpy(proofs).to(dev), torch.from_numpy(pis).to(dev), None, None, sw)


def _mesh_devices(n: int, device) -> list:
    """n mesh entries: `device` n times on the CPU; else n cards where there
    are n, else n entries of the one card (a virtual mesh)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return [device] * n
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Build an n-entry mesh and run the verification step under the
    reference's sharding strategies at tiny shapes:
      leg 1 — batch DP over a flat mesh, 2 proofs per entry, one corrupted
              row (verdicts must be per-proof, not batch-collapsed);
      leg 2 — a dp x mp mesh (dp = n/2, mp = 2): the batch split over dp,
              each group's multi-open MSM split over mp with the gather and
              point-add reduction (parallel/mesh.verify_2d);
      leg 3 — the atms_with_lookups plan (the reference's fifth benchmark
              configuration), rebuilt from the committed artifacts, through
              the DP mesh, one corrupted row at min(1, n - 1).

    Each leg asserts its verdicts and prints its line. As the reference
    does, a wall-clock budget (PH2_DRYRUN_BUDGET_S, default 1200 s) gates
    legs 2 and 3: a leg starts only if the time spent (for leg 3, plus
    leg 1's time, at least 60 s) leaves room, else it prints an explicit
    "SKIPPED (budget)" line. Returns {leg: verdicts, or "SKIPPED"}."""
    t_start = time.time()
    budget = float(os.environ.get("PH2_DRYRUN_BUDGET_S", "1200"))
    devs = _mesh_devices(n_devices, device)
    out = {}

    batch = 2 * n_devices
    bad = min(3, batch - 1)
    verifier, proofs, pis = _build(batch, devs[0])
    proofs = proofs.copy()
    proofs[bad, 100] ^= 0x40  # corrupted row: verdicts must be per-proof
    expected = [i != bad for i in range(batch)]

    got = data_parallel_verify(verifier, make_mesh(devs), proofs, pis)
    _check(got.shape == (batch,) and got.tolist() == expected, f"DP verdicts wrong: {got.tolist()}")
    t_leg1 = time.time() - t_start
    out["dp"] = got.tolist()
    print(f"dryrun_multichip({n_devices}) DP leg: OK ({t_leg1:.0f}s), verdicts={got.tolist()}")
    leg_cost = max(t_leg1, LEG_FLOOR_S)

    if n_devices >= 2 and time.time() - t_start > budget:
        out["dp_x_mp"] = "SKIPPED"
        print(f"dryrun_multichip({n_devices}) dp x mp leg: SKIPPED (budget: "
              f"{time.time() - t_start:.0f}s elapsed > {budget:.0f}s)")
    elif n_devices >= 2:
        # odd counts: the largest even prefix of the entries, the batch cut
        # to a multiple of dp
        n2 = (n_devices // 2) * 2
        b2 = 2 * n2
        t2 = time.time()
        grid = make_mesh_2d(dp=n2 // 2, mp=2, devices=devs[:n2])
        got2 = verify_2d(verifier, grid, proofs[:b2], pis[:b2])
        _check(got2.tolist() == expected[:b2], f"dp x mp verdicts wrong: {got2.tolist()}")
        out["dp_x_mp"] = got2.tolist()
        print(f"dryrun_multichip({n_devices}) dp x mp sharded-MSM leg ({n_devices} devices): OK "
              f"({time.time() - t2:.0f}s), verdicts={got2.tolist()}")

    if time.time() - t_start + leg_cost > budget:
        out["atms_with_lookups"] = "SKIPPED"
        print(f"dryrun_multichip({n_devices}) atms_with_lookups DP leg: SKIPPED (budget: "
              f"{time.time() - t_start:.0f}s elapsed + ~{leg_cost:.0f}s leg > {budget:.0f}s)")
        return out
    t3 = time.time()
    ver3, proofs3, pis3 = _build(n_devices, devs[0], "atms_with_lookups")
    proofs3 = proofs3.copy()
    bad3 = min(1, n_devices - 1)
    proofs3[bad3, 100] ^= 0x40
    got3 = data_parallel_verify(ver3, make_mesh(devs), proofs3, pis3)
    exp3 = [i != bad3 for i in range(n_devices)]
    _check(got3.tolist() == exp3, f"atms_with_lookups DP verdicts wrong: {got3.tolist()}")
    out["atms_with_lookups"] = got3.tolist()
    print(f"dryrun_multichip({n_devices}) atms_with_lookups DP leg: OK ({time.time() - t3:.0f}s), "
          f"verdicts={got3.tolist()}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run entry()'s verification step and print its verdicts.")
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the CPU")
    args = ap.parse_args(argv)
    fn, example_args = entry("cpu" if args.cpu else None)
    verdicts = fn(*example_args).cpu().numpy()
    print("entry verdicts:", verdicts)
    return verdicts


if __name__ == "__main__":
    main()
