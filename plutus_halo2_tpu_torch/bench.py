"""Benchmark of the port: batched Halo2 proof verification throughput on
the card. The counterpart of ``bench.py`` and ``tools/bench_rows.py``.

    python3 -m plutus_halo2_tpu_torch.bench [--rows ROW ...] [--batch 1024] [--iters 3]
        [--msm-batch N] [--cpu] [--out PATH]

Prints one JSON line per row, the headline
(``simple_mul_halo2_verifications_per_sec_per_chip``) last, as
``bench.py`` does, and merges the rows by metric into ``--out`` (default
``chiprun_out/bench_details.json`` in the repository), each stamped with
the commit (where git can tell it) and the date; it writes no other file.
Runs on the card unless ``--cpu`` asks for the plain versions, and raises
without one.

Rows, under ``bench.py``'s metric names (``--rows``: any of the names below,
or ``all``; by default the rows ``bench.py`` always runs):
  headline   ``verify_rlc_device`` at group 8 (the largest divisor of the
             batch up to 8) on honest traffic, with the corrupted-row batch's
             ``corrupted_row_steady_sec`` and ``corrupted_row_proofs_per_sec``
             (bench.py:368-393, :109-149);
  exact      exact ``verify()`` (bench.py:359-366);
  msm        ``g1_msm_points_per_sec``: the MSM kernel at K = 64 (several
             points on a lane), at ``--msm-batch`` rows (default the batch),
             held against ``ops/curve.msm_windowed`` in affine coordinates on
             the same tensors, and row 0 against the spec's MSM, before it is
             timed (bench.py:186-219);
  hintless, strict, off, r2   no y-hints; ``subgroup_check="exact"``; the
             subgroup test off; 2 rounds of the aggregate test (bench.py:231-261);
  gwc        the committed ``simple_mul_gwc19`` set (bench.py:262-266);
  lookup     ``lookup_table`` (bench.py:267-271);
  rlc        the RLC sweep at groups 8, 16 and 32, each that divides the
             batch (bench.py:338-352);
  atms, atms_with_lookups, atms_228_408   the committed ATMS sets, the
             last at k = 22 under the JAX name of that scale;
  atms_50_90, atms_with_lookups_50_90   the ATMS pair at the reference's
             benchmark scale, 90 parties and threshold 50 (k = 20), under
             the JAX names of that scale (bench.py:273-336): the committed
             sets (``plutus_halo2_tpu_torch/artifacts/``) where they are
             there, else proved in-process first by the port's prover with
             the ATMS example's defaults (``examples/atms.prove_set``: the
             same bytes), which takes minutes of host Python. Neither is a
             default row.

Inputs: each set's committed honest proof tiled to the batch; the corrupted
copy flips bit 6 of byte 100 of row 1 (bench.py:92-93), so every row's
expected verdicts are known and asserted on every batch. Y-hints and RLC
weights are prepared outside the timed calls (bench.py:99-107, :120-122);
the aggregate test's weights are drawn on the host inside each call, from
a seeded generator.

Fields (bench.py:161-183): ``value``, ``unit``, ``batch``;
``steady_state_sec``, the time per call of `iters` calls launched back to
back with one ``torch.cuda.synchronize()`` at the end (bench.py's
``_time_pipelined`` launches max(iters, 4)); ``latency_sec``, the best of
`iters` calls, each synchronized; ``warmup_sec`` in place of
``compile_sec``: the first call, after the kernels are built (the nvcc build
is not in it); ``msm_terms``, ``y_hints``, ``subgroup``,
``subgroup_rounds``, ``mode``, ``rlc_group``, ``traffic``; ``device``, the
card's name and power limit (``utils/profiling.card_line``). Every row's
calls replay the verifier's captured programs (``models/programs.py``; the
first call captures, so ``warmup_sec`` holds the capture). The RLC rows are
fully pipelined: ``verify_rlc_device`` gates the re-check on the device, as
the JAX package does, and reads nothing back, which each RLC row records as
``host_syncs_per_call`` 0. There is no ``vs_baseline`` and no floor:
``BASELINE.json``'s target and floor are TPU numbers, and the port states
none. There is no fallback to a smaller batch: a failure raises."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from datetime import date
from pathlib import Path

import numpy as np
import torch

from .models.verifier_torch import TorchVerifier, resolve_device
from .ops import _build, cuda_curve
from .ops import curve as tc
from .ops.limb import FR_SPEC
from .refimpl import curve as rc
from .refimpl.field import Q
from .utils.artifacts import has_set, load_set
from .utils.profiling import card_line

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "bench_details.json"
HEADLINE = "simple_mul_halo2_verifications_per_sec_per_chip"
ROWS = ("headline", "exact", "msm", "hintless", "strict", "off", "r2", "gwc", "lookup", "rlc", "atms",
        "atms_with_lookups", "atms_228_408", "atms_50_90", "atms_with_lookups_50_90")
DEFAULT_ROWS = ("headline", "exact", "msm")
BAD_ROW, BAD_BYTE = 1, 100
MSM_K = 64


def _check(ok: bool, what: str):
    """The bench's verdict and parity asserts, kept under ``python -O``."""
    if not ok:
        raise AssertionError(f"bench: {what}")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _fetch(x) -> np.ndarray:
    return x.cpu().numpy()


def _time_best(fn, iters: int) -> float:
    """The best of `iters` calls, each waited for."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _fetch(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


def _time_pipelined(fn, iters: int, device) -> float:
    """Seconds per call of `iters` calls launched back to back and one
    synchronize at the end, as a serving loop with batches in flight."""
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def atms_set(name: str, device):
    """(plan, proof, inputs) of an ATMS set at 90 parties and threshold 50:
    the committed one, else proved here with the example's defaults."""
    if has_set(name):
        plan, proof, _invalid, inputs = load_set(name)
        return plan, proof, inputs
    from .examples.atms import prove_set

    print(f"# {name}: no committed set; proving it in-process", file=sys.stderr)
    made = prove_set(90, 50, name.startswith("atms_with_lookups"), device=device)
    return made["plan"], made["proof"], made["inputs"]


def bench_circuit(name: str, metric: str, batch: int, iters: int, device, y_hints: bool = True,
                  rlc_group: int | None = None, subgroup: str = "aggregate",
                  subgroup_rounds: int | None = None, prebuilt=None) -> dict:
    """One verification row of the committed set `name`, or of `prebuilt`
    (plan, proof, inputs) (bench.py's ``_bench_circuit``)."""
    if prebuilt is None:
        plan, proof, _invalid, inputs = load_set(name)
    else:
        plan, proof, inputs = prebuilt
    proofs = np.stack([np.frombuffer(proof, np.uint8)] * batch)
    proofs_bad = proofs.copy()
    proofs_bad[BAD_ROW, BAD_BYTE] ^= 0x40
    want_bad = [i != BAD_ROW for i in range(batch)]
    kw = {} if subgroup_rounds is None else {"subgroup_rounds": subgroup_rounds}
    v = TorchVerifier(plan, device=device, subgroup_check=subgroup, **kw)

    def put(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    pis = put(v.encode_public_inputs([inputs] * batch))
    # y-hints travel with the proofs (any host core or the submitter computes
    # them; decompression re-checks each): prepared outside the timed calls
    hints = put(v.compute_y_hints(proofs)) if y_hints else None
    hints_bad = put(v.compute_y_hints(proofs_bad)) if y_hints else None
    proofs_d, proofs_bad_d = put(proofs), put(proofs_bad)
    gen = torch.Generator().manual_seed(0)  # the aggregate test's weights, drawn in each call

    extra = {}
    if rlc_group is not None:
        weights = v.rlc_weights(batch, torch.Generator().manual_seed(1))

        def fn():
            return v.verify_rlc_device(proofs_d, pis, weights, hints, group=rlc_group, generator=gen)[0]

        def fn_bad():
            return v.verify_rlc_device(proofs_bad_d, pis, weights, hints_bad, group=rlc_group, generator=gen)[0]

        _sync(device)
        t0 = time.perf_counter()
        out_bad = _fetch(fn_bad())
        warmup = time.perf_counter() - t0
        out = _fetch(fn())
        full = v.verify_rlc(proofs_bad_d, pis, hints_bad, group=rlc_group, generator=torch.Generator().manual_seed(2))
        _check(full.tolist() == want_bad, f"{metric}: verify_rlc's verdicts {full.tolist()[:4]}... differ")
        _check(out_bad.tolist() == want_bad, f"{metric}: the corrupted batch's verdicts {out_bad.tolist()[:4]}...")
        _check(bool(out.all()), f"{metric}: the honest batch's verdicts {out.tolist()[:4]}...")
        piped_bad = _time_pipelined(fn_bad, iters, device)
        extra = {"mode": "rlc_batch_pairing_exact_verdicts", "rlc_group": rlc_group, "traffic": "honest",
                 "corrupted_row_steady_sec": piped_bad, "corrupted_row_proofs_per_sec": batch / piped_bad,
                 "host_syncs_per_call": 0}
    else:
        # exact per-proof mode: every row pays its own pairing either way;
        # the corrupted batch is the timed one
        def fn():
            return v.verify(proofs_bad_d, pis, hints_bad, gen)

        _sync(device)
        t0 = time.perf_counter()
        out = _fetch(fn())
        warmup = time.perf_counter() - t0
        _check(out.tolist() == want_bad, f"{metric}: verdicts {out.tolist()[:4]}... differ")

    best = _time_best(fn, iters)
    piped = _time_pipelined(fn, iters, device)
    row = {"metric": metric, "value": batch / piped, "unit": "proofs/s", "batch": batch,
           "steady_state_sec": piped, "latency_sec": best, "warmup_sec": warmup,
           "msm_terms": list(v.msm_term_counts), "y_hints": y_hints, "device": card_line(device)}
    row.update(extra)
    row["subgroup"] = subgroup
    if subgroup == "aggregate":
        row["subgroup_rounds"] = v.subgroup_rounds
    return row


def msm_inputs(batch: int, device, K: int = MSM_K):
    """(points (batch, K, 3, 25), scalars (batch, K, 17) on `device`, the
    host points, the scalars): bench.py's seeded points and scalars
    (default_rng(5)), the same K on every row."""
    rng = np.random.default_rng(5)
    host = [rc.g1_mul(rc.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(K)]
    scal = [int.from_bytes(rng.bytes(31), "little") % Q for _ in range(K)]
    pts = np.stack([np.stack([tc.host_point_to_mont(p) for p in host])] * batch)
    scs = np.stack([np.stack([FR_SPEC.encode(s) for s in scal])] * batch)
    return torch.from_numpy(pts).to(device), torch.from_numpy(scs).to(device), host, scal


def bench_msm(batch: int, iters: int, device, K: int = MSM_K) -> dict:
    """G1 MSM points/s (bench.py's ``_bench_msm``): the MSM kernel at
    (batch, K), held against the plain windowed MSM in affine coordinates
    on every row and row 0 against the spec's MSM before it is timed."""
    pts, scs, host, scal = msm_inputs(batch, device, K)
    _sync(device)
    t0 = time.perf_counter()
    out = cuda_curve.msm(pts, scs)
    _sync(device)
    warmup = time.perf_counter() - t0
    got, want = tc.to_affine(out), tc.to_affine(tc.msm_windowed(pts, scs))
    _check(all(torch.equal(x, y) for x, y in zip(got, want)),
           f"the MSM kernel at ({batch}, {K}) differs from ops/curve.msm_windowed in affine coordinates")
    _check(tc.host_point_from_mont(out[0].cpu().numpy()) == rc.g1_msm(scal, host),
           f"the MSM kernel's row 0 at K = {K} differs from the spec's MSM")
    best = _time_best(lambda: cuda_curve.msm(pts, scs), max(1, iters - 1))
    return {"metric": "g1_msm_points_per_sec", "value": batch * K / best, "unit": "points/s", "K": K,
            "batch": batch, "steady_state_sec": best, "warmup_sec": warmup, "device": card_line(device)}


def _rlc_group(batch: int, want: int = 8) -> int:
    g = want
    while batch % g:
        g -= 1  # the largest divisor up to the one asked for
    if g != want:
        print(f"# rlc group adjusted to {g} to divide batch {batch}", file=sys.stderr)
    return g


def _commit() -> str | None:
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=ROOT, capture_output=True, text=True,
                             timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 and out.stdout.strip() else None


def write_rows(rows: list[dict], path) -> None:
    """Stamp the rows with the commit and the date and merge them by metric
    into the JSON list at `path` (rows it holds from earlier runs stay)."""
    path = Path(path)
    table = []
    if path.exists():
        try:
            table = json.loads(path.read_text())
        except ValueError:
            table = []
    commit = _commit()
    for row in rows:
        if commit:
            row["commit"] = commit
        row["date"] = date.today().isoformat()
    merged = {row["metric"]: row for row in table}
    merged.update({row["metric"]: row for row in rows})
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(list(merged.values()), indent=1))


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", nargs="+", default=list(DEFAULT_ROWS), choices=ROWS + ("all",),
                    help="the rows to run (default: headline exact msm)")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--msm-batch", type=int, default=None, help="the MSM row's batch (default: --batch)")
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the CPU")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    want = set(ROWS if "all" in args.rows else args.rows)
    batch, iters = args.batch, args.iters
    if device.type == "cuda":
        t0 = time.perf_counter()
        _build.library()  # the build is set-up: no row's warm-up holds it
        print(f"# kernels built and loaded in {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    sm = "simple_mul"
    for key, name, metric, kw in (
        ("hintless", sm, "simple_mul_halo2_hintless_verifications_per_sec_per_chip", {"y_hints": False}),
        ("strict", sm, "simple_mul_halo2_strict_subgroup_verifications_per_sec_per_chip", {"subgroup": "exact"}),
        ("off", sm, "simple_mul_halo2_subgroup_off_verifications_per_sec_per_chip", {"subgroup": "off"}),
        ("r2", sm, "simple_mul_halo2_subgroup_r2_verifications_per_sec_per_chip", {"subgroup_rounds": 2}),
        ("gwc", "simple_mul_gwc19", "simple_mul_gwc19_verifications_per_sec_per_chip", {}),
        ("lookup", "lookup_table", "lookup_table_halo2_verifications_per_sec_per_chip", {}),
        ("atms", "atms", "atms_halo2_verifications_per_sec_per_chip", {}),
        ("atms_with_lookups", "atms_with_lookups", "atms_with_lookups_halo2_verifications_per_sec_per_chip", {}),
        ("atms_228_408", "atms_228_408", "atms_228_408_halo2_verifications_per_sec_per_chip", {}),
    ):
        if key in want:
            emit(bench_circuit(name, metric, batch, iters, device, **kw))
    for key in ("atms_50_90", "atms_with_lookups_50_90"):
        if key in want:
            emit(bench_circuit(key, f"{key}_halo2_verifications_per_sec_per_chip", batch, iters, device,
                               prebuilt=atms_set(key, device)))
    if "rlc" in want:
        for g in (8, 16, 32):
            if batch % g == 0:
                emit(bench_circuit(sm, f"simple_mul_halo2_rlc_group{g}_verifications_per_sec_per_chip", batch,
                                   iters, device, rlc_group=g))
    if "msm" in want:
        emit(bench_msm(args.msm_batch or batch, iters, device))
    if "exact" in want:
        emit(bench_circuit(sm, "simple_mul_halo2_exact_verifications_per_sec_per_chip", batch, iters, device))
    if "headline" in want:  # last: single-line consumers read the last line
        emit(bench_circuit(sm, HEADLINE, batch, iters, device, rlc_group=_rlc_group(batch)))
    write_rows(rows, args.out)
    return rows


if __name__ == "__main__":
    main()
