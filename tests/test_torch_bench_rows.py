"""The port's bench (plutus_halo2_tpu_torch/bench.py) as tools/bench_rows.py
runs the JAX one: only the rows asked for (--rows gwc lookup), on the CPU
at batch 8, every kernel through its plain version. Every verdict assert
holds, each row carries bench.py's metric name and keys (as
tests/test_torch_bench.py checks them), and the rows merge by metric into
an --out file that already holds other rows, which stay."""

import json

import pytest

torch = pytest.importorskip("torch")
# the plain versions run many small ops, where intra-op threads only
# contend with the other test workers
torch.set_num_threads(1)

from plutus_halo2_tpu_torch import bench  # noqa: E402
from test_torch_bench import check_verification_row  # noqa: E402


def test_bench_rows_merge_into_the_out_file(tmp_path, capsys):
    out = tmp_path / "bench_details.json"
    kept = {"metric": "g1_msm_points_per_sec", "value": 1.0, "date": "2026-01-01"}
    stale = {"metric": "lookup_table_halo2_verifications_per_sec_per_chip", "value": -1.0}
    out.write_text(json.dumps([kept, stale]))
    rows = bench.main(["--cpu", "--batch", "8", "--iters", "1", "--rows", "gwc", "lookup", "--out", str(out)])
    printed = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    metrics = ["simple_mul_gwc19_verifications_per_sec_per_chip", "lookup_table_halo2_verifications_per_sec_per_chip"]
    assert [r["metric"] for r in printed] == [r["metric"] for r in rows] == metrics
    for row in rows:
        check_verification_row(row, 8)
    assert rows[0]["msm_terms"] == [3, 17] and rows[1]["msm_terms"] == [19]
    written = json.loads(out.read_text())
    assert [r["metric"] for r in written] == ["g1_msm_points_per_sec"] + metrics[1:] + metrics[:1]
    assert written[0] == kept and written[1]["value"] == rows[1]["value"] and "date" in written[2]
