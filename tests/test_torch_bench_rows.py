"""The port's bench (plutus_halo2_tpu_torch/bench.py) as tools/bench_rows.py
runs the JAX one: only the rows asked for (--rows gwc lookup), on the CPU
at batch 8, every kernel through its plain version. Every verdict assert
holds, each row carries bench.py's metric name and keys (as
tests/test_torch_bench.py checks them), and the rows merge by metric into
an --out file that already holds other rows, which stay. The two rows at
90 parties and threshold 50 read the port's committed sets at batch 2
with their verdict asserts; without a committed set a row proves its set
in-process first (the ATMS example's prove_set, here stood in for by the
committed 2-party set, so that the test stays short)."""

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


def test_the_50_of_90_rows_on_the_cpu(tmp_path, capsys):
    rows = bench.main(["--cpu", "--batch", "2", "--iters", "1", "--rows", "atms_50_90", "atms_with_lookups_50_90",
                       "--out", str(tmp_path / "b.json")])
    metrics = ["atms_50_90_halo2_verifications_per_sec_per_chip",
               "atms_with_lookups_50_90_halo2_verifications_per_sec_per_chip"]
    assert [r["metric"] for r in rows] == metrics
    for row in rows:
        check_verification_row(row, 2)
    assert [r["msm_terms"] for r in rows] == [[32], [36]]
    assert "proving it in-process" not in capsys.readouterr().err


def test_a_50_of_90_row_proves_its_set_without_a_committed_one(tmp_path, monkeypatch, capsys):
    from plutus_halo2_tpu_torch.examples import atms as atms_example
    from plutus_halo2_tpu_torch.utils.artifacts import load_set

    asked = []

    def prove_set(parties, threshold, lookups, device=None):
        asked.append((parties, threshold, lookups, device.type))
        plan, proof, _bad, inputs = load_set("atms_with_lookups" if lookups else "atms")
        return {"plan": plan, "proof": proof, "inputs": inputs}

    monkeypatch.setattr(bench, "has_set", lambda name: False)
    monkeypatch.setattr(atms_example, "prove_set", prove_set)
    rows = bench.main(["--cpu", "--batch", "2", "--iters", "1", "--rows", "atms_with_lookups_50_90",
                       "--out", str(tmp_path / "b.json")])
    assert asked == [(90, 50, True, "cpu")]
    assert "proving it in-process" in capsys.readouterr().err
    check_verification_row(rows[0], 2)
