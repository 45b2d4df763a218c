"""The command as the check runs it: no result without a card, none from a
directory holding only BENCHMARK.json and the benchmark's files, and on the
card (``-m gpu``) a short run of a cell that comes out correct with every
per-layer metric of the cell."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import spec

CELL = "simple_mul.rlc8.b1024"


def _run(cwd, *extra, timeout=900):
    cmd = [sys.executable, "-m", "portbench.run", "--workload", CELL, "--seed", str(2**31 + 5), *extra]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark never runs on the CPU")


def test_no_card_no_result(no_card):
    out = _run(spec.ROOT, "--seconds", "1", "--trace", "0", timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA device" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--seconds", "1", "--trace", "0", timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.gpu
def test_cell_on_the_card(card):
    out = _run(spec.ROOT, "--seconds", "3", "--trace", "1")
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "checks"
    want = {m["name"] for m, _mod in spec.cell(CELL, True).metrics}
    assert set(result["metrics"]) == want
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
