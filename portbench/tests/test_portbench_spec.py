"""BENCHMARK.json against the contract, and every name in it resolved to
its files: configurations, traffic mixes, entries and metric readers."""

import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
E2E = {m["name"] for m in BENCH["end_to_end"]}
TRAFFIC_KEYS = {"entry", "batch", "in_flight", "hints", "subgroup", "subgroup_rounds", "rlc_group",
                "invalid_per_batch", "invalid_kinds", "variants_per_kind", "layouts", "trace_batches"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # a full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 a cell, 1200 spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = [x["name"] for group in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[group]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and _line(config["source"]) and _line(config["why"])
    assert config["reduced"] == []
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    path = spec.ROOT / config["file"]
    assert path.is_relative_to(spec.HERE) and path.exists()
    data = json.loads(path.read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    circuit = spec.load_module(spec.HERE / "configs" / f"{config['name']}.py", config["name"])
    assert callable(circuit.spec) and circuit.NUM_PUBLIC_INPUTS == data["public_inputs"]
    for suffix in ("proof.hex", "proof_invalid.hex", "public_input.hex", "vk.json"):
        prefix = spec.HERE / "configs" / data["artifacts"]
        assert (prefix.parent / f"{prefix.name}_{suffix}").exists()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and _line(cell["why"])
    assert cell["chips"] == 1
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    t = json.loads((spec.HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    assert set(t) == TRAFFIC_KEYS
    assert (spec.HERE / "entries" / f"{t['entry']}.py").exists()
    for trace in (False, True):
        c = spec.cell(cell["name"], trace)
        assert c.config["name"] == cell["config"] and c.traffic == t
        reported = {m["name"] for m, _mod in c.metrics}
        if not trace:
            assert "setup_s" in reported and len(reported) >= 2
        else:
            assert reported


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_file_matches(metric):
    keys = {"name", "unit", "better", "source"} | ({"bound"} if metric["name"] in E2E else {"layer", "moves"})
    assert set(metric) - {"workloads"} == keys
    assert set(metric.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    mod = spec.metric_module(metric["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (metric["unit"], metric["better"], metric["source"])
    assert callable(mod.read)
    if metric["name"] in E2E:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"]) and _line(mod.LAYER)
        assert metric["moves"] in E2E
        # every cell that reads it reports the end-to-end metric it moves
        for w in BENCH["workloads"]:
            if w["name"] in metric.get("workloads", [w["name"]]):
                assert metric["moves"] in {m["name"] for m, _mod in spec.cell(w["name"], False).metrics}
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def test_setup_bound():
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_names_its_cells(metric):
    """A metric with no list would be read in every cell a later change adds."""
    assert metric["workloads"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_reads_the_batch_tail(cell):
    assert "batch_p95_ms" in {m["name"] for m, _mod in spec.cell(cell["name"], False).metrics}


def test_csrc_kernel_names_are_the_ports():
    import re as _re

    csrc = spec.ROOT / "plutus_halo2_tpu_torch" / "csrc"
    names = set()
    for f in csrc.glob("*.cu"):
        names |= set(_re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)",
                                 f.read_text()))
    glue = spec.metric_module("glue.device_ms")
    assert not set(glue.CSRC_KERNELS) & set(glue.GLUE_KERNELS)
    assert names == set(glue.CSRC_KERNELS) | set(glue.GLUE_KERNELS)
