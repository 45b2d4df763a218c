"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each metric is a file of its own. Nothing here knows a cell, a
configuration, a mix or a metric by name:

- ``configs/<config>.json``: the configuration's shapes and source; its
  circuit's structure for the reference in ``configs/<config>.py`` and its
  committed set under the JSON's ``artifacts`` prefix, beside it;
- ``traffic/<traffic>.json``: the mix's parameters, read by ``traffic.py``;
- ``entries/<entry>.py``: how a mix's ``entry`` drives the port;
- ``metrics/<metric>.py``: each metric's reader, layer, unit and ``moves``.

A later change adds a cell, a mix or a metric by adding files and entries."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load_module(path: Path, name: str) -> ModuleType:
    """A benchmark file loaded as a module of its own (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_file_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads(BENCHMARK.read_text())


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # configs/<config>.json, as read
    traffic: dict       # traffic/<traffic>.json, as read
    metrics: list       # [(BENCHMARK.json entry, module)] of the run's metrics

    @property
    def artifacts(self) -> Path:
        return HERE / "configs" / self.config["artifacts"]

    def circuit(self) -> ModuleType:
        return load_module(HERE / "configs" / f"{self.config['name']}.py", self.config["name"])

    def entry(self) -> ModuleType:
        return load_module(HERE / "entries" / f"{self.traffic['entry']}.py", self.traffic["entry"])


def metric_module(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py", name)


def cell(name: str, trace: bool, bench: dict | None = None) -> Cell:
    """The cell `name` and the metrics its run reads: the end-to-end
    metrics with trace off, the per-layer ones with trace on, each that
    lists no ``workloads`` or lists this cell. A metric whose reader finds
    nothing to read in a cell returns None there, and the run leaves it
    out."""
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in {BENCHMARK.name}")
    w = found[0]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    group = bench["per_layer"] if trace else bench["end_to_end"]
    metrics = [(m, metric_module(m["name"])) for m in group if name in m.get("workloads", [name])]
    return Cell(name, int(w["chips"]), config, traffic, metrics)
