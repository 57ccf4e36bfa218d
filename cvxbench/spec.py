"""Find every piece of a cell by the names in BENCHMARK.json.

A cell names a configuration and a traffic mix. The configuration is
`configs/<config>.json` (sizes and solver settings, as run) beside
`configs/<config>.py` (the layer and the instance generator) and
`reference/<config>.py` (the plain reference). The mix is
`traffic/<traffic>.json`, whose `kind` names the loop in
`traffic/<kind>.py`. The cell's correctness limits are
`cells/<cell>.json`. A per-layer metric is `metrics/<metric>.py`. Each
is loaded from its file, so a name may hold dots, and a new piece is a
new file plus new entries in BENCHMARK.json.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path, name: str) -> ModuleType:
    """The module at `path`, imported once under `name`."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of `workloads`, with everything it names."""

    name: str
    chips: int
    config: dict          # configs/<config>.json, plus its BENCHMARK entry
    mix: dict             # traffic/<traffic>.json
    limits: dict          # cells/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    def config_module(self) -> ModuleType:
        name = self.config["name"]
        return load_module(HERE / "configs" / f"{name}.py",
                           f"cvxbench_config_{name}")

    def reference_module(self) -> ModuleType:
        name = self.config["name"]
        return load_module(HERE / "reference" / f"{name}.py",
                           f"cvxbench_reference_{name}")

    def kind_module(self) -> ModuleType:
        kind = self.mix["kind"]
        return load_module(HERE / "traffic" / f"{kind}.py",
                           f"cvxbench_traffic_{kind}")


def metric_module(name: str) -> ModuleType:
    return load_module(HERE / "metrics" / f"{name}.py",
                       f"cvxbench_metric_{name}")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = read_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}; known: "
                       f"{sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = dict(read_json(ROOT / entry["file"]), name=entry["name"],
                  source=entry["source"], reduced=entry["reduced"])
    mix = dict(read_json(HERE / "traffic" / f"{w['traffic']}.json"),
               name=w["traffic"])
    limits = read_json(HERE / "cells" / f"{name}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config, mix=mix,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )
