"""BENCHMARK.json against the benchmark's contract, and every piece it
names found by name."""

import json
import re

import pytest

from cvxbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in METRICS]
    for n in names:
        assert NAME.match(n), n
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    lines = [c[k] for c in BENCH["configs"] for k in ("source", "why")]
    lines += [w["why"] for w in BENCH["workloads"]]
    lines += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    for line in lines:
        assert 1 <= len(line) <= 200 and not set(line) & {"\n", "\t"}, line
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_every_cell_reports_what_it_must():
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(CELLS)
    for name in CELLS:
        cell = spec.load_cell(name)
        assert cell.chips == 1
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_pieces_load_by_name(name):
    cell = spec.load_cell(name)
    cm = cell.config_module()
    for fn in ("build_layer", "instances", "output_shapes", "optimality"):
        assert callable(getattr(cm, fn))
    assert callable(cell.reference_module().solve_and_grad)
    assert hasattr(cell.kind_module(), "Workload")
    assert cell.limits["limits"]
    for key in ("kept_steps", "warm_steps", "profile_steps"):
        assert int(cell.mix[key]) > 0


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_readers_load_by_name(metric):
    assert callable(spec.metric_module(metric).read)


def test_config_files_hold_what_is_run():
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert c["reduced"] == []
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False
        assert cfg["solver_args"]
