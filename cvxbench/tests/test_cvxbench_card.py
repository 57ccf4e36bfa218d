"""On the card: one short run of each cell through BENCHMARK.json's
command, its last line the result object. Skips without a GPU.
Without one, the command prints no result and exits non-zero."""

import json
import shutil
import subprocess
import sys

import pytest

from cvxbench.spec import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _run(cwd, cell, seconds=2, trace=0, timeout=400):
    return subprocess.run(
        BENCH["command"] + ["--workload", cell, "--seed", str(2 ** 31 + 5),
                            "--seconds", str(seconds), "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=timeout)


def test_without_a_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT, BENCH["workloads"][0]["name"])
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, BENCH["workloads"][0]["name"])
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_card(card, cell, trace):
    out = _run(ROOT, cell, seconds=3, trace=trace)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]
    if trace:
        assert res["device"]["busy_s"] > 0
    assert sys.modules.get("jax") is None
