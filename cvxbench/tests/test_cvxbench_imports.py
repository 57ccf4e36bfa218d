"""What the harness and the references load, checked in fresh
processes: never JAX nor the JAX package (top-level names compared
whole: the program's name begins with the JAX package's), and for the
references nothing of the program either."""

import subprocess
import sys

from cvxbench.spec import ROOT

PROBE = """
import sys
{imports}
top = {{name.split(".")[0] for name in sys.modules}}
print(sorted(top & {{"jax", "jaxlib", "flax", "cvxpylayers_tpu",
                    "cvxpylayers_tpu_torch"}}))
"""


def _loaded(imports):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(imports=imports)],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_harness_loads_no_jax():
    loaded = _loaded(
        "import cvxbench.run, cvxbench.check, cvxbench.trace, "
        "cvxbench.launches, cvxbench.control, cvxbench.roofline\n"
        "from cvxbench.spec import load_cell, metric_module\n"
        "import json\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "for w in b['workloads']:\n"
        "    c = load_cell(w['name'])\n"
        "    c.config_module(); c.reference_module(); c.kind_module()\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    metric_module(m['name'])\n"
        "import cvxpylayers_tpu_torch, cvxpylayers_tpu_torch.dist\n")
    assert loaded == ["cvxpylayers_tpu_torch"]


def test_references_load_nothing_of_the_program():
    loaded = _loaded(
        "import cvxbench.reference.optnet_box_qp, "
        "cvxbench.reference.markowitz_socp")
    assert loaded == []
