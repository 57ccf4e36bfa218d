"""Recording what the program's kernels were launched with, during the
profiled steps of a traced run.

A per-layer metric that needs it (a kernel's roofline needs the shapes
its launches worked on) defines, in its own file,

    def recording(record: list):  # a context manager

and `run.py` enters it around the profiled steps for every per-layer
metric of the cell that has one; `read(run)` then finds the list as
`run.launches[<metric name>]`. `wrapped` below is the usual way to
write one: it wraps a function of the program, typically the argument
check that each launch of a kernel passes through, so that `record` sees
each call's arguments after the function has run. Reads only; where the
function is not there, nothing is recorded and the metric reads nothing.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable


@contextlib.contextmanager
def wrapped(module: str, attr: str, record: Callable):
    """Within the block, `module.attr(*a, **kw)` also calls
    `record(*a, **kw)` after it returns."""
    mod = importlib.import_module(module)
    inner = getattr(mod, attr, None)
    if inner is None:
        yield
        return

    def call(*a, **kw):
        out = inner(*a, **kw)
        record(*a, **kw)
        return out

    setattr(mod, attr, call)
    try:
        yield
    finally:
        setattr(mod, attr, inner)
