"""Settings for the whole test run, loaded before tests/conftest.py.

OpenBLAS is pinned to one thread before anything loads numpy or scipy: each
xdist worker would otherwise start a pool as large as the machine, and the
pools of all the workers together oversubscribe the cores. An explicit
setting in the environment wins, and every subprocess of a test inherits it.

Every test's setup and its call each run under a limit of TIME_LIMIT_S
seconds. The limit is SIGALRM, so it cuts Python code and the waits that a
signal interrupts (sleeps, subprocess waits); a call that stays in native
code is cut only when it returns.
"""

import os

os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import contextlib
import signal

import pytest

TIME_LIMIT_S = 300


@contextlib.contextmanager
def time_limit(seconds):
    """Fail the body if it runs for more than `seconds` (a whole number).

    Only the main thread can arm it; elsewhere signal.signal raises.
    """

    def overrun(signum, frame):
        pytest.fail(f"exceeded the {seconds} s per-test time limit")

    handler = signal.signal(signal.SIGALRM, overrun)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, handler)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with time_limit(TIME_LIMIT_S):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with time_limit(TIME_LIMIT_S):
        yield
