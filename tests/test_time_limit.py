"""The per-test time limit of the root conftest.py, driven directly at 1 s.

Each test first takes down the alarm that the root conftest arms around it,
so that what it reads is the helper's alarm alone, and re-arms it at the end.
"""

import contextlib
import importlib.util
import pathlib
import signal
import time

import pytest

_spec = importlib.util.spec_from_file_location(
    "root_conftest", pathlib.Path(__file__).parents[1] / "conftest.py")
_root_conftest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_root_conftest)
time_limit = _root_conftest.time_limit


@contextlib.contextmanager
def no_outer_alarm():
    left = signal.alarm(0)
    try:
        yield
    finally:
        signal.alarm(left)


def test_overrun_fails_with_the_limit_message():
    with no_outer_alarm():
        with pytest.raises(pytest.fail.Exception,
                           match="exceeded the 1 s per-test time limit"):
            with time_limit(1):
                time.sleep(5)
        assert signal.alarm(0) == 0


def test_no_alarm_left_after_a_passing_body():
    with no_outer_alarm():
        with time_limit(1):
            pass
        assert signal.alarm(0) == 0
