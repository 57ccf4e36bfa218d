"""The roofline arithmetic matches chip_smoke.py's at PERF.md's shapes."""

import pytest

from cvxbench.roofline import epoch_bound_ms, qr_bound_ms


def test_k1_epoch_bound_at_the_box_qp_shape():
    ms, by = epoch_bound_ms(1024, 50, 120, 50, 4)
    assert ms == pytest.approx(0.0234, rel=2e-3)
    assert by == "operations"


def test_k2_qr_bound_at_the_ipm_shape():
    ms, by = qr_bound_ms(1024, 170, 50, 4)
    assert ms == pytest.approx(0.01345, rel=2e-3)
    assert by == "bytes"


def test_k2_qr_bound_at_the_markowitz_ipm_shape():
    ms, _ = qr_bound_ms(512, 113, 51, 4)
    assert ms == pytest.approx(0.00511, rel=5e-3)


@pytest.mark.parametrize("metric", ["k1_roofline", "k2_roofline"])
def test_roofline_metrics_record_their_own_launches(metric):
    """Each roofline metric brings its own recording hook (launches.py):
    it wraps its kernel's argument check for the block and restores it."""
    import importlib

    from cvxbench.spec import metric_module

    mod = metric_module(metric)
    target = {"k1_roofline": "cvxpylayers_tpu_torch.solver.cuda_admm",
              "k2_roofline": "cvxpylayers_tpu_torch.solver.cuda_linalg"}
    kernel = importlib.import_module(target[metric])
    before = kernel._check
    shapes = []
    with mod.recording(shapes):
        assert kernel._check is not before
    assert kernel._check is before and shapes == []


def test_wrapped_records_each_call_after_it_returns():
    import math

    from cvxbench.launches import wrapped

    seen = []
    with wrapped("math", "hypot", lambda *a: seen.append(a)):
        assert math.hypot(3.0, 4.0) == 5.0
    assert seen == [(3.0, 4.0)]
    assert math.hypot(6.0, 8.0) == 10.0 and len(seen) == 1
