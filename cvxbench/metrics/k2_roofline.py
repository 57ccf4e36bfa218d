"""k2_roofline: K2's share of its roofline, in percent: the QR bound
(roofline.qr_bound_ms) at the shapes K2 was launched with in the
profiled steps, over K2's device time in those steps (profiled events
whose names hold house_qr_r_kernel). The shapes come from the argument
check that every K2 launch passes through (`solver/cuda_linalg._check`)."""

from cvxbench.launches import wrapped
from cvxbench.roofline import K2_SYMBOLS, qr_bound_ms


def recording(shapes: list):
    def record(M):
        B, m, n = M.shape
        if M.is_cuda and B and n:
            shapes.append((B, m, n, M.element_size()))

    return wrapped("cvxpylayers_tpu_torch.solver.cuda_linalg", "_check",
                   record)


def read(run):
    p = run.profile
    shapes = run.launches.get("k2_roofline")
    if not p or not shapes:
        return None
    secs, count = p.kernel_stats(K2_SYMBOLS)
    if not count or count != len(shapes):
        return None
    bound_ms = sum(qr_bound_ms(*s)[0] for s in shapes)
    return 100.0 * bound_ms / (secs * 1e3)
