"""k1_roofline: K1's share of its roofline, in percent: the epoch
bound (roofline.epoch_bound_ms) at the shapes K1 was launched with in
the profiled steps, over K1's device time in those steps (profiled
events whose names hold K1's symbols). The shapes come from the
argument check that every K1 launch passes through
(`solver/cuda_admm._check`)."""

from cvxbench.launches import wrapped
from cvxbench.roofline import K1_SYMBOLS, epoch_bound_ms


def recording(shapes: list):
    def record(minv, A, q, b, rho, x, z, y, n_zero, iters):
        if q.is_cuda and q.shape[0]:
            shapes.append((q.shape[0], q.shape[1], b.shape[1], iters,
                           q.element_size()))

    return wrapped("cvxpylayers_tpu_torch.solver.cuda_admm", "_check",
                   record)


def read(run):
    p = run.profile
    shapes = run.launches.get("k1_roofline")
    if not p or not shapes:
        return None
    secs, count = p.kernel_stats(K1_SYMBOLS)
    if not count or count != len(shapes):
        return None
    bound_ms = sum(epoch_bound_ms(*s)[0] for s in shapes)
    return 100.0 * bound_ms / (secs * 1e3)
