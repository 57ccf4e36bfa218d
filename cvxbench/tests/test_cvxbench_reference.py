"""The plain references against closed forms and against central
differences of their own solves, and the TF32 rounding."""

import torch

from cvxbench import spec
from cvxbench.reference import markowitz_socp as mk
from cvxbench.reference import optnet_box_qp as qp
from cvxbench.reference.numerics import mm, tf32_round


def _box(seed, B=8, n=50, m=20):
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(B, n, generator=g, dtype=torch.float64)
    G = 0.3 * torch.randn(B, m, n, generator=g, dtype=torch.float64)
    h = torch.randn(B, m, generator=g, dtype=torch.float64).abs() + 1.0
    return v, G, h


def _portfolio(seed, B=8, n=50, k=10):
    g = torch.Generator().manual_seed(seed)
    mu = 0.1 * torch.randn(B, n, generator=g, dtype=torch.float64)
    F = torch.randn(B, k, n, generator=g, dtype=torch.float64) / n ** 0.5
    return mu, F


def test_box_qp_with_inactive_rows_is_a_clip():
    v, G, h = _box(1)
    y, lam, ok = qp.solve(v, G, h + 1e3)
    assert ok.all()
    assert torch.allclose(y, v.clamp(0.0, 1.0), atol=1e-12)
    assert (lam[:, :20] == 0).all()


def test_box_qp_solution_is_optimal():
    v, G, h = _box(2, B=16)
    y, lam, ok = qp.solve(v, G, h)
    assert ok.all()
    A, b = qp.stacked(G, h)
    Ay = (A @ y.unsqueeze(-1)).squeeze(-1)
    assert (Ay - b).max() < 1e-10 and (lam >= 0).all()
    stat = 2 * (y - v) + (A.transpose(1, 2) @ lam.unsqueeze(-1)).squeeze(-1)
    assert stat.abs().max() < 1e-9
    assert (lam * (Ay - b)).abs().max() < 1e-9


def test_box_qp_gradient_against_central_differences():
    v, G, h = _box(3, B=4)
    g = torch.Generator().manual_seed(4)
    ybar = torch.randn(4, 50, generator=g, dtype=torch.float64)
    y, lam, _ = qp.solve(v, G, h)
    dv, dG, dh = qp.vjp(v, G, h, y, lam, ybar)
    eps = 1e-6
    for t, grad in ((v, dv), (G, dG), (h, dh)):
        d = torch.randn(t.shape, generator=g, dtype=torch.float64)
        plus = [x + eps * d if x is t else x for x in (v, G, h)]
        minus = [x - eps * d if x is t else x for x in (v, G, h)]
        fd = ((qp.solve(*plus)[0] - qp.solve(*minus)[0]) * ybar).sum(-1)
        fd = fd / (2 * eps)
        an = (grad * d).flatten(1).sum(-1)
        assert torch.allclose(fd, an, rtol=1e-5, atol=1e-7), (fd, an)


def test_portfolio_with_a_loose_budget_holds_the_best_asset():
    mu, F = _portfolio(5)
    w, lam, nu, gamma, ok = mk.solve(mu, F, 100.0)
    assert ok.all()
    best = torch.nn.functional.one_hot(mu.argmax(-1), 50).double()
    assert torch.allclose(w, best, atol=1e-9)
    dmu, dF = mk.vjp(mu, F, 100.0, w, lam, nu, gamma,
                     torch.randn(8, 50, dtype=torch.float64))
    assert dmu.abs().max() < 1e-9 and dF.abs().max() < 1e-9


def test_portfolio_solution_is_optimal():
    mu, F = _portfolio(6, B=16)
    w, lam, nu, gamma, ok = mk.solve(mu, F, 0.25)
    assert ok.all()
    risk = (F @ w.unsqueeze(-1)).squeeze(-1).norm(dim=-1)
    assert (risk <= 0.25 + 1e-12).all() and (w >= 0).all()
    assert (w.sum(-1) - 1).abs().max() < 1e-12
    FtFw = (F.transpose(1, 2) @ (F @ w.unsqueeze(-1))).squeeze(-1)
    stat = -mu - lam + 2 * nu[:, None] * FtFw + gamma[:, None]
    assert stat.abs().max() < 1e-9


def test_portfolio_gradient_against_central_differences():
    mu, F = _portfolio(7, B=4)
    g = torch.Generator().manual_seed(8)
    wbar = torch.randn(4, 50, generator=g, dtype=torch.float64)
    w, lam, nu, gamma, _ = mk.solve(mu, F, 0.25)
    dmu, dF = mk.vjp(mu, F, 0.25, w, lam, nu, gamma, wbar)
    eps = 1e-7
    for t, grad in ((mu, dmu), (F, dF)):
        d = torch.randn(t.shape, generator=g, dtype=torch.float64)
        plus = [x + eps * d if x is t else x for x in (mu, F)]
        minus = [x - eps * d if x is t else x for x in (mu, F)]
        fd = ((mk.solve(*plus, 0.25)[0] - mk.solve(*minus, 0.25)[0])
              * wbar).sum(-1) / (2 * eps)
        an = (grad * d).flatten(1).sum(-1)
        assert torch.allclose(fd, an, rtol=1e-4, atol=1e-6), (fd, an)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -12, 3.14159265],
                     dtype=torch.float32)
    r = tf32_round(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10 and r[2] == 1.0
    assert abs(float(r[3]) - 3.14159265) < 2 ** -10 * 2
    a = torch.randn(64, 64)
    b = torch.randn(64, 64)
    full, low = mm(a, b, "float32"), mm(a, b, "tf32")
    err = (low - full).abs().max() / full.abs().max()
    assert 1e-5 < err < 1e-2


def test_reference_entry_takes_the_config():
    cell = spec.load_cell("markowitz.rescue_train")
    mu, F = _portfolio(9, B=4)
    outs, grads, ok = cell.reference_module().solve_and_grad(
        [mu, F], None, cell.config)
    assert grads is None and ok.all() and outs[0].shape == (4, 50)
