"""Prebuilt differentiable optimization layers.

Counterpart of cvxpylayers_tpu/models/zoo.py: the same eleven factories,
each returning a ready CvxpyLayer of this package. Every factory takes
`device` and passes it to CvxpyLayer, so the layer builds on the card by
default and on the CPU when the caller asks for it (`device="cpu"`).
"""

from __future__ import annotations

from .. import expressions as ex
from ..expressions import (
    Maximize,
    Minimize,
    Parameter,
    Problem,
    Variable,
)
from ..layer import CvxpyLayer


def relu(n: int, device=None) -> CvxpyLayer:
    """ReLU as argmin ||x - y||^2 s.t. y >= 0 (reference test_mlx.py:669)."""
    x = Parameter(n)
    y = Variable(n, nonneg=True)
    prob = Problem(Minimize(ex.sum_squares(x - y)))
    return CvxpyLayer(prob, parameters=[x], variables=[y],
                      device=device)


def sigmoid(n: int, device=None) -> CvxpyLayer:
    """Sigmoid via entropy regularization:
    argmax x'y + sum(entr(y) + entr(1-y)), 0 <= y <= 1."""
    x = Parameter(n)
    y = Variable(n)
    obj = x @ y + ex.sum(ex.entr(y)) + ex.sum(ex.entr(1.0 - y))
    prob = Problem(Maximize(obj))
    return CvxpyLayer(prob, parameters=[x], variables=[y],
                      device=device)


def softmax(n: int, device=None) -> CvxpyLayer:
    """Softmax as argmax x'y + sum entr(y) s.t. sum y == 1, y >= 0."""
    x = Parameter(n)
    y = Variable(n, nonneg=True)
    prob = Problem(
        Maximize(x @ y + ex.sum(ex.entr(y))), [ex.sum(y) == 1]
    )
    return CvxpyLayer(prob, parameters=[x], variables=[y],
                      device=device)


def sparsemax(n: int, device=None) -> CvxpyLayer:
    """Sparsemax: Euclidean projection onto the simplex
    (Martins & Astudillo 2016; reference test_mlx.py zoo)."""
    x = Parameter(n)
    y = Variable(n, nonneg=True)
    prob = Problem(
        Minimize(ex.sum_squares(y - x)), [ex.sum(y) == 1]
    )
    return CvxpyLayer(prob, parameters=[x], variables=[y],
                      device=device)


def csoftmax(n: int, u: float = 1.0, device=None) -> CvxpyLayer:
    """Constrained softmax: softmax with per-coordinate cap y <= u."""
    x = Parameter(n)
    y = Variable(n, nonneg=True)
    prob = Problem(
        Maximize(x @ y + ex.sum(ex.entr(y))),
        [ex.sum(y) == 1, y <= float(u)],
    )
    return CvxpyLayer(prob, parameters=[x], variables=[y],
                      device=device)


def csparsemax(n: int, u: float = 1.0, device=None) -> CvxpyLayer:
    """Constrained sparsemax: simplex projection with caps y <= u."""
    x = Parameter(n)
    y = Variable(n, nonneg=True)
    prob = Problem(
        Minimize(ex.sum_squares(y - x)),
        [ex.sum(y) == 1, y <= float(u)],
    )
    return CvxpyLayer(prob, parameters=[x], variables=[y],
                      device=device)


def lml(n: int, k: int, device=None) -> CvxpyLayer:
    """Limited multi-label projection layer (Amos et al. 2019):
    argmax x'y + sum entr(y) + sum entr(1-y) s.t. sum y == k, 0 <= y <= 1."""
    x = Parameter(n)
    y = Variable(n)
    obj = x @ y + ex.sum(ex.entr(y)) + ex.sum(ex.entr(1.0 - y))
    prob = Problem(Maximize(obj), [ex.sum(y) == float(k)])
    return CvxpyLayer(prob, parameters=[x], variables=[y],
                      device=device)


def box_qp(n: int, m_ineq: int, device=None) -> CvxpyLayer:
    """OptNet-style box QP: argmin ||y - x||^2 s.t. Gy <= h, 0 <= y <= 1
    (reference tests/test_torch.py:958-975)."""
    x = Parameter(n)
    G = Parameter((m_ineq, n))
    h = Parameter(m_ineq)
    y = Variable(n)
    prob = Problem(
        Minimize(ex.sum_squares(y - x)),
        [G @ y <= h, y >= 0, y <= 1],
    )
    return CvxpyLayer(prob, parameters=[x, G, h], variables=[y],
                      device=device)


def ellipsoid_projection(n: int, device=None) -> CvxpyLayer:
    """Project onto {y : ||A y + b|| <= 1} for fixed A (param x projected)."""
    x = Parameter(n)
    A = Parameter((n, n))
    b = Parameter(n)
    y = Variable(n)
    prob = Problem(
        Minimize(ex.sum_squares(y - x)),
        [ex.norm(A @ y + b, 2) <= 1.0],
    )
    return CvxpyLayer(prob, parameters=[x, A, b], variables=[y],
                      device=device)


def markowitz(n: int, gamma: float = 1.0, device=None) -> CvxpyLayer:
    """Long-only Markowitz portfolio with parametric returns and factor
    loadings: argmax mu'w - gamma ||F w||^2 s.t. sum w == 1, w >= 0
    (BASELINE.json config 3 shape class)."""
    mu = Parameter(n)
    F = Parameter((n, n))
    w = Variable(n, nonneg=True)
    prob = Problem(
        Maximize(mu @ w - float(gamma) * ex.sum_squares(F @ w)),
        [ex.sum(w) == 1],
    )
    return CvxpyLayer(prob, parameters=[mu, F], variables=[w],
                      device=device)


def logistic_regression_layer(n_features: int, n_samples: int,
                              reg: float = 1e-2, device=None) -> CvxpyLayer:
    """Differentiable logistic regression fit: argmin_beta
    sum logistic(-y_i * (X beta)_i) + reg ||beta||^2, with X*y rows as the
    parameter (exp-cone path; reference tests/test_torch.py:158-187)."""
    Xy = Parameter((n_samples, n_features))  # rows premultiplied by -y_i
    beta = Variable(n_features)
    obj = ex.sum(ex.logistic(Xy @ beta)) + float(reg) * ex.sum_squares(beta)
    prob = Problem(Minimize(obj))
    return CvxpyLayer(prob, parameters=[Xy], variables=[beta],
                      device=device)
