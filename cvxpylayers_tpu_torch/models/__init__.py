from .zoo import (
    box_qp,
    csoftmax,
    csparsemax,
    ellipsoid_projection,
    lml,
    logistic_regression_layer,
    markowitz,
    relu,
    sigmoid,
    softmax,
    sparsemax,
)

__all__ = [
    "box_qp",
    "csoftmax",
    "csparsemax",
    "ellipsoid_projection",
    "lml",
    "logistic_regression_layer",
    "markowitz",
    "relu",
    "sigmoid",
    "softmax",
    "sparsemax",
]
