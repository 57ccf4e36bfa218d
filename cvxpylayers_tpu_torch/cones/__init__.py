from .dims import ConeDims
from .jacobians import (
    make_cone_dproj_apply,
    make_cone_dproj_dense,
    make_cone_dproj_factored,
)
from .projections import (
    make_cone_projector,
    project_nonneg,
    project_zero,
    svec_indices,
    svec_to_sym,
)

__all__ = [
    "ConeDims",
    "make_cone_dproj_apply",
    "make_cone_dproj_dense",
    "make_cone_dproj_factored",
    "make_cone_projector",
    "project_nonneg",
    "project_zero",
    "svec_indices",
    "svec_to_sym",
]
