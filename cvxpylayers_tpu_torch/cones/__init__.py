from .dims import ConeDims
from .jacobians import (
    make_cone_dproj_apply,
    make_cone_dproj_dense,
    make_cone_dproj_factored,
    make_cone_dproj_spectral,
)
from .projections import (
    make_cone_projector,
    make_dual_cone_projector,
    project_exp,
    project_nonneg,
    project_pow3,
    project_psd_svec,
    project_psd_svec_ns,
    project_soc,
    project_zero,
    svec_indices,
    svec_to_sym,
    sym_to_svec,
)

__all__ = [
    "ConeDims",
    "make_cone_dproj_apply",
    "make_cone_dproj_dense",
    "make_cone_dproj_factored",
    "make_cone_dproj_spectral",
    "make_cone_projector",
    "make_dual_cone_projector",
    "project_exp",
    "project_nonneg",
    "project_pow3",
    "project_psd_svec",
    "project_psd_svec_ns",
    "project_soc",
    "project_zero",
    "svec_indices",
    "svec_to_sym",
    "sym_to_svec",
]
