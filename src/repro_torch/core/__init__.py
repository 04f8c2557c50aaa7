"""Core of the port: exact covariance thresholding into connected
components (Mazumder & Hastie 2011) wrapped around batched PyTorch/CUDA
graphical-lasso solvers; the reference package's ``repro.core`` surface.
"""

from repro_torch.core.components import (
    canonicalize_labels,
    components_from_covariance_host,
    connected_components_host,
    connected_components_labelprop,
    is_refinement,
    partitions_equal,
    threshold_adjacency,
)
from repro_torch.core.glasso import EngineOptions, GlassoResult, glasso, glasso_path
from repro_torch.core.partition import (
    component_size_distribution,
    labels_at_thresholds,
    lambda_for_max_component,
    merge_profile,
)
from repro_torch.core.screening import thresholded_components
from repro_torch.core.solvers import SOLVERS, glasso_admm, glasso_bcd, glasso_pg, kkt_residual
from repro_torch.core.sparse import (
    AUTO_SPARSE_P,
    JointSparseTheta,
    SparseTheta,
    result_nbytes,
)

__all__ = [
    "glasso",
    "glasso_path",
    "GlassoResult",
    "EngineOptions",
    "thresholded_components",
    "threshold_adjacency",
    "connected_components_host",
    "connected_components_labelprop",
    "components_from_covariance_host",
    "canonicalize_labels",
    "partitions_equal",
    "is_refinement",
    "merge_profile",
    "labels_at_thresholds",
    "lambda_for_max_component",
    "component_size_distribution",
    "SOLVERS",
    "glasso_bcd",
    "glasso_pg",
    "glasso_admm",
    "kkt_residual",
    "AUTO_SPARSE_P",
    "SparseTheta",
    "JointSparseTheta",
    "result_nbytes",
]
