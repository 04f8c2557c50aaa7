from repro_torch.kernels.tree_glasso.ops import glasso_forest_stack
from repro_torch.kernels.tree_glasso.ref import glasso_forest_ref

__all__ = ["glasso_forest_stack", "glasso_forest_ref"]
