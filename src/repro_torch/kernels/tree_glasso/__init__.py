from repro_torch.kernels.tree_glasso.ops import glasso_forest_stack
from repro_torch.kernels.tree_glasso.ref import glasso_forest_ref

__all__ = ["glasso_forest", "glasso_forest_stack", "glasso_forest_ref"]


def __getattr__(name):
    # glasso_forest, the single-block solve over the kernel, lives with the
    # other closed forms, which import this package: resolved on first use
    if name == "glasso_forest":
        from repro_torch.core.solvers.closed_form import glasso_forest

        return glasso_forest
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
