"""PyTorch/CUDA port of exact covariance thresholding into connected
components for large-scale graphical lasso (arXiv:1108.3829).

``glasso(S, lam)`` screens |S_ij| > lam into connected components
(Theorem 1), plans size/structure buckets, solves each bucket on its rung
of the route ladder — the ``tree_glasso`` CUDA kernel for pairs and trees,
a host clique-tree solve for chordal blocks, the ``bucket_glasso`` CUDA
kernel (whole BCD solve per lane) for the rest, or ``solver="pg"`` (its
step the ``prox_l1`` kernel) or ``solver="admm"`` (its Z/U tail the
``shard_prox`` kernel) — and assembles a dense Theta.  Components above
``oversize_threshold`` take the sharded route: a matmul-only ADMM on the
card, its prox tail the same ``shard_prox`` kernel.  It runs on the card
by default; ``EngineOptions(device="cpu")`` runs the plain-PyTorch
versions of the kernels instead.
``glasso_path(S, lams)`` solves a descending lambda grid from one
union-find pass with diffed plans and warm starts (``X=`` plans it from
one streamed screen), and ``repro_torch.select.select_path`` picks lambda
along it by EBIC, k-fold CV or StARS.
``repro_torch.joint.joint_glasso`` solves the joint K-class problem the
same way, its ADMM Z-update on the ``joint_prox`` CUDA kernel.

The package imports ``torch``, ``numpy`` and ``scipy`` only.
"""

from repro_torch.core.glasso import glasso, glasso_path
from repro_torch.engine.api import Engine, GlassoResult
from repro_torch.engine.options import EngineOptions

__all__ = ["glasso", "glasso_path", "Engine", "GlassoResult", "EngineOptions"]
