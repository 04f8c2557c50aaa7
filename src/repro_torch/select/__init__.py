"""Model selection over lambda grids.  Ported so far: the grid chokepoint
(``normalize_lambda_grid``) and ``lambda_max``; the criteria, the homotopy
path and ``select_path`` come with later slices."""

from repro_torch.select.grid import lambda_max, normalize_lambda_grid

__all__ = ["normalize_lambda_grid", "lambda_max"]
