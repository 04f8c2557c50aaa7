"""Covariance inputs: the paper's synthetic generators."""

from repro_torch.covariance.synthetic import (
    lambda_interval_for_k,
    paper_synthetic,
    structured_synthetic,
)

__all__ = ["paper_synthetic", "lambda_interval_for_k", "structured_synthetic"]
