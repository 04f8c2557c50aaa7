"""Covariance inputs: the sample estimators (torch, on the engine's device)
and the paper's synthetic generators."""

from repro_torch.covariance.estimators import sample_correlation, sample_covariance
from repro_torch.covariance.synthetic import (
    lambda_interval_for_k,
    paper_synthetic,
    structured_synthetic,
)

__all__ = [
    "sample_covariance",
    "sample_correlation",
    "paper_synthetic",
    "lambda_interval_for_k",
    "structured_synthetic",
]
