"""Covariance inputs: the sample estimators (torch, on the engine's device)
and the paper's synthetic generators."""

from repro_torch.covariance.estimators import (
    impute_missing,
    sample_correlation,
    sample_covariance,
    streaming_covariance,
)
from repro_torch.covariance.synthetic import (
    lambda_interval_for_k,
    microarray_like,
    paper_synthetic,
    structured_synthetic,
)

__all__ = [
    "sample_covariance",
    "sample_correlation",
    "streaming_covariance",
    "impute_missing",
    "paper_synthetic",
    "lambda_interval_for_k",
    "structured_synthetic",
    "microarray_like",
]
