"""Kernels and their plain versions, and the evaluation battery."""

from har_tpu_torch.ops.metrics import (
    classification_report,
    confusion_matrix,
    multiclass_metrics,
    binary_metrics,
    regression_metrics,
)

__all__ = [
    "classification_report",
    "confusion_matrix",
    "multiclass_metrics",
    "binary_metrics",
    "regression_metrics",
]
