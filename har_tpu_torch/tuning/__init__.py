"""Hyperparameter tuning: k-fold cross-validation + parameter grids."""

from har_tpu_torch.tuning.cross_validator import (
    CrossValidator,
    CrossValidatorModel,
    kfold_indices,
    param_grid,
)

__all__ = [
    "CrossValidator",
    "CrossValidatorModel",
    "kfold_indices",
    "param_grid",
]
