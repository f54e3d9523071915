"""Hyperparameter tuning: k-fold cross-validation + parameter grids."""

from har_tpu_torch.tuning.cross_validator import (
    CrossValidator,
    CrossValidatorModel,
    kfold_indices,
    param_grid,
)
from har_tpu_torch.tuning.mllib_cv import (
    REFERENCE_GRID,
    MLlibCVResult,
    mllib_cross_validate,
)

__all__ = [
    "REFERENCE_GRID",
    "MLlibCVResult",
    "mllib_cross_validate",
    "CrossValidator",
    "CrossValidatorModel",
    "kfold_indices",
    "param_grid",
]
