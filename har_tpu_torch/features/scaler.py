"""Feature standardization (the analogue of MLlib's StandardScaler).

Port of ``har_tpu/features/scaler.py`` (numpy, copied).  The neural
families standardize their inputs over axis 0: for raw (n, T, 3) windows
that is one mean and standard deviation per (step, axis).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StandardScaler:
    """fit → (mean, std); transform → (x - mean) / std, zero-variance
    columns pass through centered."""

    with_mean: bool = True
    with_std: bool = True

    def fit(self, x: np.ndarray) -> "FittedScaler":
        x = np.asarray(x, np.float32)
        mean = x.mean(axis=0) if self.with_mean else np.zeros(x.shape[1], np.float32)
        if self.with_std:
            std = x.std(axis=0, ddof=1)
            std = np.where(std > 0, std, 1.0).astype(np.float32)
        else:
            std = np.ones(x.shape[1], np.float32)
        return FittedScaler(mean=mean.astype(np.float32), std=std)


@dataclasses.dataclass(frozen=True)
class FittedScaler:
    mean: np.ndarray
    std: np.ndarray

    def transform(self, x: np.ndarray) -> np.ndarray:
        return ((np.asarray(x, np.float32) - self.mean) / self.std).astype(
            np.float32
        )
