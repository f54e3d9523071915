"""Typed configuration for the framework.

The reference hardcodes every hyperparameter as a literal inside the script
(reference Main/main.py:20,80,115,202-207,297,478) and takes only the Spark
master URL from the CLI. Here the whole run is described by dataclasses that
the `har` CLI fills from flags.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Sequence

# The WISDM transformed CSV is not shipped with the repository.  Its
# location comes from HAR_TPU_WISDM_CSV (the variable the JAX package reads
# too); without it the tabular dataset falls back to the synthetic
# generator (har_tpu_torch.data.synthetic) so the port is self-contained.
WISDM_CSV_ENV = "HAR_TPU_WISDM_CSV"


def default_wisdm_path() -> str | None:
    path = os.environ.get(WISDM_CSV_ENV)
    return path if path and os.path.exists(path) else None


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset + split configuration (reference Main/main.py:16-26,80)."""

    dataset: str = "wisdm"  # wisdm | wisdm_raw | ucihar | synthetic
    path: str | None = None
    # Columns dropped by the reference: USER + the 30 histogram-bin columns.
    drop_binned: bool = True
    train_fraction: float = 0.7
    seed: int = 2018
    # How train/test membership is drawn.  "spark" replays the reference's
    # randomSplit bit-for-bit (XORShiftRandom + vector-struct sort; see
    # har_tpu_torch.data.spark_split) — 3,793/1,625 rows for seed 2018, row-exact
    # vs result.txt:105-131.  "bernoulli" is the plain NumPy draw.  "auto"
    # picks spark for the tabular WISDM dataset, bernoulli elsewhere.
    split_method: str = "auto"  # auto | spark | bernoulli
    # Row count for synthetic fallbacks (None → dataset-matching defaults:
    # 5418 tabular rows / 4000 raw windows / 2000 UCI rows); tests shrink
    # it to keep CPU runs fast.
    synthetic_rows: int | None = None

    def resolved_path(self) -> str | None:
        if self.path is not None:
            return self.path
        if self.dataset == "wisdm":
            return default_wisdm_path()
        return None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model selection + hyperparameters.

    Defaults mirror the reference estimators:
      - LR:   maxIter=20, regParam=0.3, elasticNetParam=0   (main.py:115)
      - DT:   maxDepth=3                                    (main.py:297)
      - RF:   numTrees=100, maxDepth=4, maxBins=32          (main.py:478)
    """

    name: str = "logistic_regression"
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 512
    epochs: int = 50
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    dtype: str = "bfloat16"  # compute dtype for neural models
    seed: int = 0
    checkpoint_dir: str | None = None
    log_every: int = 100


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for SPMD execution.

    Axis names follow the scaling-book convention: `dp` shards the batch,
    `tp` shards model (feature/hidden) dimensions.  The classical workloads
    use pure DP; neural configs may use both.  Default is single-device;
    pass dp=-1 (or `har train --dp -1`) to spread over all devices.
    """

    dp: int = 1  # -1 → all available devices
    tp: int = 1

    def shape(self, n_devices: int) -> tuple[int, int]:
        if self.dp == 0 or self.dp < -1:
            raise ValueError(
                f"dp={self.dp} is invalid: use a positive device count or "
                "-1 for all available devices"
            )
        if self.tp < 1:
            raise ValueError(f"tp={self.tp} must be >= 1")
        dp = self.dp if self.dp > 0 else max(1, n_devices // self.tp)
        return dp, self.tp


@dataclasses.dataclass(frozen=True)
class TuningConfig:
    """Cross-validation / grid-search (reference Main/main.py:202-212)."""

    num_folds: int = 5
    # Metric used to pick the best grid point.  The reference silently uses
    # the *MAE* RegressionEvaluator for model selection (SURVEY §2 N quirk);
    # we default to accuracy and expose `mae` to replicate the quirk.
    selection_metric: str = "accuracy"
    grid: Mapping[str, Sequence[Any]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    tuning: TuningConfig | None = None
    output_dir: str = "main_result"
