"""The reference-exact pipeline: reproduce result.txt block for block.

The reference's committed result.txt (Main/wisdm_main_ver_0.0/main_result/)
is the notebook-variant run: a prefix (schema → EDA → pipeline → split
tables), then four model blocks — LR, LR-CV (the MAE-quirk
CrossValidator), DT, RF — each with the prediction-sample filter the
script hardcodes (prediction == 5 for LR, == 0 for the others;
Main/main.py:127,223,309,490).

``parity_run`` drives the bit-exact MLlib replays through that sequence
and writes the same artifacts as ``har_tpu.parity.parity_run``:

- LR: the Breeze L-BFGS replay (models/mllib_lr.py), on the host;
- LR-CV: the MAE-quirk CrossValidator replay (tuning/mllib_cv.py), on the
  host;
- DT: the tree grown on ``device``, each level through kernel K1
  (``ops/hist.py::hist_rows``);
- RF: the Well19937c bagging replay (models/mllib_rf.py), on the host.

The replays stay in numpy and C++ because their bit-exactness rests on the
JVM's order of double-precision operations.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

from har_tpu_torch.config import DataConfig, RunConfig
from har_tpu_torch.device import resolve_device
from har_tpu_torch.ops.metrics import evaluate
from har_tpu_torch.reporting import ModelResult, ReportWriter

BLOCKS = ("lr", "lr_cv", "dt", "rf")


def write_reference_prefix(report, table, train, test, pipe) -> None:
    """Lines 1-139 of result.txt: schema → samples → class counts →
    describe → pipeline schema → feature sample → split counts/tables."""
    report.line("Loading Data Set...")
    report.schema(table)
    report.sample(table)
    report.class_counts(table["ACTIVITY"])
    report.summary(table)
    report.pipeline_schema(table)
    cols = pipe.transform(table)
    feats = np.asarray(cols["features"], np.float32)
    labels = np.asarray(cols["label"], np.float64)
    report.sample_feature_data(table, labels, feats)
    report.split_counts(len(train), len(test))
    report.split_sample_tables(table, feats, labels, train.rows, test.rows)


def parity_run(
    output_dir: str,
    config: RunConfig | None = None,
    blocks: Sequence[str] = BLOCKS,
    device: str | torch.device = "cuda",
) -> dict:
    """Run the reference-exact pipeline; returns the block accuracies and
    the artifact paths.  ``device`` is where DT grows (the replays run on
    the host); a missing GPU raises unless ``device="cpu"``."""
    from har_tpu_torch.models.mllib_exact import (
        CrossValidatorExact,
        LogisticRegressionExact,
        RandomForestExact,
    )
    from har_tpu_torch.models.tree import DecisionTreeClassifier
    from har_tpu_torch.runner import _spark_display_name, featurize, load_dataset

    device = resolve_device(device)
    config = config or RunConfig(data=DataConfig(dataset="wisdm"))
    config = dataclasses.replace(config, output_dir=output_dir)
    table = load_dataset(config)
    train, test, pipe = featurize(config, table)
    report = ReportWriter(
        output_dir,
        class_names=list(train.class_names) if train.class_names else None,
        reference_quirks=True,
    )
    write_reference_prefix(report, table, train, test, pipe)

    # (job name, estimator, reference sample filter class, is_cv)
    jobs = {
        "lr": ("logistic_regression", LogisticRegressionExact(), 5, False),
        "lr_cv": ("logistic_regression_cv", CrossValidatorExact(), 0, True),
        "dt": ("decision_tree", DecisionTreeClassifier(device=str(device)), 0, False),
        "rf": ("random_forest", RandomForestExact(), 0, False),
    }
    accuracies: dict[str, float] = {}
    for key in blocks:
        name, est, class_id, is_cv = jobs[key]
        t0 = time.perf_counter()
        model = est.fit(train)
        train_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        preds = model.transform(test)
        test_time = time.perf_counter() - t0
        metrics = evaluate(test.label, preds.raw, model.num_classes)
        result = ModelResult(
            name=name,
            metrics=metrics,
            train_time_s=train_time,
            test_time_s=test_time,
            is_cv=is_cv,
            display_name=_spark_display_name(name, model, is_cv),
        )
        report.model_block(
            result, sample_text=report.prediction_sample(test, preds, class_id=class_id)
        )
        accuracies[name] = float(metrics["accuracy"])

    paths = report.save()
    from har_tpu_torch.reporting.charts import save_metric_charts

    charts = save_metric_charts(paths.get("csv"), paths.get("cv_csv"), output_dir)
    if charts:
        paths["charts"] = os.path.dirname(charts[0])
    return {"accuracies": accuracies, "artifacts": paths}

