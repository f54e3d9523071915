"""The port's raw-window slice end to end: `train --dataset wisdm_raw
--models transformer --no-cv`.

Both packages load the same synthetic raw windows, split them into the
same rows and write the same result.txt outside the model's own lines
(its metrics, prediction sample and timings, which depend on the trained
weights: torch cannot draw ``jax.random``'s initial values).  The CLI
writes its artifacts on the CPU when asked and refuses to run without a
GPU otherwise.
"""

import csv
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

import har_tpu.runner as jax_runner
from har_tpu.config import DataConfig as JaxDataConfig
from har_tpu.config import ModelConfig as JaxModelConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu_torch import cli
from har_tpu_torch import runner as port_runner
from har_tpu_torch.config import DataConfig, MeshConfig, ModelConfig, RunConfig

torch.set_num_threads(1)

ROWS = 160
TINY = {"embed_dim": 16, "num_heads": 2, "num_layers": 1, "patch_size": 8,
        "epochs": 2, "batch_size": 64}


def _configs(tmp_path, rows=ROWS, params=TINY):
    jax_cfg = JaxRunConfig(
        data=JaxDataConfig(dataset="wisdm_raw", synthetic_rows=rows),
        model=JaxModelConfig(name="transformer", params=dict(params)),
        output_dir=str(tmp_path / "jax"),
    )
    port_cfg = RunConfig(
        data=DataConfig(dataset="wisdm_raw", synthetic_rows=rows),
        model=ModelConfig(name="transformer", params=dict(params)),
        output_dir=str(tmp_path / "port"),
    )
    return jax_cfg, port_cfg


@pytest.mark.parametrize("seed", [2018, 7])
def test_windows_labels_and_split_bit_identical(tmp_path, seed):
    jax_cfg, port_cfg = _configs(tmp_path)
    jax_cfg = dataclasses.replace(
        jax_cfg, data=dataclasses.replace(jax_cfg.data, seed=seed)
    )
    port_cfg = dataclasses.replace(
        port_cfg, data=dataclasses.replace(port_cfg.data, seed=seed)
    )
    want = jax_runner.load_dataset(jax_cfg)
    got = port_runner.load_dataset(port_cfg)
    np.testing.assert_array_equal(got.windows, want.windows)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.class_names == want.class_names
    assert got.windows.dtype == np.float32 and got.windows.shape == (ROWS, 200, 3)
    jax_parts = jax_runner.featurize(jax_cfg, want)[:2]
    port_parts = port_runner.featurize(port_cfg, got)[:2]
    for a, b in zip(port_parts, jax_parts):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.label, b.label)
        assert a.class_names == b.class_names


def test_scaler_matches_jax():
    from har_tpu.features.scaler import StandardScaler as JaxScaler
    from har_tpu_torch.features.scaler import StandardScaler

    x = np.random.default_rng(0).normal(3.0, 2.0, size=(50, 20, 3)).astype(np.float32)
    x[:, 0, 1] = 1.5  # a zero-variance column passes through centered
    a, b = StandardScaler().fit(x), JaxScaler().fit(x)
    np.testing.assert_array_equal(a.mean, b.mean)
    np.testing.assert_array_equal(a.std, b.std)
    np.testing.assert_array_equal(a.transform(x), b.transform(x))


# the lines of the model's block that hold the trained model's numbers
_METRIC = re.compile(r"(-: |= |trained in |made in )")


def _model_block_skeleton(lines):
    """Metric lines keep their labels; table rows of the prediction
    sample and per-class tables are dropped (they hold model numbers)."""
    out = []
    for line in lines:
        if line.startswith(("+", "|", "only showing")):
            continue
        m = _METRIC.search(line)
        out.append(line[: m.end()] if m else line)
    return out


def test_report_identical_outside_model_lines(tmp_path):
    jax_cfg, port_cfg = _configs(tmp_path)
    jax_outcome = jax_runner.run(jax_cfg, models=["transformer"], with_cv=False)
    outcome = port_runner.run(port_cfg, models=["transformer"], with_cv=False,
                              device="cpu")
    want = (tmp_path / "jax" / "result.txt").read_text().splitlines()
    got = (tmp_path / "port" / "result.txt").read_text().splitlines()
    banner = next(i for i, line in enumerate(want) if "CLASSIFICATION AND" in line)
    assert got[: banner + 2] == want[: banner + 2]  # data, split, banner, "transformer"
    assert "Raw windows: (160, 200, 3) (200 steps, tri-axial)" in got
    assert _model_block_skeleton(got[banner:]) == _model_block_skeleton(want[banner:])
    total = [line for line in want if line.startswith("Total Count")]
    assert total and total[0] in got
    with open(tmp_path / "port" / "additional_param.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["Classifier"] for r in rows] == ["transformer"]
    with open(tmp_path / "port" / "timing.csv", newline="") as f:
        sections = [row["section"] for row in csv.DictReader(f)]
    assert sections == ["load", "report", "featurize", "transformer_fit",
                        "transformer_transform"]
    assert set(outcome.report_paths) == set(jax_outcome.report_paths)
    assert set(outcome.report_paths) - {"charts"} == {"result", "csv", "timing"}
    assert 0.0 <= outcome.accuracies["transformer"] <= 1.0


RAW_FAMILIES = ["cnn1d", "bilstm", "dt", "gbt"]
RAW_TINY = {"channels": (8, 8), "hidden": 8, "epochs": 1, "batch_size": 64,
            "num_rounds": 3}


def test_raw_families_run_matches_jax(tmp_path):
    """`run(dataset="wisdm_raw", models=["cnn1d", "bilstm", "dt", "gbt"])`
    with CV: CNN1D and BiLSTM on the windows, DT and GBDT on their 43
    features.  The report equals har_tpu's up to the first model block,
    and then block for block outside the fitted models' numbers; DT's
    model line (depth and node count) and GBDT's are equal."""
    jax_cfg, port_cfg = _configs(tmp_path, params=RAW_TINY)
    jax_outcome = jax_runner.run(jax_cfg, models=RAW_FAMILIES)
    outcome = port_runner.run(port_cfg, models=RAW_FAMILIES, device="cpu")
    want = (tmp_path / "jax" / "result.txt").read_text().splitlines()
    got = (tmp_path / "port" / "result.txt").read_text().splitlines()
    banner = next(i for i, line in enumerate(want) if "CLASSIFICATION AND" in line)
    assert got[: banner + 1] == want[: banner + 1]
    assert _model_block_skeleton(got[banner:]) == _model_block_skeleton(want[banner:])
    assert any(line.startswith("DecisionTreeClassificationModel (uid=") for line in got)
    assert any(line.startswith("GBTClassificationModel (uid=") for line in got)
    assert set(outcome.accuracies) == {f"{m}{cv}" for m in
                                       ("cnn1d", "bilstm", "decision_tree", "gbdt")
                                       for cv in ("", "_cv")}
    assert set(outcome.report_paths) == set(jax_outcome.report_paths)
    assert set(outcome.report_paths) - {"charts"} == {"result", "csv", "cv_csv", "timing"}


def test_cli_raw_families_and_augment_on_the_cpu(tmp_path, capsys, small_raw_dataset):
    rc = cli.main(
        ["train", "--dataset", "wisdm_raw", "--models", "cnn1d", "gbt", "--no-cv",
         "--epochs", "1", "--augment", "raw_windows", "--device", "cpu",
         "--output-dir", str(tmp_path)]
    )
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed["accuracies"]) == {"cnn1d", "gbdt"}
    for name in ("result.txt", "additional_param.csv", "timing.csv"):
        assert (tmp_path / name).is_file()


@pytest.fixture
def small_raw_dataset(monkeypatch):
    """The CLI's wisdm_raw run at 200 windows instead of 4,000."""
    monkeypatch.setattr(port_runner, "effective_synthetic_rows", lambda data: 200)


def test_cli_raw_path_on_cpu(tmp_path, capsys, small_raw_dataset):
    rc = cli.main(
        ["train", "--dataset", "wisdm_raw", "--models", "transformer", "--no-cv",
         "--epochs", "1", "--batch-size", "256", "--learning-rate", "1e-3",
         "--class-weight", "balanced", "--device", "cpu",
         "--output-dir", str(tmp_path)]
    )
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed["accuracies"]) == {"transformer"}
    for name in ("result.txt", "additional_param.csv", "timing.csv"):
        assert (tmp_path / name).is_file()
    text = (tmp_path / "result.txt").read_text()
    assert "Raw windows: (200, 200, 3)" in text


def test_cli_without_gpu_raises(tmp_path, monkeypatch, small_raw_dataset):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["train", "--dataset", "wisdm_raw", "--models", "transformer",
                  "--no-cv", "--epochs", "1", "--output-dir", str(tmp_path)])
    assert not (tmp_path / "result.txt").exists()


@pytest.mark.parametrize(
    "dataset,models,path,error",
    [
        ("ucihar", ["bilstm"], None, ValueError),  # needs raw windows
        ("wisdm", ["transformer"], None, ValueError),  # needs raw windows
        # the native raw parser reads --data-path: a missing file raises
        ("wisdm_raw", ["transformer"], "raw.txt", FileNotFoundError),
        ("ucihar", ["cnn1d"], None, ValueError),  # needs raw windows
    ],
    # ids fixed: the cases were named for the combinations they checked
    # before the raw parser, the raw features, CNN1D and UCI-HAR were ported
    ids=[
        "wisdm_raw-models0-None-NotImplementedError",
        "wisdm-models1-None-ValueError",
        "wisdm_raw-models2-raw.txt-NotImplementedError",
        "wisdm_raw-models3-None-NotImplementedError",
    ],
)
def test_unported_or_impossible_combinations_raise(tmp_path, dataset, models, path, error):
    config = RunConfig(
        data=DataConfig(dataset=dataset, path=path, synthetic_rows=ROWS),
        model=ModelConfig(params=dict(TINY)),
        output_dir=str(tmp_path),
    )
    with pytest.raises(error):
        port_runner.run(config, models=models, device="cpu")
    assert not (tmp_path / "result.txt").exists()


def test_neural_mesh_raises(tmp_path):
    config = RunConfig(
        data=DataConfig(dataset="wisdm_raw", synthetic_rows=ROWS),
        mesh=MeshConfig(dp=2),
        output_dir=str(tmp_path),
    )
    with pytest.raises(NotImplementedError, match="item 14"):
        port_runner.run(config, models=["transformer"], device="cpu")


def test_unknown_hyperparameter_raises():
    with pytest.raises(ValueError, match="unknown hyperparameter"):
        port_runner.build_estimator("transformer", {"embed_dims": 8}, device="cpu")
    est = port_runner.build_estimator(
        "transformer", {**TINY, "num_trees": 3, "class_weight": "balanced"}, device="cpu"
    )
    assert est.config.epochs == 2 and est.config.class_weight == "balanced"
    assert est.model_kwargs == {"embed_dim": 16, "num_heads": 2, "num_layers": 1,
                                "patch_size": 8}
