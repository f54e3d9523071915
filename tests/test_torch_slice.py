"""The port's slice end to end: `train`, with and without CV.

``har_tpu_torch.runner.run`` on the CPU and ``har_tpu.runner.run`` write
byte-identical result.txt and metrics CSVs for the decision tree and its
CV, apart from the uid and timing lines and the time columns (masked as
tests/test_golden_report.py masks them); the LR blocks agree within the
fit's stated tolerance.  The CLI writes its artifacts and refuses to run
without a GPU unless the CPU is named.
"""

import csv
import json
import re

import pytest
import torch

import har_tpu.runner as jax_runner
from har_tpu.config import DataConfig as JaxDataConfig
from har_tpu.config import ModelConfig as JaxModelConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu.config import TuningConfig as JaxTuningConfig
from har_tpu.models.neural_classifier import NeuralClassifier as JaxNeural
from har_tpu_torch import cli
from har_tpu_torch import runner as port_runner
from har_tpu_torch.config import DataConfig, MeshConfig, ModelConfig, RunConfig, TuningConfig
from har_tpu_torch.models.neural_classifier import NeuralClassifier

torch.set_num_threads(1)

ROWS = 600
# LR's sampled probabilities, port against JAX: the float32 fits' spread
# (measured 3.2e-6 at ROWS)
LR_PROB_RTOL = 1e-4
_TIME_COLUMNS = ("Training Time", "Testing Time")


@pytest.fixture(autouse=True)
def _no_reference_csv(monkeypatch, tmp_path):
    # both packages fall back to the synthetic table when the CSV is absent
    monkeypatch.setenv("HAR_TPU_WISDM_CSV", str(tmp_path / "absent.csv"))


def _masked(line: str) -> str:
    line = re.sub(r"_[0-9a-f]{20}\b", "_<uid>", line)
    return re.sub(
        r"(trained in|made in) -?\d+(\.\d+)?([eE]-?\d+)? seconds",
        r"\1 <t> seconds",
        line,
    )


def _csv_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        for col in row:
            if col.endswith(_TIME_COLUMNS):  # the CV CSV's too
                row[col] = "<t>"
        row["Classifier"] = _masked(row["Classifier"])
    return rows


def test_decision_tree_report_byte_identical(tmp_path):
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_outcome = jax_runner.run(
        JaxRunConfig(
            data=JaxDataConfig(synthetic_rows=ROWS), output_dir=str(jax_out)
        ),
        models=["decision_tree"],
        with_cv=False,
    )
    outcome = port_runner.run(
        RunConfig(data=DataConfig(synthetic_rows=ROWS), output_dir=str(port_out)),
        models=["decision_tree"],
        with_cv=False,
        device="cpu",
    )
    want = (jax_out / "result.txt").read_text().splitlines()
    got = (port_out / "result.txt").read_text().splitlines()
    assert len(got) == len(want)
    masked = 0
    for a, b in zip(got, want):
        if a != b:
            assert _masked(a) == _masked(b), (a, b)
            masked += 1
    assert masked <= 3  # the uid line and the two timing lines
    assert _csv_rows(port_out / "additional_param.csv") == _csv_rows(
        jax_out / "additional_param.csv"
    )
    assert set(outcome.report_paths) == set(jax_outcome.report_paths)
    assert set(outcome.report_paths) - {"charts"} == {"result", "csv", "timing"}
    with open(port_out / "timing.csv", newline="") as f:
        sections = [row["section"] for row in csv.DictReader(f)]
    assert sections == [
        "load", "report", "featurize", "decision_tree_fit",
        "decision_tree_transform",
    ]


def _lr_line_agrees(got: str, want: str) -> bool:
    """An LR block line that may differ from JAX's: a row of the
    probability sample, with the same UID, label and prediction, and the
    first probability within LR_PROB_RTOL."""
    g, w = got.split("|"), want.split("|")
    if len(g) != 6 or len(g) != len(w) or g[1] != w[1] or g[3:] != w[3:]:
        return False
    first = [float(cell.strip()[1:].split(",")[0]) for cell in (g[2], w[2])]
    return abs(first[0] - first[1]) <= LR_PROB_RTOL * abs(first[1])


def test_default_run_matches_jax(tmp_path):
    """Both packages' default run (LR and DT, each with its 5-fold CV):
    result.txt, additional_param.csv and crossFold_additional_param.csv
    agree outside the uid and timing lines; within the LR blocks a float32
    fit may move the sampled probabilities (the fit's stated tolerance,
    tests/test_torch_logistic_regression.py), not the labels or any
    metric."""
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_outcome = jax_runner.run(
        JaxRunConfig(data=JaxDataConfig(synthetic_rows=ROWS), output_dir=str(jax_out)),
        models=["lr", "dt"],
    )
    outcome = port_runner.run(
        RunConfig(data=DataConfig(synthetic_rows=ROWS), output_dir=str(port_out)),
        models=["lr", "dt"],
        device="cpu",
    )
    want = (jax_out / "result.txt").read_text().splitlines()
    got = (port_out / "result.txt").read_text().splitlines()
    assert len(got) == len(want)
    block = None
    masked = 0
    for a, b in zip(got, want):
        if "CrossValidatorModel_" in b or "Model (uid=" in b or "Regression_" in b:
            block = b
        if a == b:
            continue
        masked += 1
        assert _masked(a) == _masked(b) or (
            "Logistic" in block and _lr_line_agrees(a, b)
        ), (block, a, b)
    assert masked <= 4 * 3 + 2 * 5  # uid and timing lines; two LR samples
    for name in ("additional_param.csv", "crossFold_additional_param.csv"):
        assert _csv_rows(port_out / name) == _csv_rows(jax_out / name)
    assert set(outcome.report_paths) == set(jax_outcome.report_paths)
    assert set(outcome.report_paths) - {"charts"} == {"result", "csv", "cv_csv", "timing"}
    with open(port_out / "timing.csv", newline="") as f:
        sections = [row["section"] for row in csv.DictReader(f)]
    assert sections == [
        "load", "report", "featurize",
        "logistic_regression_fit", "logistic_regression_transform",
        "logistic_regression_cv_fit", "logistic_regression_cv_transform",
        "decision_tree_fit", "decision_tree_transform",
        "decision_tree_cv_fit", "decision_tree_cv_transform",
    ]


def test_cli_default_train_writes_four_artifacts(tmp_path, capsys, monkeypatch):
    """`train --device cpu` with no model flags: LR, DT and RF, each with
    CV, at 300 rows and 8 trees a forest."""
    monkeypatch.setattr(port_runner, "effective_synthetic_rows", lambda data: 300)
    build = port_runner.build_estimator
    monkeypatch.setattr(
        port_runner, "build_estimator",
        lambda name, params=None, device="cuda": build(
            name, {**(params or {}), "num_trees": 8}, device
        ),
    )
    assert cli.main(["train", "--device", "cpu", "--output-dir", str(tmp_path)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed["accuracies"]) == {
        f"{m}{cv}" for m in ("logistic_regression", "decision_tree", "random_forest")
        for cv in ("", "_cv")
    }
    for name in ("result.txt", "additional_param.csv",
                 "crossFold_additional_param.csv", "timing.csv"):
        assert (tmp_path / name).is_file()
    with open(tmp_path / "crossFold_additional_param.csv", newline="") as f:
        rows = [row["Classifier"] for row in csv.DictReader(f)]
    assert [r.split(" for ")[1] for r in rows] == [
        "Logistic Regression", "Decision Tree", "Random Forest"
    ]
    text = (tmp_path / "result.txt").read_text()
    assert "with 8 trees" in text and "LogisticRegression_" in text


def test_trees_run_end_to_end(tmp_path):
    outcome = port_runner.run(
        RunConfig(
            data=DataConfig(synthetic_rows=ROWS),
            model=ModelConfig(params={"num_trees": 8}),
            output_dir=str(tmp_path),
        ),
        models=["decision_tree", "random_forest"],
        with_cv=False,
        device="cpu",
    )
    acc = outcome.accuracies
    assert set(acc) == {"decision_tree", "random_forest"}
    assert acc["random_forest"] > 0.4
    text = (tmp_path / "result.txt").read_text()
    assert "RandomForestClassificationModel" in text and "with 8 trees" in text
    with open(tmp_path / "additional_param.csv", newline="") as f:
        assert len(list(csv.DictReader(f))) == 2


def test_jax_and_port_configs_agree():
    """The same RunConfig in each package's copy."""
    a = RunConfig(data=DataConfig(synthetic_rows=ROWS))
    b = JaxRunConfig(data=JaxDataConfig(synthetic_rows=ROWS))
    assert repr(a) == repr(b)
    assert repr(ModelConfig(params={"num_trees": 8})) == repr(
        JaxModelConfig(params={"num_trees": 8})
    )


def test_cli_train_writes_report_at_default_rows(tmp_path, capsys):
    rc = cli.main(
        ["train", "--models", "dt", "--no-cv", "--device", "cpu",
         "--output-dir", str(tmp_path)]
    )
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed["accuracies"]) == {"decision_tree"}
    text = (tmp_path / "result.txt").read_text()
    assert "Training Dataset Count : 3793" in text
    assert "Test Dataset Count     : 1625" in text
    assert (tmp_path / "additional_param.csv").exists()
    assert (tmp_path / "timing.csv").exists()


def test_cli_without_gpu_raises_unless_cpu_is_named(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["train", "--models", "dt", "--no-cv", "--output-dir", str(tmp_path)])
    assert not (tmp_path / "result.txt").exists()


@pytest.mark.parametrize(
    "kwargs",
    [
        {"models": ["mlp"], "mesh": {"tp": 2}},
        {"models": ["mlp"], "mesh": {"dp": 2}},
        {"models": ["mlp"], "mesh": {"dp": 2, "tp": 2}},
        {"models": ["lr"], "mesh": {"dp": 2}},
    ],
)
def test_unported_parts_raise_not_implemented(tmp_path, kwargs):
    """The tensor- and data-parallel meshes of `train` are ported (neural
    training and LR's sharded sweep, tests/test_torch_parallel.py): a mesh
    of more than one rank needs a process group of dp × tp ranks, and a
    run of one process refuses it with a ValueError that names the way to
    start the ranks, before any fit or report, as `har_tpu`'s runner
    refuses a mesh larger than its device count."""
    config = RunConfig(
        data=DataConfig(synthetic_rows=ROWS, **kwargs.get("data", {})),
        model=ModelConfig(params=dict(kwargs.get("params", {}), epochs=1)),
        mesh=MeshConfig(**kwargs.get("mesh", {})),
        output_dir=str(tmp_path),
    )
    with pytest.raises(ValueError, match="--distributed"):
        port_runner.run(config, models=kwargs["models"], device="cpu")
    assert not (tmp_path / "result.txt").exists()


def assert_same_report_structure(port_dir, jax_dir) -> None:
    """result.txt of both packages: equal up to the first model block
    (data, split and pipeline blocks), and then the same model lines (the
    line atop each block, uid masked) and metric names in the same order.
    A block's metric digits and the rows of its sample of wrong
    predictions depend on the fit (neural weights come from other
    draws)."""

    def parts(path):
        lines = (path / "result.txt").read_text().splitlines()
        start = next(i for i, ln in enumerate(lines) if "CLASSIFICATION AND EVALUATION" in ln)
        model_lines = [_masked(lines[i - 1]) for i, ln in enumerate(lines)
                       if ln.startswith("Classifier trained in")]
        metric_names = [ln.split(":")[0] for ln in lines[start:] if "-: " in ln]
        return [_masked(ln) for ln in lines[:start]], model_lines, metric_names

    assert parts(port_dir) == parts(jax_dir)


def test_gbt_and_mlp_run_matches_jax(tmp_path):
    """`run(models=["gbt", "mlp"], with_cv=True)`: both on the numeric
    view (no one-hot pipeline blocks), each with its CV; GBDT's model
    lines are Spark's GBTClassificationModel ones."""
    params = {"epochs": 2, "num_rounds": 5, "hidden": (16,)}
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_outcome = jax_runner.run(
        JaxRunConfig(data=JaxDataConfig(synthetic_rows=ROWS),
                     model=JaxModelConfig(params=dict(params)), output_dir=str(jax_out)),
        models=["gbt", "mlp"],
    )
    outcome = port_runner.run(
        RunConfig(data=DataConfig(synthetic_rows=ROWS),
                  model=ModelConfig(params=dict(params)), output_dir=str(port_out)),
        models=["gbt", "mlp"],
        device="cpu",
    )
    assert set(outcome.report_paths) == set(jax_outcome.report_paths)
    assert set(outcome.report_paths) - {"charts"} == {"result", "csv", "cv_csv", "timing"}
    assert set(outcome.accuracies) == {"gbdt", "gbdt_cv", "mlp", "mlp_cv"}
    assert_same_report_structure(port_out, jax_out)
    text = (port_out / "result.txt").read_text()
    assert text.count("Classifier trained in") == 4
    assert "GBTClassificationModel (uid=GBTClassifier_" in text
    assert "for Gradient Boosted Trees" in text
    assert "MODELING PIPELINE" not in (jax_out / "result.txt").read_text()
    with open(port_out / "timing.csv", newline="") as f:
        sections = [row["section"] for row in csv.DictReader(f)]
    assert sections == [
        "load", "report", "featurize",
        "gbdt_fit", "gbdt_transform", "gbdt_cv_fit", "gbdt_cv_transform",
        "mlp_fit", "mlp_transform", "mlp_cv_fit", "mlp_cv_transform",
    ]


def test_cli_gbt_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(port_runner, "effective_synthetic_rows", lambda data: 300)
    rc = cli.main(["train", "--models", "gbt", "--no-cv", "--device", "cpu",
                   "--output-dir", str(tmp_path)])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed["accuracies"]) == {"gbdt"}
    for name in ("result.txt", "additional_param.csv", "timing.csv"):
        assert (tmp_path / name).is_file()


def test_mlp_with_a_tuning_grid_matches_jax(tmp_path):
    """A neural model's CV over a grid (the estimator's copy_with): the
    port runs it, with the JAX package's report structure."""
    params = {"epochs": 1, "hidden": (16,)}
    tuning = dict(grid={"learning_rate": [1e-3, 3e-3]}, num_folds=2)
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    jax_runner.run(
        JaxRunConfig(data=JaxDataConfig(synthetic_rows=ROWS),
                     model=JaxModelConfig(params=dict(params)),
                     tuning=JaxTuningConfig(**tuning), output_dir=str(jax_out)),
        models=["mlp"],
    )
    outcome = port_runner.run(
        RunConfig(data=DataConfig(synthetic_rows=ROWS),
                  model=ModelConfig(params=dict(params)),
                  tuning=TuningConfig(**tuning), output_dir=str(port_out)),
        models=["mlp"], device="cpu", save_models_dir=str(tmp_path / "models"),
    )
    assert set(outcome.accuracies) == {"mlp", "mlp_cv"}
    assert_same_report_structure(port_out, jax_out)
    assert sorted(p.name for p in (tmp_path / "models").iterdir()) == ["mlp", "mlp_cv"]


def test_neural_copy_with_sets_trainer_fields():
    port = NeuralClassifier("mlp").copy_with(learning_rate=1e-2, augment="none")
    jax = JaxNeural("mlp").copy_with(learning_rate=1e-2, augment="none")
    assert port.config.learning_rate == jax.config.learning_rate == 1e-2
    assert port.augment == jax.augment == "none"
    assert NeuralClassifier("mlp").config.learning_rate == 3e-3


def test_cli_trace_dir_writes_a_trace_and_the_same_report(tmp_path, capsys):
    """`train --trace-dir` on the CPU: torch.profiler's trace lands in the
    directory, and result.txt equals a run without the flag outside the
    uid and timing lines."""
    runs = {}
    for tag, extra in (("plain", []), ("traced", ["--trace-dir", str(tmp_path / "trace")])):
        out = tmp_path / tag
        assert cli.main(["train", "--models", "dt", "--no-cv", "--device", "cpu",
                         "--output-dir", str(out), *extra]) == 0
        runs[tag] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        runs[tag]["text"] = (out / "result.txt").read_text().splitlines()
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert runs["traced"]["accuracies"] == runs["plain"]["accuracies"]
    assert [_masked(ln) for ln in runs["traced"]["text"]] == [
        _masked(ln) for ln in runs["plain"]["text"]]
