"""The port's split-ratio sweep and EDA plots against the JAX package.

``sweep`` (the paper's Table 1/2 experiment) on a 600-row synthetic WISDM
table at 70/80/90 % train (and LR's CV at 80 %, the JAX sweep's compile
time bounds this): both packages give the same rows (split, model, row
counts; DT's accuracy and f1 exactly, LR's within 1e-6), the same CSV
header and the same sweep.txt once the time columns are masked; CV rows
come only for LR.  ``--eda`` writes the JAX package's files from the same
sampled rows.
"""

import csv
import json
import sys

import matplotlib.axes
import numpy as np
import pytest
import torch

import har_tpu.runner as jax_runner
from har_tpu.config import DataConfig as JaxDataConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu.data.synthetic import synthetic_wisdm as jax_synthetic_wisdm
from har_tpu.data.wisdm import WISDM_NUMERIC_COLUMNS as JAX_NUMERIC_COLUMNS
from har_tpu.reporting import eda as jax_eda
from har_tpu_torch import cli
from har_tpu_torch import runner as port_runner
from har_tpu_torch.config import DataConfig, MeshConfig, ModelConfig, RunConfig
from har_tpu_torch.data.synthetic import synthetic_wisdm
from har_tpu_torch.models.tree import DecisionTreeClassifier
from har_tpu_torch.reporting import eda

torch.set_num_threads(1)

ROWS = 600
FRACTIONS = (0.7, 0.8, 0.9)
LR_METRIC_ATOL = 1e-6
_MASKED = ("train_time_s", "test_time_s")


@pytest.fixture(autouse=True)
def _no_reference_csv(monkeypatch, tmp_path):
    # both packages fall back to the synthetic table when the CSV is absent
    monkeypatch.setenv("HAR_TPU_WISDM_CSV", str(tmp_path / "absent.csv"))


# (models, fractions, with CV): each package sweeps each case once
CASES = {
    "plain": (["lr", "dt"], FRACTIONS, False),
    "cv": (["lr"], (0.8,), True),
}


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """case -> (output dir, JAX rows, port rows): each package's sweep on
    the same table, with the reference's Spark split at every fraction."""
    base = tmp_path_factory.mktemp("sweep")
    mp = pytest.MonkeyPatch()
    mp.setenv("HAR_TPU_WISDM_CSV", str(base / "absent.csv"))
    out = {}
    try:
        for case, (models, fractions, with_cv) in CASES.items():
            theirs = jax_runner.sweep(
                JaxRunConfig(data=JaxDataConfig(synthetic_rows=ROWS),
                             output_dir=str(base / case / "jax")),
                models=models, fractions=fractions, with_cv=with_cv)
            ours = port_runner.sweep(
                RunConfig(data=DataConfig(synthetic_rows=ROWS),
                          output_dir=str(base / case / "port")),
                models=models, fractions=fractions, with_cv=with_cv, device="cpu")
            out[case] = (base / case, theirs, ours)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("case", CASES)
def test_sweep_rows_match_jax(sweeps, case):
    _, theirs, ours = sweeps[case]
    key = ("split", "model", "n_train", "n_test")
    assert [tuple(r[k] for k in key) for r in ours] == [tuple(r[k] for k in key)
                                                        for r in theirs]
    models = {"plain": ["logistic_regression", "decision_tree"] * 3,
              "cv": ["logistic_regression", "logistic_regression_cv"]}[case]
    assert [r["model"] for r in ours] == models
    for mine, want in zip(ours, theirs):
        assert list(mine) == list(want)
        if mine["model"] == "decision_tree":
            assert (mine["accuracy"], mine["f1"]) == (want["accuracy"], want["f1"])
        else:
            assert mine["accuracy"] == pytest.approx(want["accuracy"], abs=LR_METRIC_ATOL)
            assert mine["f1"] == pytest.approx(want["f1"], abs=LR_METRIC_ATOL)
        assert mine["n_train"] + mine["n_test"] == ROWS
        assert mine["train_time_s"] >= 0 and mine["test_time_s"] >= 0


def test_sweep_splits_are_the_spark_replay(sweeps):
    """Each fraction's row counts are the Spark-exact split's."""
    from har_tpu_torch.data.spark_split import spark_split_indices

    _, _, ours = sweeps["plain"]
    table = synthetic_wisdm(ROWS, seed=2018)
    assert [r["split"] for r in ours[::2]] == ["70-30", "80-20", "90-10"]
    for row, frac in zip(ours[::2], FRACTIONS):
        train, test = spark_split_indices(table, [frac, 1.0 - frac], 2018)
        assert (row["n_train"], row["n_test"]) == (len(train), len(test))


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _table_cells(path, columns):
    """sweep.txt's cells by row with the time columns replaced; border
    lines as a marker, since cell widths follow the masked values."""
    out = []
    for line in path.read_text().splitlines():
        if line.startswith("+"):
            out.append("<border>")
            continue
        row = dict(zip(columns, (c.strip() for c in line.strip("|").split("|"))))
        for col in _MASKED:
            row[col] = "<t>"
        out.append([row[c] for c in columns])
    return out


@pytest.mark.parametrize("case", CASES)
def test_sweep_artifacts_match_jax(sweeps, case):
    base, theirs_rows, _ = sweeps[case]
    theirs, ours = _csv(base / "jax" / "sweep.csv"), _csv(base / "port" / "sweep.csv")
    assert ours[0] == theirs[0] == ["split", "model", "n_train", "n_test", "train_time_s",
                                    "test_time_s", "accuracy", "f1"]
    assert len(ours) == len(theirs) == len(theirs_rows) + 1
    assert _table_cells(base / "port" / "sweep.txt", ours[0]) == _table_cells(
        base / "jax" / "sweep.txt", ours[0])


def test_sweep_cv_rows_only_for_gridded_models(tmp_path):
    rows = port_runner.sweep(
        RunConfig(data=DataConfig(synthetic_rows=300), model=ModelConfig(params={"max_iter": 3}),
                  output_dir=str(tmp_path)),
        models=["dt", "lr"], fractions=(0.7,), device="cpu")
    assert [r["model"] for r in rows] == ["decision_tree", "logistic_regression",
                                          "logistic_regression_cv"]


@pytest.mark.parametrize("kwargs", [{"fractions": ()}, {"models": [], "fractions": ()}])
def test_sweep_empty_arguments_raise(tmp_path, kwargs):
    config = RunConfig(data=DataConfig(synthetic_rows=300), output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="at least one model and one fraction"):
        port_runner.sweep(config, device="cpu", **kwargs)
    with pytest.raises(ValueError):
        jax_runner.sweep(JaxRunConfig(data=JaxDataConfig(synthetic_rows=300),
                                      output_dir=str(tmp_path)), **kwargs)


def test_sweep_mesh_raises_item_14(tmp_path):
    """LR's mesh-sharded sweep is ported (item 14): a dp mesh needs its
    ranks, and a sweep of one process refuses it before any fit."""
    config = RunConfig(data=DataConfig(synthetic_rows=300), mesh=MeshConfig(dp=2),
                       output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="torchrun"):
        port_runner.sweep(config, models=["lr"], device="cpu")
    assert not (tmp_path / "sweep.csv").exists()


def test_cli_sweep_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(port_runner, "effective_synthetic_rows", lambda data: 300)
    rc = cli.main(["sweep", "--models", "dt", "--fractions", "0.7", "0.9", "--no-cv",
                   "--device", "cpu", "--output-dir", str(tmp_path)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert printed.startswith("+") and "90-10" in printed
    rows = _csv(tmp_path / "sweep.csv")
    assert [r[:2] for r in rows[1:]] == [["70-30", "decision_tree"],
                                         ["90-10", "decision_tree"]]


def test_cli_sweep_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["sweep", "--models", "dt", "--output-dir", str(tmp_path)])
    assert not (tmp_path / "sweep.csv").exists()


@pytest.fixture
def hexbin_calls(monkeypatch):
    """The (x, y) arrays every hexbin plot receives."""
    calls = []
    hexbin = matplotlib.axes.Axes.hexbin

    def record(self, x, y, *args, **kwargs):
        calls.append((np.array(x), np.array(y)))
        return hexbin(self, x, y, *args, **kwargs)

    monkeypatch.setattr(matplotlib.axes.Axes, "hexbin", record)
    return calls


def test_eda_plots_match_jax(tmp_path, hexbin_calls):
    columns = ["XAVG", "YSTDDEV", "RESULTANT"]
    jax_paths = jax_eda.save_eda_plots(jax_synthetic_wisdm(200, seed=5), columns,
                                       str(tmp_path / "jax"), sample_fraction=0.5)
    jax_calls = list(hexbin_calls)
    hexbin_calls.clear()
    paths = eda.save_eda_plots(synthetic_wisdm(200, seed=5), columns,
                               str(tmp_path / "port"), sample_fraction=0.5)
    rel = [p.split("/")[-1] for p in paths]
    assert rel == [p.split("/")[-1] for p in jax_paths]
    assert len(rel) == 7 and rel[0] == "Fig XAVG_YSTDDEV.png"
    assert rel[-1] == "Scatter_Matrix.png"
    assert len(hexbin_calls) == len(jax_calls) == 6
    for (x, y), (jx, jy) in zip(hexbin_calls, jax_calls):
        assert 60 < len(x) < 140
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    for path in paths:
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_train_eda_writes_jax_file_list(tmp_path, capsys):
    rc = cli.main(["train", "--dataset", "synthetic", "--models", "dt", "--no-cv",
                   "--eda", "--device", "cpu", "--output-dir", str(tmp_path)])
    assert rc == 0
    columns = list(JAX_NUMERIC_COLUMNS)
    want = {f"Fig {x}_{y}.png" for x in columns for y in columns if x != y}
    want.add("Scatter_Matrix.png")
    got = {p.name for p in (tmp_path / "plot").iterdir()}
    assert got == want and len(got) == 91
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["accuracies"]


@pytest.fixture
def no_fits(monkeypatch):
    def refuse(self, data):
        raise AssertionError("a model was fitted")

    monkeypatch.setattr(DecisionTreeClassifier, "fit", refuse)


def test_eda_on_ucihar_raises_before_any_fit(tmp_path, no_fits):
    """`har_tpu` raises the same ValueError after its fits (matplotlib has
    no 0x0 grid); the port raises before them."""
    config = RunConfig(data=DataConfig(dataset="ucihar", synthetic_rows=60),
                       output_dir=str(tmp_path / "port"))
    with pytest.raises(ValueError, match="numeric columns"):
        port_runner.run(config, models=["dt"], with_cv=False, device="cpu", with_eda=True)
    assert not (tmp_path / "port" / "result.txt").exists()
    with pytest.raises(ValueError):
        jax_runner.run(JaxRunConfig(data=JaxDataConfig(dataset="ucihar", synthetic_rows=60),
                                    output_dir=str(tmp_path / "jax")),
                       models=["dt"], with_cv=False, with_eda=True)
    assert not (tmp_path / "jax" / "result.txt").exists()


def test_eda_without_matplotlib_raises_import_error(tmp_path, monkeypatch, no_fits):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    config = RunConfig(data=DataConfig(synthetic_rows=60), output_dir=str(tmp_path))
    with pytest.raises(ImportError):
        port_runner.run(config, models=["dt"], with_cv=False, device="cpu", with_eda=True)
