"""`parity` on the port: the four reference blocks against `har_tpu`'s.

``har_tpu.parity.parity_run`` and ``har_tpu_torch.parity.parity_run``
(``device="cpu"``) run on the same 5,418-row synthetic WISDM table.
result.txt is byte-identical outside the uid and timing lines — the LR
block's probability strings included: both packages evaluate them with
the same fdlibm ``jvm_exp`` in the same order, so the 16-digit strings
are equal, not merely close.  Both metric CSVs are equal in every field
outside the time columns, and the accuracies are equal as floats.  On the
reference CSV (where mounted) the port pins the reference's published
accuracies.  The CLI runs a block on the CPU and refuses to run without a
GPU unless the CPU is named.
"""

import csv
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import har_tpu.parity as jax_parity
from har_tpu.config import DataConfig as JaxDataConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu.reporting import ModelResult as JaxModelResult
from har_tpu.reporting import ReportWriter as JaxReportWriter
from har_tpu_torch import cli
from har_tpu_torch import parity as port_parity
from har_tpu_torch.config import DataConfig, RunConfig
from har_tpu_torch.reporting import ModelResult, ReportWriter
from har_tpu_torch.reporting import charts as port_charts

from tests.conftest import requires_wisdm

torch.set_num_threads(1)

TEST_ROWS = 1625
# synthetic_wisdm(5418), as har_tpu's parity_run scores it on the CPU
SYNTHETIC_ACCURACIES = {
    "logistic_regression": 1.0,
    "logistic_regression_cv": 1.0,
    "decision_tree": 1494 / TEST_ROWS,
    "random_forest": 1364 / TEST_ROWS,
}
# the reference's captured run (result.txt), to the digits it prints
REFERENCE_ACCURACIES = {
    "logistic_regression": 0.61477,
    "logistic_regression_cv": 0.71446,
    "decision_tree": 0.73046,
    "random_forest": 0.632,
}
ARTIFACTS = ("result.txt", "additional_param.csv", "crossFold_additional_param.csv")
_TIME_COLUMNS = ("Training Time", "Testing Time")
_TIMING_LINE = re.compile(r"(trained in|made in) -?\d+(\.\d+)?([eE]-?\d+)? seconds")
_UID = re.compile(r"_[0-9a-f]{20}\b")


def _run_both(tmp_path_factory, jax_config, port_config):
    out = tmp_path_factory.mktemp("parity")
    jax = jax_parity.parity_run(str(out / "jax"), config=jax_config)
    port = port_parity.parity_run(str(out / "port"), config=port_config, device="cpu")
    return out / "jax", out / "port", jax, port


@pytest.fixture(scope="module")
def synthetic_pair(tmp_path_factory):
    """Both packages' full parity run on synthetic_wisdm(5418)."""
    with pytest.MonkeyPatch.context() as mp:
        # both packages fall back to the synthetic table when the CSV is absent
        mp.setenv("HAR_TPU_WISDM_CSV", str(tmp_path_factory.getbasetemp() / "absent.csv"))
        return _run_both(tmp_path_factory, None, None)


def _without_uid_and_timing(path) -> tuple[list[str], int]:
    """The file's lines, those with a uid or a timing left out; and how
    many were left out."""
    lines = path.read_text().splitlines()
    kept = [ln for ln in lines if not (_UID.search(ln) or _TIMING_LINE.search(ln))]
    return kept, len(lines) - len(kept)


def _csv_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        for col in row:
            if col.endswith(_TIME_COLUMNS):  # the CV CSV's too
                row[col] = "<t>"
    return rows


def test_result_txt_identical_outside_uid_and_timing_lines(synthetic_pair):
    jax_dir, port_dir, _, _ = synthetic_pair
    want, want_dropped = _without_uid_and_timing(jax_dir / "result.txt")
    got, got_dropped = _without_uid_and_timing(port_dir / "result.txt")
    assert got == want
    # 4 blocks x (model line + 2 timing lines); the uids themselves match
    assert got_dropped == want_dropped == 12
    jax_lines = (jax_dir / "result.txt").read_text().splitlines()
    port_lines = (port_dir / "result.txt").read_text().splitlines()
    assert [ln for ln in port_lines if _UID.search(ln)] == [
        ln for ln in jax_lines if _UID.search(ln)
    ]
    # the LR block's prediction sample (filter class 5) is among the
    # compared lines: its probability strings are equal digit for digit
    start = next(i for i, ln in enumerate(port_lines) if ln.startswith("LogisticRegression_"))
    sample = [ln for ln in port_lines[start:start + 12] if "|[0." in ln]
    assert len(sample) == 5 and all(ln in got for ln in sample)


def test_metric_csvs_equal_outside_time_columns(synthetic_pair):
    jax_dir, port_dir, _, _ = synthetic_pair
    for name in ARTIFACTS[1:]:
        got, want = _csv_rows(port_dir / name), _csv_rows(jax_dir / name)
        assert got == want, name
        assert len(got) == (1 if name.startswith("crossFold") else 3)


def test_accuracies_equal_and_pinned(synthetic_pair):
    _, _, jax, port = synthetic_pair
    assert port["accuracies"] == jax["accuracies"]
    assert port["accuracies"] == SYNTHETIC_ACCURACIES
    assert set(port["artifacts"]) == set(jax["artifacts"]) >= {"result", "csv", "cv_csv"}


def test_charts_match_jax(synthetic_pair, tmp_path, monkeypatch):
    """The chart PNGs are the same files as the JAX run's, and without
    matplotlib the port writes none and still returns."""
    jax_dir, port_dir, _, _ = synthetic_pair
    want = sorted(p.name for p in jax_dir.glob("Graph *.png"))
    assert sorted(p.name for p in port_dir.glob("Graph *.png")) == want
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert port_charts.save_metric_charts(
        str(port_dir / "additional_param.csv"), None, str(tmp_path)
    ) == []


@requires_wisdm
def test_reference_csv_accuracies(tmp_path_factory, wisdm_csv_path):
    """On the reference CSV: equal to har_tpu's and to the reference's
    printed accuracies."""
    _, _, jax, port = _run_both(
        tmp_path_factory,
        JaxRunConfig(data=JaxDataConfig(dataset="wisdm", path=wisdm_csv_path)),
        RunConfig(data=DataConfig(dataset="wisdm", path=wisdm_csv_path)),
    )
    assert port["accuracies"] == jax["accuracies"]
    assert {k: round(v, 5) for k, v in port["accuracies"].items()} == REFERENCE_ACCURACIES


def _metrics(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "accuracy": rng.random(), "weightedPrecision": rng.random(),
        "weightedRecall": rng.random(), "f1": rng.random(), "areaUnderROC": rng.random(),
        "areaUnderPR": rng.random(), "rmse": rng.random(), "mse": rng.random(),
        "r2": rng.random(), "mae": rng.random(), "count_total": 10.0,
        "count_correct": 7.0, "count_wrong": 3.0,
        "confusion_matrix": [[4.0, 1.0], [2.0, 3.0]],
        "precision_per_class": [0.6, 0.75], "recall_per_class": [0.8, 0.6],
        "f1_per_class": [0.69, 0.67],
    }


@pytest.mark.parametrize("quirks", [False, True])
def test_report_writer_quirks_match_jax(tmp_path, quirks):
    """reference_quirks prints the RMSE value under the MSE label and
    leaves out the per-class extras."""
    texts, csvs = [], []
    for pkg, (writer_cls, result_cls) in (
        ("jax", (JaxReportWriter, JaxModelResult)),
        ("port", (ReportWriter, ModelResult)),
    ):
        out = tmp_path / pkg
        writer = writer_cls(str(out), class_names=["a", "b"], reference_quirks=quirks)
        for i, is_cv in enumerate((False, True)):
            result = result_cls(name=f"m{i}", metrics=_metrics(i), train_time_s=1.5,
                                test_time_s=0.25, is_cv=is_cv, display_name=f"M{i}")
            writer.model_block(result)
        writer.save()
        texts.append(writer.text())
        csvs.append([(out / n).read_text() for n in ARTIFACTS[1:]])
    assert texts[1] == texts[0]
    assert csvs[1] == csvs[0]
    mse_line = next(ln for ln in texts[1].splitlines() if ln.startswith("Mean Squared"))
    assert mse_line.endswith(f"{_metrics(0)['rmse' if quirks else 'mse']:.6g}")
    assert ("Per-Class Metrics" in texts[1]) == (not quirks)


def test_report_save_overwrites(tmp_path):
    """A second save rewrites the CSVs: one header, unlike the reference's
    append mode."""
    writer = ReportWriter(str(tmp_path), class_names=["a", "b"])
    for i, is_cv in enumerate((False, True)):
        writer.model_block(ModelResult(name=f"m{i}", metrics=_metrics(i), train_time_s=1.5,
                                       test_time_s=0.25, is_cv=is_cv, display_name=f"M{i}"))
    first = writer.save()
    writer.save()
    for key in ("csv", "cv_csv"):
        text = pathlib.Path(first[key]).read_text()
        assert text.count("Classifier,") == 1 and len(text.splitlines()) == 2


def test_cli_parity_dt_block_on_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("HAR_TPU_WISDM_CSV", str(tmp_path / "absent.csv"))
    out = tmp_path / "out"
    rc = cli.main(["parity", "--device", "cpu", "--blocks", "dt",
                   "--output-dir", str(out)])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["accuracies"] == {"decision_tree": 1494 / TEST_ROWS}
    assert (out / "result.txt").is_file() and (out / "additional_param.csv").is_file()
    assert not (out / "crossFold_additional_param.csv").exists()


def test_cli_parity_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["parity", "--blocks", "dt", "--output-dir", str(tmp_path)])
    assert not (tmp_path / "result.txt").exists()

