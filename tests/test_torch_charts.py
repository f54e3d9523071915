"""`train` writes har_tpu's metric charts (the reference's Graph.xlsx
role): the port's runner calls its ``reporting.charts.save_metric_charts``
where ``har_tpu/runner.py`` does, after the report and before
``timing.csv``.  Both packages' runs of ``--models dt``, with and without
CV, write the same chart files and the same ``report_paths`` keys.
Without matplotlib (the card's machine) both write none.
"""

import os

import pytest
import torch

import har_tpu.runner as jax_runner
from har_tpu.config import DataConfig as JaxDataConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu_torch import cli
from har_tpu_torch import runner as port_runner
from har_tpu_torch.config import DataConfig, RunConfig

torch.set_num_threads(1)

ROWS = 300


def _files(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, fs in os.walk(root) for f in fs if f.endswith(".png")
    )


@pytest.mark.parametrize("with_cv", [False, True])
def test_dt_run_writes_har_tpu_chart_set(tmp_path, with_cv):
    pytest.importorskip("matplotlib")
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    want = jax_runner.run(
        JaxRunConfig(data=JaxDataConfig(synthetic_rows=ROWS), output_dir=str(jax_out)),
        models=["decision_tree"], with_cv=with_cv,
    )
    got = port_runner.run(
        RunConfig(data=DataConfig(synthetic_rows=ROWS), output_dir=str(port_out)),
        models=["decision_tree"], with_cv=with_cv, device="cpu",
    )
    assert set(got.report_paths) == set(want.report_paths)
    assert "charts" in got.report_paths
    assert os.path.relpath(got.report_paths["charts"], port_out) == os.path.relpath(
        want.report_paths["charts"], jax_out)
    charts = _files(port_out)
    assert charts == _files(jax_out)
    assert len(charts) == (8 if with_cv else 4)  # 4 metric charts a CSV


def test_cli_train_writes_the_charts(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    rc = cli.main(["train", "--models", "dt", "--no-cv", "--device", "cpu",
                   "--output-dir", str(tmp_path)])
    assert rc == 0
    assert len(_files(tmp_path)) == 4


def test_without_matplotlib_no_charts_and_no_key(tmp_path, monkeypatch):
    """The card's machine has no matplotlib: the run still ends, writes
    no chart and records no ``charts`` path, as har_tpu's does."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    got = port_runner.run(
        RunConfig(data=DataConfig(synthetic_rows=ROWS), output_dir=str(tmp_path)),
        models=["decision_tree"], with_cv=False, device="cpu",
    )
    assert set(got.report_paths) == {"result", "csv", "timing"}
    assert _files(tmp_path) == []
