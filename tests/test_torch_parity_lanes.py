"""parity's UCI-HAR and raw-WISDM lanes, and the calibrated raw stream,
against the JAX package.

Neither the published "UCI HAR Dataset" archive nor a real
``WISDM_ar_v1.1_raw.txt`` is in the repository, so both lanes are held on
fixtures in the real formats: the skip and too-few markers, then a run on
a small fixture whose split counts (and for UCI-HAR the CV's best grid
point) equal the JAX package's.  The assertions on real data (the paper's
0.91 band, the 0.97 raw target) wait for those files, as in
tests/test_ucihar.py and tests/test_wisdm_raw_lane.py.
"""

import json

import numpy as np
import pytest
import torch

from har_tpu import parity as jax_parity
from har_tpu.data import raw_windows as jax_raw_windows
from har_tpu.data.raw_loader import load_raw_stream as jax_load_raw_stream
from har_tpu.data.raw_loader import stream_windows as jax_stream_windows
from har_tpu.data.split import split_indices as jax_split_indices
from har_tpu.data.synthetic import synthetic_wisdm as jax_synthetic_wisdm
from har_tpu_torch import cli, parity
from har_tpu_torch.data import raw_windows
from har_tpu_torch.data.raw_loader import write_raw_fixture
from har_tpu_torch.data.synthetic import synthetic_wisdm
from har_tpu_torch.data.ucihar import write_ucihar_fixture
from test_wisdm_raw_lane import _write_raw_fixture as jax_write_raw_fixture

torch.set_num_threads(1)

LANE_WINDOWS = 120
LANE_KW = dict(epochs=40, batch_size=64, channels=(32, 32))


@pytest.fixture
def isolated(monkeypatch, tmp_path):
    """No data anywhere the lanes probe."""
    monkeypatch.delenv("HAR_TPU_UCIHAR_ROOT", raising=False)
    monkeypatch.delenv("HAR_TPU_WISDM_RAW", raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))


@pytest.mark.parametrize("n_windows,seed", [(64, 1), (300, 0)])
def test_calibrated_raw_stream_bit_equal(n_windows, seed):
    ours = raw_windows.calibrated_raw_stream(synthetic_wisdm(400, seed=3), n_windows, seed)
    theirs = jax_raw_windows.calibrated_raw_stream(jax_synthetic_wisdm(400, seed=3),
                                                   n_windows, seed)
    assert ours.windows.dtype == np.float32 and ours.windows.shape == (n_windows, 200, 3)
    np.testing.assert_array_equal(ours.windows, theirs.windows)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    assert ours.class_names == theirs.class_names


def test_class_axis_stats_equal():
    table = synthetic_wisdm(200, seed=1)
    assert raw_windows._class_axis_stats(table) == jax_raw_windows._class_axis_stats(
        jax_synthetic_wisdm(200, seed=1))


def test_raw_fixture_writer_byte_equal_to_jax_tests(tmp_path):
    ours = write_raw_fixture(str(tmp_path / "port.txt"), n_windows=12, seed=2)
    theirs = jax_write_raw_fixture(tmp_path / "jax.txt", n_windows=12, seed=2)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    np.testing.assert_array_equal(ours.labels, theirs.labels)


def test_raw_lane_skips_without_a_file(isolated):
    assert parity.resolve_wisdm_raw() is None is jax_parity.resolve_wisdm_raw()
    ours = parity.wisdm_raw_lane(device="cpu")
    assert ours == jax_parity.wisdm_raw_lane()
    assert "HAR_TPU_WISDM_RAW" in ours["skipped"] and ours["target_accuracy"] == 0.97


def test_raw_lane_refuses_too_few_windows(tmp_path):
    path = str(tmp_path / "WISDM_ar_v1.1_raw.txt")
    write_raw_fixture(path, n_windows=10)
    ours = parity.wisdm_raw_lane(path, device="cpu")
    assert ours == jax_parity.wisdm_raw_lane(path)
    assert "too few" in ours["skipped"]


def test_raw_lane_on_a_fixture_file(tmp_path, monkeypatch):
    """The lane on 120 windows in the raw format, found through
    HAR_TPU_WISDM_RAW: the JAX lane's window count and 85/15 split (its
    loader and split on the same file), and a CNN that learns."""
    path = str(tmp_path / "WISDM_ar_v1.1_raw.txt")
    write_raw_fixture(path, n_windows=LANE_WINDOWS)
    monkeypatch.setenv("HAR_TPU_WISDM_RAW", path)
    assert parity.resolve_wisdm_raw() == jax_parity.resolve_wisdm_raw() == path
    out = parity.wisdm_raw_lane(device="cpu", **LANE_KW)
    windows = jax_stream_windows(jax_load_raw_stream(path), window=200)
    train, test = jax_split_indices(len(windows.labels), [0.85, 0.15], seed=7)
    assert "skipped" not in out
    assert out["n_windows"] == out["n_used"] == len(windows.labels) == LANE_WINDOWS
    assert (out["n_train"], out["n_test"]) == (len(train), len(test))
    assert out["target_met"] == (out["accuracy"] >= 0.97)
    assert out["accuracy"] > 0.7


def test_raw_lane_subsample_cap(tmp_path):
    path = str(tmp_path / "raw.txt")
    write_raw_fixture(path, n_windows=LANE_WINDOWS)
    out = parity.wisdm_raw_lane(path, device="cpu", max_windows=100, epochs=1,
                                batch_size=64, channels=(8,))
    assert (out["n_windows"], out["n_used"]) == (LANE_WINDOWS, 100)
    assert out["n_train"] + out["n_test"] == 100


def test_cli_parity_raw(isolated, tmp_path, capsys):
    assert cli.main(["parity", "--raw", "--device", "cpu"]) == 0
    assert "skipped" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    path = str(tmp_path / "few.txt")
    write_raw_fixture(path, n_windows=10)
    assert cli.main(["parity", "--raw", "--data-path", path, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "too few" in out["skipped"]


def test_lanes_need_cuda_unless_cpu(isolated, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["parity", "--raw"])
    with pytest.raises(RuntimeError, match="is_available"):
        parity.ucihar_parity_lane()


def test_ucihar_lane_skips_without_a_tree(isolated):
    ours = parity.ucihar_parity_lane(device="cpu")
    assert ours == jax_parity.ucihar_parity_lane()
    assert "HAR_TPU_UCIHAR_ROOT" in ours["skipped"]
    assert ours["expected"] == {"fig2_accuracy": 0.919, "conclusion_accuracy": 0.9102}


def test_ucihar_lane_on_a_fixture_tree(tmp_path, monkeypatch):
    """LR with its 5-fold CV over the 9-point grid on a small tree found
    through HAR_TPU_UCIHAR_ROOT: the JAX lane's split counts and best grid
    point, and its accuracy within one test row."""
    root = write_ucihar_fixture(str(tmp_path), n_train=150, n_test=60, seed=3,
                                num_features=16)
    monkeypatch.setenv("HAR_TPU_UCIHAR_ROOT", root)
    ours = parity.ucihar_parity_lane(device="cpu")
    theirs = jax_parity.ucihar_parity_lane()
    assert ours["root"] == theirs["root"] == root
    assert (ours["n_train"], ours["n_test"]) == (theirs["n_train"], theirs["n_test"])
    assert ours["n_train"] + ours["n_test"] == 210
    assert ours["best_params"] == theirs["best_params"]
    assert abs(ours["accuracy"] - theirs["accuracy"]) <= 1.0 / ours["n_test"] + 1e-4
    assert set(ours) == set(theirs)
    assert ours["within_tolerance"] == (0.8902 <= ours["accuracy"] <= 0.939)
