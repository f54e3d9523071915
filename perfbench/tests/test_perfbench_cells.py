"""The benchmark driven on the CPU at tiny sizes: the result line, the
checks, the faults that must turn ``correct`` false, and a cell added by
files alone."""

from __future__ import annotations

import json

import pytest

import tiny

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell,metric", [
    ("tiny.train", "train_windows_per_s"),
    ("tiny.fleet_backlog", "serve_windows_per_s"),
    ("tiny.fleet_rate", "event_p95_ms"),
])
def test_last_line_has_the_contract_keys(root, cell, metric):
    rc, line, err = tiny.run_cell(root, cell)
    assert rc == 0, err
    assert list(line) == LINE_KEYS
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {metric, "setup_s"}
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # the checks close standard error too, each beside its limit
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.fleet_backlog"])
def test_traced_run_prints_breakdown_and_no_device_metric_on_the_cpu(root, cell):
    rc, line, err = tiny.run_cell(root, cell, trace=1)
    assert rc == 0, err
    assert list(line) == LINE_KEYS[:5] + ["breakdown", "checks"]
    assert line["correct"] is True
    # a CPU run writes no number under a device metric's name
    for name in line["metrics"]:
        assert not name.startswith(("device_idle", "k2_roofline")) and "mfu" not in name
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,fault,number", [
    ("tiny.train", "half_batch", "rows_short"),
    ("tiny.train", "unchanged_state", "update_gap"),
    ("tiny.train", "stale_moments", "grad_gap"),
    ("tiny.fleet_backlog", "altered_answer", "prob_gap"),
    ("tiny.fleet_backlog", "half_batch", "unaccounted"),
    ("tiny.fleet_rate", "altered_answer", "prob_gap"),
    ("tiny.fleet_rate", "half_batch", "unaccounted"),
])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, number):
    rc, line, err = tiny.run_cell(root, cell, fault=fault, seconds=2.0)
    assert rc == 0, err
    assert line["correct"] is False
    check = line["checks"][number]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_the_control_is_not_correct_by_the_runs_own_comparison(root, cell):
    """The control's readings go through the comparison a run makes
    (``limited`` against the cell's limits file) and come out not
    correct, while the program's come out correct."""
    rc, rows, err = tiny.run_calibrate(root, cell, ["--seeds", "1", "--control", "1",
                                                     "--seconds", "1"])
    assert rc == 0, err
    *readings, summary = rows
    assert summary["as_must"] == {"program": True, "control": True}
    assert [r["correct"] for r in readings if r["kind"] == "control"] == [False]
    assert [r["correct"] for r in readings if r["kind"] == "program"] == [True]


def test_no_card_exits_without_a_result(root):
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "tiny.train",
                           "--seed", "1", "--seconds", "1"], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 3
    assert proc.stdout.strip() == ""


def test_a_cell_added_by_files_alone_runs(root, tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric: only
    new files and new entries, no file of the benchmark edited."""
    import shutil

    new = tmp_path / "checkout"
    shutil.copytree(root, new)
    bench = json.loads((new / "BENCHMARK.json").read_text())
    config = dict(tiny.TINY_CONFIG, name="tiny_wide", hidden_size=32, intermediate_size=128,
                  num_attention_heads=4)
    config["program"] = {"model": "transformer",
                         "kwargs": {"embed_dim": 32, "num_heads": 4, "num_layers": 1,
                                    "dropout_rate": 0.0, "dtype": "bfloat16"}}
    tiny.write_json(new / "perfbench" / "configs" / "tiny_wide.json", config)
    tiny.write_json(new / "perfbench" / "traffic" / "fits_tiny_b64.json",
                    dict(tiny.TRAIN_MIX, batch_size=64, rows=384))
    tiny.write_json(new / "perfbench" / "limits" / "tiny_wide.train.json",
                    dict(tiny.TRAIN_LIMITS, grad_gap=0.05, update_gap=0.05))
    (new / "perfbench" / "metrics" / "fits_in_trace.py").write_text(
        '"""fits_in_trace: windows the traced fit trained."""\n\n\n'
        "def read(obs):\n    return obs.counters.get(\"windows_in_trace\")\n")
    bench["configs"].append({"name": "tiny_wide", "source": config["source"],
                             "file": "perfbench/configs/tiny_wide.json", "reduced": [],
                             "why": "added by files"})
    bench["workloads"].append({"name": "tiny_wide.train", "config": "tiny_wide",
                               "traffic": "fits_tiny_b64", "chips": 1, "why": "added by files"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_windows_per_s":
            m["workloads"].append("tiny_wide.train")
    bench["per_layer"].append({"name": "fits_in_trace", "unit": "windows", "better": "higher",
                               "source": "program_counter", "layer": "benchmark",
                               "moves": "train_windows_per_s",
                               "workloads": ["tiny_wide.train"]})
    tiny.write_json(new / "BENCHMARK.json", bench)
    for name in ("harness", "drivers", "reference", "run.py"):
        assert (new / "perfbench" / name).exists()
    rc, line, err = tiny.run_cell(new, "tiny_wide.train")
    assert rc == 0, err
    assert line["correct"] is True, line["checks"]
    rc, line, err = tiny.run_cell(new, "tiny_wide.train", trace=1)
    assert rc == 0, err
    assert line["metrics"]["fits_in_trace"]["value"] == 384
