"""A throwaway checkout for the benchmark's CPU tests: a copy of
``perfbench/`` beside a ``BENCHMARK.json`` of tiny cells, and a runner
that drives ``run.py`` there on the CPU in a fresh interpreter (the
program takes its kernels' plain versions)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

TINY_CONFIG = {
    "name": "tiny_tfm", "source": "https://arxiv.org/abs/1706.03762",
    "hidden_size": 16, "num_attention_heads": 2, "intermediate_size": 64,
    "num_hidden_layers": 1, "window": 20, "channels": 3, "num_classes": 6,
    "dtype": "bfloat16", "reference": "transformer1d",
    "program": {"model": "transformer",
                "kwargs": {"embed_dim": 16, "num_heads": 2, "num_layers": 1,
                           "dropout_rate": 0.0, "dtype": "bfloat16", "use_flash": True}},
    "reduced": [],
}
TRAIN_MIX = {"kind": "train_fits", "rows": 256, "batch_size": 32, "epochs": 1,
             "learning_rate": 0.003, "weight_decay": 1e-4, "warmup_fraction": 0.1}
FLEET = {"target_batch": 16, "pipeline_depth": 3, "max_delay_ms": 50.0, "fused": False}
BACKLOG_MIX = {"kind": "fleet", "arrivals": "backlog", "sessions": 64, "hop": 20, "chunk": 20,
               "pool_windows": 128, "smoothing": "ema", "ema_alpha": 0.4, "fleet": FLEET,
               "check_sessions": 16}
RATE_MIX = dict(BACKLOG_MIX, arrivals="poisson", chunk=10, offered_windows_per_s=400)
TRAIN_LIMITS = {"init_gap": 0.0, "rows_short": 0.0, "logits_gap": 0.02, "loss_gap": 0.003,
                "grad_gap": 0.02, "update_gap": 0.02, "final_gap": 0.02}
FLEET_LIMITS = {"prob_gap": 0.005, "order_faults": 0.0, "missing": 0.0, "unaccounted": 0.0}

CELLS = {
    "tiny.train": ("fits_tiny", TRAIN_MIX, TRAIN_LIMITS, "train_windows_per_s"),
    "tiny.fleet_backlog": ("fleet_tiny_backlog", BACKLOG_MIX, FLEET_LIMITS, "serve_windows_per_s"),
    "tiny.fleet_rate": ("fleet_tiny_rate", RATE_MIX, FLEET_LIMITS, "event_p95_ms"),
}


def write_json(path: Path, value) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(value, indent=1))


def make_root(tmp: Path) -> Path:
    """A checkout in ``tmp``: the benchmark's files, tiny cells, and the
    program reached through the import path."""
    shutil.copytree(BENCH, tmp / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    write_json(tmp / "perfbench" / "configs" / "tiny_tfm.json", TINY_CONFIG)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_tfm", "source": TINY_CONFIG["source"],
                             "file": "perfbench/configs/tiny_tfm.json", "reduced": [],
                             "why": "a size a CPU test holds"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for cell, (mix, traffic, limits, metric) in CELLS.items():
        write_json(tmp / "perfbench" / "traffic" / f"{mix}.json", traffic)
        write_json(tmp / "perfbench" / "limits" / f"{cell}.json", limits)
        bench["workloads"].append({"name": cell, "config": "tiny_tfm", "traffic": mix,
                                   "chips": 1, "why": "a CPU test"})
        e2e[metric].setdefault("workloads", []).append(cell)
    write_json(tmp / "BENCHMARK.json", bench)
    return tmp


RUNNER = """
import json, runpy, sys
from pathlib import Path
root = Path(sys.argv[1])
args = json.loads(sys.argv[2])
fault = sys.argv[3]
run = runpy.run_path(str(root / "perfbench" / "run.py"), run_name="perfbench_run")
run["add_paths"]()
from harness import spec
import contextlib
ctx = contextlib.nullcontext()
if fault:
    bench = spec.load_json(root / "BENCHMARK.json")
    cell = spec.find_cell(bench, args[1], root)
    ctx = spec.load_module(cell.driver_path, "fault_driver").FAULTS[fault]()
with ctx:
    sys.exit(run["main"](args, require_cuda=False))
"""


def run_cell(root: Path, cell: str, seed: int = 2**31 + 7, seconds: float = 1.0,
             trace: int = 0, fault: str = "", timeout: int = 300):
    """``run.py`` for ``cell`` on the CPU; returns (exit code, the last
    line of standard output parsed, standard error)."""
    args = ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", RUNNER, str(root), json.dumps(args), fault],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=root)
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, last, proc.stderr


CALIBRATE = """
import json, runpy, sys
from pathlib import Path
root = Path(sys.argv[1])
calibrate = runpy.run_path(str(root / "perfbench" / "calibrate.py"), run_name="perfbench_calibrate")
sys.exit(calibrate["main"](json.loads(sys.argv[2]), require_cuda=False))
"""


def run_calibrate(root: Path, cell: str, args: list[str], timeout: int = 300):
    """``calibrate.py`` for ``cell`` on the CPU; returns (exit code, its
    JSON lines parsed, standard error)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", CALIBRATE, str(root),
                           json.dumps(["--workload", cell, *args])],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=root)
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return proc.returncode, rows, proc.stderr
