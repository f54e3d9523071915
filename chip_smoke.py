#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero without the final ``ok`` line:

1. device: the card's name and power limit (nvidia-smi) and torch's view;
2. build: every kernel of har_tpu_torch/csrc compiled with nvcc, timed;
3. hist: kernel K1 against its plain PyTorch version on the card, at the
   test shapes and the main path's shapes: exact for integer weights,
   rtol 1e-5 for random float32 weights; kernel, plain and one-hot-matmul
   times from CUDA events and the least time the card could take;
4. agree: the port's DT and RF grown on the card equal the same trees grown
   on the CPU with the plain histogram (600 rows, 8 trees);
5. main: ``har_tpu_torch.cli train --models dt rf --no-cv --device cuda`` on
   the 5,418-row synthetic WISDM table at the reference's widths (DT depth
   3; RF 100 trees, depth 4, seed 3), with the kernel's launch count;
6. with ``--profile`` only: one DT and one RF fit under torch.profiler;
7. the kernels line, then ``{"ok": true, "device": {...}}``.

It needs one CUDA card and the repository beside it; it writes the main
path's artifacts under har_tpu_torch/_build/chip_smoke/ (git-ignored).
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from har_tpu_torch import cli  # noqa: E402
from har_tpu_torch.config import DataConfig, RunConfig  # noqa: E402
from har_tpu_torch.models.forest import TREE_BATCH, RandomForestClassifier  # noqa: E402
from har_tpu_torch.models.tree import DecisionTreeClassifier  # noqa: E402
from har_tpu_torch.ops import _build  # noqa: E402
from har_tpu_torch.ops import hist as hist_ops  # noqa: E402
from har_tpu_torch.runner import featurize, load_dataset  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
# and float32 adds/s outside the tensor cores (67 TFLOP/s counts an FMA
# as two operations; an add takes the same issue slot as an FMA)
HBM_BYTES_PER_S = 3.35e12
F32_ADDS_PER_S = 67e12 / 2

# the main path's histogram shapes (n train rows, d one-hot features, B
# bins, WC = 2**depth nodes * 6 classes, T trees per launch)
N, D, B, C = 3793, 730, 32, 6
DT_SHAPE = dict(n=N, d=D, bins=B, wc=2**3 * C, trees=1)
RF_SHAPE = dict(n=N, d=D, bins=B, wc=2**4 * C, trees=TREE_BATCH)
CHECK_SHAPES = {
    "test_300x7_b8_wc12": dict(n=300, d=7, bins=8, wc=12, trees=1),
    "test_513x130_b4_wc6": dict(n=513, d=130, bins=4, wc=6, trees=1),
    "tree_axis_300x7_b8_wc12_t3": dict(n=300, d=7, bins=8, wc=12, trees=3),
    "dt": DT_SHAPE,
    "rf_chunk": RF_SHAPE,
    "rf_last_chunk": dict(RF_SHAPE, trees=100 % TREE_BATCH),
}
# har_tpu on the CPU, same synthetic table and split: 1494 of 1625 right
DT_EXPECTED_CORRECT, TEST_ROWS = 1494, 1625
RF_MIN_ACCURACY = 0.75


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tree_level_inputs(n, d, bins, wc, trees, integer=True, seed=0):
    """bins and m as a tree level builds them: each row's weight (1, or a
    Poisson count for a forest) in one (node, class) column per tree; or,
    with integer=False, dense uniform float32 weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = torch.randint(0, bins, (n, d), generator=g, device="cuda", dtype=torch.int32)
    if not integer:
        return b, torch.rand((trees, n, wc), generator=g, device="cuda")
    slot = torch.randint(0, wc, (trees, n, 1), generator=g, device="cuda")
    w = torch.ones((trees, n, 1), device="cuda")
    if trees > 1:
        w = torch.poisson(w, generator=g)
    m = torch.zeros((trees, n, wc), device="cuda").scatter_(2, slot, w)
    return b, m


def library_hist(b, m, bins):
    """One PyTorch call chain computing the same function, as a yardstick:
    the materialized one-hot and a batched matmul."""
    n, d = b.shape
    onehot = torch.nn.functional.one_hot(b.long(), bins).to(torch.float32)
    return torch.matmul(m.transpose(1, 2), onehot.reshape(n, d * bins))


def bound(b, m, out) -> tuple[float, str]:
    """Least milliseconds for the card: each input read once, the output
    written once, and one add per nonzero weight and feature."""
    nbytes = sum(t.numel() * t.element_size() for t in (b, m, out))
    adds = int(torch.count_nonzero(m)) * b.shape[1]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = adds / F32_ADDS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    emit(
        "device", nvidia_smi=smi, capability=list(torch.cuda.get_device_capability(0)),
        torch=torch.__version__, cuda=torch.version.cuda, **device,
    )
    return device


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [
            line.strip()
            for line in _build.PTXAS_LOG.get(name, "").splitlines()
            if "registers" in line or "spill" in line
        ]
        for name in libs
    }
    emit("build", seconds=seconds, libraries=[p.name for p in libs.values()],
         ptxas=ptxas)


def phase_hist() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err = 0.0
    for name, s in CHECK_SHAPES.items():
        shape = (s["n"], s["d"], s["bins"], s["wc"], s["trees"])
        b, m = tree_level_inputs(*shape, integer=True, seed=1)
        got, want = hist_ops.hist(b, m, s["bins"]), hist_ops.hist_plain(b, m, s["bins"])
        torch.cuda.synchronize()
        int_diff = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"hist {name}: integer weights differ by {int_diff}")
        b, m = tree_level_inputs(*shape, integer=False, seed=2)
        got, want = hist_ops.hist(b, m, s["bins"]), hist_ops.hist_plain(b, m, s["bins"])
        f32_diff = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
        max_err = max(max_err, int_diff, f32_diff)
        emit("hist_check", shape=name, **s, max_abs_diff_int=int_diff,
             max_abs_diff_f32=f32_diff, max_rel_diff_f32=rel)

    timings = {}
    for name, s in (("dt", DT_SHAPE), ("rf_chunk", RF_SHAPE)):
        b, m = tree_level_inputs(s["n"], s["d"], s["bins"], s["wc"], s["trees"], seed=3)
        out = hist_ops.hist(b, m, s["bins"])
        if not torch.equal(library_hist(b, m, s["bins"]), out):
            raise AssertionError(f"one-hot matmul disagrees with hist at {name}")
        bound_ms, bound_by = bound(b, m, out)
        timings[name] = dict(
            shape=s,
            kernel_ms=cuda_ms(lambda: hist_ops.hist(b, m, s["bins"])),
            plain_ms=cuda_ms(lambda: hist_ops.hist_plain(b, m, s["bins"])),
            library_ms=cuda_ms(lambda: library_hist(b, m, s["bins"])),
            bound_ms=bound_ms,
            bound_by=bound_by,
        )
        emit("hist_time", name=name, **timings[name])
    return dict(max_abs_err=max_err, timings=timings)


def _tree_arrays(model):
    if hasattr(model, "tree"):
        t = model.tree
        return [t.feature, t.threshold, t.leaf_class, t.leaf_probs, t.leaf_counts]
    return [model.feature, model.threshold, model.leaf_probs]


def phase_agree() -> None:
    """Trees grown on the card equal the same trees grown on the CPU: the
    bootstrap and feature draws come from one CPU generator and the
    histograms are exact, so every split must be the same."""
    config = RunConfig(data=DataConfig(synthetic_rows=600))
    train, _, _ = featurize(config, load_dataset(config))
    for est in (DecisionTreeClassifier(), RandomForestClassifier(num_trees=8)):
        on_card = _tree_arrays(est.fit(train))
        on_cpu = _tree_arrays(est.copy_with(device="cpu").fit(train))
        for a, b in zip(on_card, on_cpu):
            if not (a.shape == b.shape and (a == b).all()):
                raise AssertionError(f"{type(est).__name__}: card and CPU trees differ")
    emit("agree", rows=600, models=["decision_tree", "random_forest"], equal=True)


def phase_main() -> dict:
    out_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke"
    dt, rf = DecisionTreeClassifier(), RandomForestClassifier()
    expected = dt.max_depth + math.ceil(rf.num_trees / TREE_BATCH) * rf.max_depth
    argv = ["train", "--models", "dt", "rf", "--no-cv", "--device", "cuda",
            "--output-dir", str(out_dir)]
    printed = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    hist_ops.HIST_LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = hist_ops.HIST_LAUNCHES
    peak_bytes = torch.cuda.max_memory_allocated()
    result = json.loads(printed.getvalue().strip().splitlines()[-1])
    for name in ("result.txt", "additional_param.csv", "timing.csv"):
        if not (out_dir / name).is_file():
            raise AssertionError(f"main path wrote no {name}")
    with open(out_dir / "timing.csv", newline="") as f:
        timing = {row["section"]: float(row["seconds"]) for row in csv.DictReader(f)}
    acc = result["accuracies"]
    emit("main", rc=rc, seconds=seconds, launches=launches,
         expected_launches=expected, accuracies=acc, timing=timing,
         peak_device_bytes=peak_bytes)
    if rc != 0:
        raise AssertionError(f"cli returned {rc}")
    if launches != expected:
        raise AssertionError(f"hist launched {launches} times, expected {expected}")
    if acc["decision_tree"] != DT_EXPECTED_CORRECT / TEST_ROWS:
        raise AssertionError(f"DT accuracy {acc['decision_tree']} != 1494/1625")
    if not acc["random_forest"] >= RF_MIN_ACCURACY:
        raise AssertionError(f"RF accuracy {acc['random_forest']} < {RF_MIN_ACCURACY}")
    return dict(launches=launches)


def phase_profile() -> None:
    """Device time of one DT and one RF fit at full width under
    torch.profiler: kernel time by name and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    config = RunConfig()
    train, _, _ = featurize(config, load_dataset(config))
    for est in (DecisionTreeClassifier(), RandomForestClassifier()):
        est.fit(train)  # warm: the kernel is loaded, caches are filled
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.fit(train)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            est.fit(train)
            torch.cuda.synchronize()
            profiled_s = time.perf_counter() - t0
        # device-side events only (kernels, copies, memsets): the aten ops
        # that launched them carry the same time again
        events = [
            e
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("Activity Buffer")
        ]
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        device_us = sum(e.self_device_time_total for e in events)
        emit(
            "profile",
            model=type(est).__name__,
            fit_s=fit_s,
            profiled_fit_s=profiled_s,
            device_s=device_us / 1e6,
            device_busy_share=device_us / 1e6 / profiled_s,
            top=[
                dict(name=e.key[:80], device_ms=e.self_device_time_total / 1e3,
                     calls=e.count)
                for e in events[:8]
            ],
        )


def main(argv: list[str]) -> int:
    device = phase_device()
    phase_build()
    hist = phase_hist()
    phase_agree()
    main_path = phase_main()
    if "--profile" in argv:
        phase_profile()
    rf = hist["timings"]["rf_chunk"]
    kernel = dict(
        name="hist",
        route="cuda",
        source="har_tpu_torch/csrc/hist.cu",
        replaces="har_tpu/ops/pallas_hist.py:56",
        launches=main_path["launches"],
        max_abs_err=hist["max_abs_err"],
        ms=rf["kernel_ms"],
        kernel_ms=rf["kernel_ms"],
        max_abs_diff=hist["max_abs_err"],
        plain_ms=rf["plain_ms"],
        bound_ms=rf["bound_ms"],
        bound_by=rf["bound_by"],
        library_ms=rf["library_ms"],
        shape="rf_chunk",
        per_shape=hist["timings"],
    )
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
