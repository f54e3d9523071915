"""The knee of an open-loop fleet cell: the highest offered rate it
sustains, found once by a sweep on the chip.

    python3 perfbench/sweep.py --workload wide_tfm.fleet_rate \
        --rates 6000 8000 10000 12000 --seconds 10

For each rate, the cell's own driver runs a window with the mix's
``offered_windows_per_s`` set to it, and one JSON line reports what was
offered and answered, the windows shed, the queue when the schedule
ended and the event tail.  The knee is the highest rate with nothing
shed and a queue at the end no longer than one target batch (the queue
starts empty).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

import run  # noqa: E402


def main(argv=None, *, require_cuda: bool = True) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=2**31 + 424242)
    args = p.parse_args(argv)
    run.pin_caches()
    run.add_paths()
    import torch

    from harness import spec

    cell = spec.find_cell(spec.load_json(run.ROOT / "BENCHMARK.json"), args.workload, run.ROOT)
    if require_cuda and not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0) if require_cuda else torch.device("cpu")
    reference = spec.load_module(cell.reference_path, "perfbench_reference")
    driver = spec.load_module(cell.driver_path)
    knee = None
    for rate in args.rates:
        traffic = dict(cell.traffic, offered_windows_per_s=rate)
        ctx = run.Context(cell=dataclasses.replace(cell, traffic=traffic), reference=reference,
                          seed=args.seed, seconds=args.seconds, trace=False, device=device,
                          t_start=time.perf_counter())
        s, recorder, out = driver.measure(ctx)
        loop = s["open_loop"]
        row = {"offered_windows_per_s": rate, "attempted": out.attempted,
               "answered_in_window_per_s": loop["answered_in_window"] / loop["window_s"],
               "shed": s["acct"]["dropped"], "queue_at_close": loop["queue_at_close"],
               "event_p95_ms": out.e2e["event_p95_ms"]}
        sustained = (row["shed"] == 0
                     and loop["queue_at_close"] <= traffic["fleet"]["target_batch"])
        row["sustained"] = sustained
        if sustained:
            knee = rate
        print(json.dumps(row), flush=True)
    print(json.dumps({"cell": cell.name, "knee_windows_per_s": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
