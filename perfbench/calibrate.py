"""Readings for setting a cell's correctness limits, at the cell's own size.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --control 3 \
        [--fault half_batch:3] [--out chiprun_out/calibrate_<cell>.jsonl]

Runs, in one process, the cell's driver's ``calibrate`` for the program
on ``--seeds`` seeds, for the control (the reference in the precision
below the configuration's, put in the program's place) on ``--control``
seeds, and for each planted fault on its count of seeds; prints one JSON
line a reading, with ``correct`` as a run's comparison
(``harness.result.limited`` against the cell's limits file) decides it,
and, last, for every number the largest program reading (the lower end
of its limit) and the smallest reading of the control and of each fault
(the upper end), and for each kind whether every reading came out as it
must: the program's correct, the control's and each fault's not.  Exits
5 where one did not.  The program's readings may also come from the
cell's own runs, which print them under ``checks``.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))

import run  # noqa: E402

FIRST_SEED = 2**31 + 12345
SEED_STRIDE = 1_000_003


def main(argv=None, *, require_cuda: bool = True) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault", action="append", default=[],
                   help="NAME:SEEDS, a fault the driver can plant")
    p.add_argument("--seconds", type=float, default=None,
                   help="each run's window (default: BENCHMARK.json's run_seconds)")
    p.add_argument("--first-seed", type=int, default=FIRST_SEED)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    run.pin_caches()
    run.add_paths()
    from harness import spec
    from harness.result import RunOutput, limited

    import torch

    bench = spec.load_json(run.ROOT / "BENCHMARK.json")
    cell = spec.find_cell(bench, args.workload, run.ROOT)
    seconds = bench["run_seconds"] if args.seconds is None else args.seconds
    device = torch.device("cuda", 0) if require_cuda else torch.device("cpu")
    if require_cuda and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    reference = spec.load_module(cell.reference_path, "perfbench_reference")
    driver = spec.load_module(cell.driver_path)
    plan = [("program", args.seeds), ("control", args.control)]
    plan += [(f.split(":")[0], int(f.split(":")[1])) for f in args.fault]
    rows = []
    out = open(args.out, "a") if args.out else None
    try:
        for kind, count in plan:
            for i in range(count):
                seed = args.first_seed + SEED_STRIDE * i
                ctx = run.Context(cell=cell, reference=reference, seed=seed, seconds=seconds,
                                  trace=False, device=device, t_start=time.perf_counter())
                t0 = time.perf_counter()
                numbers = driver.calibrate(ctx, kind)
                compared = {k: v for k, v in numbers.items() if k != "diagnostics"}
                with contextlib.redirect_stderr(io.StringIO()):
                    checks = limited(ctx, compared)
                correct = RunOutput(0, 0, {}, checks, 0).correct
                row = {"cell": cell.name, "kind": kind, "seed": seed,
                       "seconds": time.perf_counter() - t0, "correct": correct, **numbers}
                rows.append(row)
                line = json.dumps(row)
                print(line, flush=True)
                if out:
                    print(line, file=out, flush=True)
    finally:
        if out:
            out.close()
    names = [k for k in rows[0]
             if k not in ("cell", "kind", "seed", "seconds", "correct", "diagnostics")]
    summary = {}
    for name in names:
        summary[name] = {}
        for kind, _ in plan:
            values = [r[name] for r in rows if r["kind"] == kind]
            if values:
                # the program's largest reading is the limit's lower end,
                # the control's and each fault's smallest its upper end
                summary[name][kind] = max(values) if kind == "program" else min(values)
    # the program has to come out correct on every seed, the control and
    # each fault not correct on any
    as_must = {kind: all(r["correct"] == (kind == "program") for r in rows if r["kind"] == kind)
               for kind, count in plan if count}
    print(json.dumps({"cell": cell.name, "summary": summary, "as_must": as_must}), flush=True)
    return 0 if all(as_must.values()) else 5


if __name__ == "__main__":
    sys.exit(main())
