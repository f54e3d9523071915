"""Run one cell of the benchmark of ``har_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's entry in ``BENCHMARK.json``
names a configuration and a traffic mix; the mix's ``kind`` names the
driver (``perfbench/drivers/<kind>.py``) that sets the program up from
the seed, warms up the cell's shapes, measures for ``--seconds``, and
then judges what the timed path produced against the plain reference.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
compared number beside its limit, which also close standard error.

Exit codes: 0 a result was printed; 2 bad arguments or no such cell; 3
no CUDA card, or fewer than the cell asks for; 4 JAX, jaxlib, flax or
the JAX package was loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every build and kernel cache at a fixed path inside the checkout, so a
# second run of a cell finds what the first built
CACHE_DIR = ROOT / ".perfbench_cache"
CACHE_VARS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "CUDA_CACHE_PATH": "cuda"}


def pin_caches() -> None:
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE_DIR / sub)
    # no library the port uses may load JAX on its own
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def add_paths() -> None:
    """The checkout's root (the program) and the benchmark's folder (its
    own library) on the import path, the benchmark's first."""
    for path in (ROOT, BENCH_DIR):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


@dataclasses.dataclass
class Context:
    """What a driver is given."""

    cell: object
    reference: object
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float

    def note(self, what: str) -> None:
        """A line on standard error: ``what`` and the seconds since start."""
        print(f"perfbench: {what} at {time.perf_counter() - self.t_start:.3f} s",
              file=sys.stderr, flush=True)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, *, require_cuda: bool = True, t_start: float | None = None) -> int:
    """One run; ``require_cuda=False`` lets the CPU tests drive the rest
    of a run on the CPU (the program takes its kernels' plain versions)."""
    t_start = T_START if t_start is None else t_start
    args = parse_args(argv)
    pin_caches()
    add_paths()
    from harness import spec
    from harness.result import check_lines, forbidden_modules, result_line

    bench = spec.load_json(ROOT / "BENCHMARK.json")
    try:
        cell = spec.find_cell(bench, args.workload, ROOT)
    except KeyError as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2

    import torch

    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); "
                  f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                  f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")

    from harness import yardstick

    reference = spec.load_module(cell.reference_path, "perfbench_reference")
    driver = spec.load_module(cell.driver_path)
    ctx = Context(cell=cell, reference=reference, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, t_start=t_start)
    ctx.note(f"{cell.name} seed {args.seed}: the program's device ready")
    out = driver.run(ctx)

    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name,
           "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    breakdown = None
    if ctx.trace:
        obs = out.observed
        obs.peak_flops = yardstick.peak_bf16_flops(name)
        for op, seconds in obs.trace.device_ops[:30]:
            print(f"perfbench: device op {seconds!r} s {op}", file=sys.stderr)
        metrics = {}
        for m in cell.per_layer:
            reader = spec.load_module(cell.reader_path(m["name"]))
            value = reader.read(obs)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        dev["busy_s"] = obs.trace.busy_s
        dev["window_s"] = obs.trace.window_s
        breakdown = obs.trace.breakdown()
    else:
        metrics = {m["name"]: (out.e2e[m["name"]], m["unit"]) for m in cell.end_to_end}
    sys.stdout.flush()
    for line in check_lines(out):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(result_line(out, metrics, dev, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
