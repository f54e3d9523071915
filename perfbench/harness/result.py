"""What a driver hands back, and the run's last line."""

from __future__ import annotations

import dataclasses
import json
import math
import sys

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "har_tpu")


@dataclasses.dataclass
class Observed:
    """What a per-layer reader reads: ``trace`` (a TraceSummary),
    ``counters`` (numbers the driver took over the traced region), the
    cell, its reference module (the closed forms) and the card's peak
    bf16 FLOP/s (None where the yardstick does not know the card)."""

    trace: object
    counters: dict
    cell: object
    reference: object
    peak_flops: float | None = None


@dataclasses.dataclass
class RunOutput:
    """One run of one cell, as its driver measured it.

    ``e2e``: end-to-end values by metric name (``setup_s`` included);
    ``checks``: each compared number with its limit, in the order
    printed; ``observed``: what the per-layer readers read (the trace
    summary, counters, the configuration's closed forms)."""

    attempted: int
    failed: int
    e2e: dict[str, float]
    checks: dict[str, tuple[float, float]]
    memory_peak_bytes: int
    observed: object = None

    @property
    def correct(self) -> bool:
        return all(math.isfinite(v) and v <= limit for v, limit in self.checks.values())


def limited(ctx, numbers: dict[str, float]) -> dict[str, tuple[float, float]]:
    """The numbers that the cell's limits file compares, each with its
    limit; the others (numbers no control separates from the program's
    own readings, named in PERF.md) go to standard error as readings."""
    limits = ctx.cell.limits
    for name, value in numbers.items():
        if name not in limits:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    return {name: (numbers[name], float(limits[name])) for name in limits}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    jaxlib's, flax's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES})


def result_line(out: RunOutput, metrics: dict[str, tuple[float, str]], device: dict,
                breakdown: dict | None) -> str:
    """The contract's last line: ``checks`` comes last."""
    line = {
        "correct": out.correct,
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": {k: {"value": float(v), "unit": u} for k, (v, u) in metrics.items()},
        "device": device,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": float(v), "limit": float(lim)}
                      for k, (v, lim) in out.checks.items()}
    return json.dumps(line)


def check_lines(out: RunOutput) -> list[str]:
    return [f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}"
            for k, (v, lim) in out.checks.items()]
