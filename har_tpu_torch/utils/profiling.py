"""Tracing and step timing for the run report and ``timing.csv``.

The reference's observability is `time.time()` pairs around each
fit/transform printed into the report (reference Main/main.py:116-124 and
five sibling blocks).  :class:`StepTimer` keeps those semantics (label →
seconds) and :func:`write_timing_csv` persists them next to the metric CSVs.
:func:`trace` (``train --trace-dir``) wraps a block in ``torch.profiler``
and writes a TensorBoard-loadable trace to a directory, as the JAX
package's wraps ``jax.profiler``.

On a CUDA device the timer synchronizes at both ends of a section: PyTorch
returns before the device finishes, so without the synchronize a section
would measure the enqueue, not the work.  StepTimer is host-observed time
(dispatch, transfers and device work); kernel times come from CUDA events
in chip_smoke.py.
"""

from __future__ import annotations

import contextlib
import csv
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None, device: torch.device | str = "cuda"):
    """``with trace("/tmp/trace", device):`` profiles the block with
    ``torch.profiler`` and writes its trace (``*.pt.trace.json``, which
    TensorBoard's profiler plugin and Perfetto read) into ``log_dir``:
    CPU and CUDA activity on a CUDA device, CPU activity only on the
    CPU.  Pass None to disable (the context is then free), so a pipeline
    can accept an optional ``--trace-dir`` and leave the call site
    unchanged."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class Section:
    """One timed interval; ``.seconds`` is set when its block exits."""

    seconds: float = 0.0


class StepTimer:
    """Labelled wall-clock sections: ``with timer("lr_fit") as s: ...``.

    Repeated labels accumulate in the per-label totals (epochs, CV
    cells); the yielded :class:`Section` always holds just the interval
    its own block measured, so callers reporting a single fit don't pick
    up earlier runs under the same label.  ``rate(label, count)`` derives
    items/s the way the benchmark counts windows/s.  ``device``: the torch
    device whose queued work a section waits for at both ends (only a
    CUDA device needs it).
    """

    def __init__(self, device: torch.device | str = "cpu"):
        self._sync = torch.device(device).type == "cuda"
        self._totals: dict[str, float] = {}
        self._counts: dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, label: str):
        section = Section()
        if self._sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield section
        finally:
            if self._sync:
                torch.cuda.synchronize()
            section.seconds = time.perf_counter() - t0
            self._totals[label] = (
                self._totals.get(label, 0.0) + section.seconds
            )
            self._counts[label] = self._counts.get(label, 0) + 1

    @property
    def seconds(self) -> dict[str, float]:
        return dict(self._totals)

    def calls(self, label: str) -> int:
        return self._counts.get(label, 0)

    def rate(self, label: str, items: int) -> float:
        total = self._totals.get(label, 0.0)
        return items / total if total > 0 else 0.0

    def rows(self) -> list[dict]:
        return [
            {
                "section": label,
                "seconds": round(total, 6),
                "calls": self._counts[label],
            }
            for label, total in self._totals.items()
        ]


def write_timing_csv(path: str, timer: StepTimer) -> str:
    """Persist section timings (the CSVs' sibling artifact, `timing.csv`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=["section", "seconds", "calls"]
        )
        writer.writeheader()
        writer.writerows(timer.rows())
    return path
