"""What the per-layer readers under ``perfbench/metrics`` share.

A reader that finds nothing to read returns None, and the run leaves its
metric out of the line; no share of a peak or a roofline is ever
reported as 0 for want of a reading.
"""

from __future__ import annotations

from harness.yardstick import flash_bound_s


def mfu_pct(obs, train: bool) -> float | None:
    """The configuration's model FLOPs (its reference's closed form) for
    the windows the traced region completed, over the region's time, as
    a share of the card's peak bf16 rate."""
    windows = obs.counters.get("windows_in_trace")
    if (not obs.trace.device_traced or not windows or obs.peak_flops is None
            or obs.trace.window_s <= 0):
        return None
    flops = obs.reference.flops_per_window(obs.cell.config, train) * windows
    return 100.0 * flops / obs.trace.window_s / obs.peak_flops


def k2_roofline_pct(obs) -> float | None:
    """K2's least time (``yardstick.flash_bound_s`` at each launch's
    shape) over the profiler's time in K2's kernels, in %.  None where
    the traced region launched no K2; an error where the region called
    the op but the trace shows no kernel of ``csrc/flash_attention.cu``
    (a renamed kernel must fail loudly, not read 0), or a launch whose
    shape the trace does not give."""
    launches = obs.trace.k2
    if not obs.trace.device_traced:
        return None
    if not launches:
        if obs.trace.k2_ops:
            raise RuntimeError(
                f"{obs.trace.k2_ops} calls of K2's op but no kernel of "
                "csrc/flash_attention.cu in the trace")
        return None
    bound = 0.0
    for launch in launches:
        if launch.shape is None or launch.element_bytes is None:
            raise RuntimeError("a K2 kernel whose launching op's shape the trace lacks")
        bound += flash_bound_s(*launch.shape, launch.element_bytes)
    return 100.0 * bound / sum(launch.seconds for launch in launches)


def device_idle_pct(obs) -> float | None:
    """The share of the traced region that no device operation covers."""
    if not obs.trace.device_traced or obs.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)


def counter(obs, name: str) -> float | None:
    value = obs.counters.get(name)
    return None if value is None else float(value)
