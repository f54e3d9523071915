"""One steady region of a window under ``torch.profiler``, summarised.

The region runs inside the span ``perfbench.window``; the harness opens
its own spans inside it (``perfbench.fit``, ``perfbench.push``,
``perfbench.poll``, ``perfbench.flush``) around its calls into the
program.  On exit the device is synchronised, the trace is written to a
temporary file under ``TMPDIR``, read back and deleted, and reduced to:

- ``busy_s``: the union of the device's operations (kernels, copies,
  sets) inside the region; ``window_s``: the region's length;
- ``device_ops``: seconds by kernel name;
- ``idle_gaps``: every interval inside the region that no device
  operation covers, named by the innermost harness span open on the
  host when it began;
- ``k2``: each launch of kernel K2 (``csrc/flash_attention.cu``, names
  ``flash_fwd_f32*`` and ``flash_fwd_bf16*``) with its seconds and, through the launching op
  ``har_tpu_torch::flash_attention_fwd``, its (B, T, H, D) and element
  size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import tempfile

import torch

from harness.yardstick import ELEMENT_BYTES

WINDOW_SPAN = "perfbench.window"
SPAN_PREFIX = "perfbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernels of csrc/flash_attention.cu (flash_fwd_f32, flash_fwd_bf16,
# flash_fwd_bf16_streamed, in an anonymous namespace), by name, demangled
# ("(anonymous namespace)::flash_fwd_bf16<64>(...)") or mangled
# ("_ZN12_GLOBAL__N_114flash_fwd_bf16...")
K2_KERNEL = re.compile(r"(?:^|[\s:\d])flash_fwd_(?:f32|bf16)")
K2_OP = "har_tpu_torch::flash_attention_fwd"


def span(name: str):
    """A harness span (``record_function``) around a call into the program."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def kernel_base_name(name: str) -> str:
    """A kernel's name without its return type: ``void f<64>(...)`` →
    ``f<64>(...)``."""
    return name[5:] if name.startswith("void ") else name


@dataclasses.dataclass
class K2Launch:
    seconds: float
    shape: tuple[int, int, int, int] | None
    element_bytes: int | None


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: list[list]
    idle_gaps: list[list]
    k2: list[K2Launch]
    k2_ops: int
    # False where no device was traced (a CPU run): device readers then
    # read nothing
    device_traced: bool = True

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": self.device_ops[:top], "idle_gaps": self.idle_gaps[:top]}


def _union(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def summarise(events: list[dict]) -> TraceSummary:
    """Reduce a chrome trace's ``traceEvents`` (times in microseconds)."""
    complete = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in complete if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    device = []
    for e in complete:
        if e.get("cat") in DEVICE_CATS:
            a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
            if b > a:
                device.append((a, b, e))
    busy_us = _union([(a, b) for a, b, _ in device])

    by_name: dict[str, float] = {}
    for a, b, e in device:
        name = kernel_base_name(e["name"])[:160]
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    device_ops = sorted(([n, s] for n, s in by_name.items()), key=lambda r: -r[1])

    spans = sorted(
        ((e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN_PREFIX):]) for e in complete
         if e.get("cat") == "user_annotation" and e["name"].startswith(SPAN_PREFIX)
         and e["name"] != WINDOW_SPAN),
        key=lambda s: s[0])
    gaps = []
    end = w0
    for a, b, _ in sorted(device, key=lambda r: r[0]):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:50]:
        open_spans = [s for s in spans if s[0] <= a < s[1]]
        name = min(open_spans, key=lambda s: s[1] - s[0])[2] if open_spans else "outside_spans"
        named.append([name, (b - a) * 1e-6])

    # K2's op calls in time order, keyed by the External id that links a
    # kernel to the op that launched it
    calls = []
    for e in complete:
        if e.get("name") == K2_OP and e.get("cat") == "cpu_op":
            args = e.get("args", {})
            dims = args.get("Input Dims") or []
            types = args.get("Input type") or []
            shape = tuple(int(v) for v in dims[0]) if dims and len(dims[0]) == 4 else None
            calls.append((e["ts"], args.get("External id"), shape,
                          ELEMENT_BYTES.get(types[0] if types else ""), e["ts"] + e["dur"]))
    calls.sort(key=lambda c: c[0])
    by_id = {c[1]: c for c in calls}
    # a call that holds another (the op under its autograd wrapper) is one
    # launch: keep the innermost
    calls = [c for c, nxt in zip(calls, calls[1:] + [None]) if nxt is None or nxt[0] >= c[4]]
    kernels = sorted(((a, b, e) for a, b, e in device
                      if e.get("cat") == "kernel" and K2_KERNEL.search(e["name"])),
                     key=lambda r: r[0])
    linked = [by_id.get(e.get("args", {}).get("External id")) for _, _, e in kernels]
    if None in linked and len(kernels) == len(calls):
        # under autograd the kernel's External id is another op's: each
        # call launches one kernel, so pair them in order
        linked = calls
    k2 = [K2Launch(seconds=(b - a) * 1e-6, shape=c[2] if c else None,
                   element_bytes=c[3] if c else None)
          for (a, b, _), c in zip(kernels, linked)]
    k2_ops = len(calls)
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                        device_ops=device_ops, idle_gaps=named, k2=k2, k2_ops=k2_ops)


class Tracer:
    """``with Tracer(device) as t:`` profiles the block; ``t.summary``
    holds its :class:`TraceSummary` afterwards."""

    def __init__(self, device: torch.device):
        self.device = device
        self.summary: TraceSummary | None = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = self._stack.enter_context(
            torch.profiler.profile(activities=activities, record_shapes=True))
        self._stack.enter_context(torch.profiler.record_function(WINDOW_SPAN))
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._stack.close()
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = summarise(events)
        self.summary.device_traced = self.device.type == "cuda"
        return False
