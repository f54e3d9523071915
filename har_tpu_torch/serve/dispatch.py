"""Pipelined batch dispatch for the fleet engine.

Port of ``har_tpu/serve/dispatch.py``.  The engine composes three
pieces:

  ``StagingArena`` — a preallocated contiguous ``(capacity, window,
    channels)`` staging block for queued windows (numpy, copied).  The
    assembler writes each completed window into an arena slot ONCE at
    enqueue time; batch assembly later is a single gather out of the
    block instead of ``np.stack`` over k scattered per-window
    allocations.

  ``DispatchTicket`` + the scorer family — the launch/retire split.
    ``launch(windows)`` stages the batch on the device (one copy that
    does not wait, then the forward under ``torch.no_grad()``)
    and returns the un-synchronised device tensor: CUDA runs the
    forward while the host assembles the next batch.  ``fetch(handle,
    k)`` synchronises through ``.cpu()`` and produces the same ``(k,
    C)`` float64 probabilities the synchronous path does.  Two scorers,
    one contract:

      ``HostScorer``    — ``model.transform`` verbatim (numpy stubs,
                          trees, temperature-scaled models): launch
                          computes synchronously, retire is a slice.
      ``DeviceScorer``  — models with a device forward (the NeuralModel
                          family, ``JitDemoModel``, the int8 tier, a
                          loaded ``predict.pt2``): host-side scaler at
                          launch, logits fetched and softmaxed at retire
                          with the SAME expression ``NeuralModel.
                          transform`` uses — probs are bit-identical to
                          the synchronous path.

      ``ShardedScorer`` — a DeviceScorer over a single-controller
                          serving mesh (``parallel.mesh.ServingMesh``):
                          rows split over the data axes, padded to
                          ``devices × pow2`` (``serving.pad_shard``);
                          each data shard's device holds a replica and
                          scores its own rows with no collective, and
                          the outputs are gathered to the engine's
                          device in device order.
      ``ModelParallelScorer`` — a ShardedScorer whose weights are placed
                          once over the ``tp`` axis by the family's rule
                          table; each data shard runs the tensor-
                          parallel forward of ``serve.model_parallel``
                          (K2 on each device's heads for a transformer).

The copy into a card does not wait: ``launch`` copies the host rows
into a page-locked buffer of :class:`PinnedStaging` (one host memcpy)
and from there into the card with ``non_blocking=True``, so the host
returns while the card still runs the previous dispatch's forward, as
the JAX package's ``device_put`` does.  The rule that keeps this right:
a pinned buffer is written again only after the copy that reads it has
finished — each copy records a CUDA event on the stream that runs it,
and the pool hands a buffer out again only once its events have
completed (pooled by padded shape, so the pool grows to the copies in
flight at once: about the pipeline depth, fused or bare).  A slab the
engine rewrites after ``launch`` returns can therefore never change that
ticket's result; the engine still recycles slabs and staging slots only
at retire, as the JAX package must (its ``device_put`` may alias).  On
the CPU the host array is the device tensor (no copy) and the forward
runs to its end inside ``launch``.  There is no route back to a pageable
copy into a card: a failed pin or copy raises.

The pipelining itself (double-buffered launch→retire with FIFO retire
order) lives in ``FleetServer.poll`` — retire order is the journal's
ack order, so a ticket in flight at crash time is un-acked BY
CONSTRUCTION and recovery re-scores its windows from the replayed
pushes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from har_tpu_torch.serving import pad_pow2, pad_shard

class PinnedStaging:
    """Page-locked staging buffers for the copies into a card, pooled by
    shape.

    ``put(x, targets)`` writes the host rows ``x`` into a free buffer of
    their shape, starts one ``non_blocking`` copy a target — ``(row
    slice, device)`` — and records a fence on each target's stream after
    it; the buffer goes back to the pool only when every fence has
    completed (:meth:`acquire` reaps them), so no buffer is written while
    a copy out of it may still read it.  ``pin=False`` and ``fence`` (a
    callable of the device returning an object with ``query()``) let a
    test drive the same rule on the CPU.
    """

    def __init__(self, *, pin: bool = True, fence=None):
        self._pin = pin
        self._fence = _cuda_fence if fence is None else fence
        self._free: dict[tuple, list] = {}
        self._busy: list = []  # (buffer, fences), in hand-out order
        self.allocated = 0

    def _reap(self) -> None:
        busy = []
        for buf, fences in self._busy:
            if all(f.query() for f in fences):
                self._free.setdefault(tuple(buf.shape), []).append(buf)
            else:
                busy.append((buf, fences))
        self._busy = busy

    def acquire(self, shape) -> torch.Tensor:
        """A float32 buffer of ``shape`` that no copy reads any more."""
        self._reap()
        free = self._free.get(tuple(shape))
        if free:
            return free.pop()
        self.allocated += 1
        return torch.empty(tuple(shape), dtype=torch.float32, pin_memory=self._pin)

    def in_flight(self) -> list:
        """The buffers a copy may still read (not to be handed out)."""
        return [buf for buf, fences in self._busy if not all(f.query() for f in fences)]

    def put(self, x: np.ndarray, targets) -> list:
        buf = self.acquire(x.shape)
        buf.copy_(torch.from_numpy(x))
        out = [buf[rows].to(device, non_blocking=True) for rows, device in targets]
        devices = {str(d): d for _, d in targets}
        self._busy.append((buf, [self._fence(d) for d in devices.values()]))
        return out


def _cuda_fence(device):
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class NoDeviceProgram(ValueError):
    """The model has no device forward to launch (trees, MLlib replicas,
    numpy stubs, temperature-scaled models): the one condition under
    which ``make_scorer`` serves through ``HostScorer``."""


class DispatchTicket:
    """One launched, not-yet-retired batch.

    Carries everything retire needs without touching engine state that
    may have moved on (a model swap at a later launch boundary must not
    re-score an in-flight batch): the pending entries, the padded host
    windows (retry + dispatch-tap input), the un-synchronised device
    handle, the scorer and model version that launched it, and the
    launch-time clock reads the dispatch/overlap stats are computed from.
    """

    __slots__ = (
        "batch", "k", "pad_k", "windows", "handle", "scorer", "version",
        "t0", "t_inflight0", "t_carried0", "idle_ms", "attempts",
        "failed", "last_error", "fused", "slab", "sids",
    )

    def __init__(self, batch, windows, scorer, version, t0, *,
                 fused: bool = False, slab=None):
        # ``batch`` is the int64 index array of the ticket's pending-
        # arena slots (har_tpu_torch.serve.arena.PendingArena), in FIFO
        # order; the ticket owns the queue-side reference on each
        # until retire releases it.  ``sids`` is the launch-time
        # session-id snapshot the dispatch tap consumes (captured only
        # when a tap is installed — retire could not resolve a row
        # whose session was removed mid-flight).
        self.batch = batch
        self.k = len(batch)
        self.pad_k = len(windows)
        self.windows = windows
        self.handle = None
        self.scorer = scorer
        self.version = version
        self.t0 = t0
        self.t_inflight0 = t0
        self.t_carried0 = None  # set when the ticket survives its poll
        # fused hot-loop ticket: the handle is the small (labels,
        # top_probs) device pair, and ``windows`` is a pooled staging
        # slab the engine returns to its free pool at retire (the slab
        # stays valid for the whole flight — retries and the dispatch
        # tap read it — and is only recycled after the tap has run)
        self.fused = fused
        self.slab = slab
        self.sids = None
        # deliberate carry idle (inter-poll span) accumulated before
        # retire: excluded from dispatch_ms, so the SLO ladder never
        # reads the pipeline's own buffering as a slow device
        self.idle_ms = 0.0
        self.attempts = 0  # FAILED attempts so far (retry budget used)
        self.failed = False
        self.last_error: Exception | None = None


class StagingArena:
    """Contiguous staging storage for queued windows.

    Slots recycle through a FIFO free ring (an int index ring, not a
    Python list): allocation hands out slots in the order retires
    returned them, which — because enqueue order IS launch order IS
    retire order in this engine — keeps a delivery round's staged
    windows CONTIGUOUS in the buffer in steady state.  That contiguity
    is what the zero-copy batch-assembly fast path rides: ``gather``
    returns a slice VIEW (no copy at all) and ``gather_into``
    degenerates to one contiguous block copy (no ``np.take``) whenever
    the requested slots form an ascending run; fragmented rounds
    (drops, sheds, churn punch holes in the recycle order) fall back
    to the scatter-gather path and re-converge on the next cycle.  The
    block grows geometrically when the queue outruns it (amortized —
    steady-state serving never reallocates).

    A VIEW handed to a dispatch is only safe because slot frees are
    retire-ordered: the engine frees a launched window's slot at its
    ticket's retire (after the blocking fetch — the same ordering the
    fused slab pool relies on), never mid-flight, so no re-``put`` can
    rewrite rows an un-fetched device array still aliases (CPU
    ``device_put`` aliases contiguous f32 buffers).  Growth mid-flight
    is also safe: the old buffer stays alive — and immutable — behind
    any view that still references it.
    """

    def __init__(self, window: int, channels: int, capacity: int = 512):
        self.window = int(window)
        self.channels = int(channels)
        capacity = max(int(capacity), 8)
        self._buf = np.empty(
            (capacity, self.window, self.channels), np.float32
        )
        # FIFO free ring: pow2 index buffer, monotonic head/tail
        self._free = np.empty(
            1 << (capacity - 1).bit_length(), np.int64
        )
        self._free[:capacity] = np.arange(capacity)
        self._fhead = 0
        self._ftail = capacity
        self.grows = 0

    @property
    def capacity(self) -> int:
        return len(self._buf)

    @property
    def in_use(self) -> int:
        return len(self._buf) - (self._ftail - self._fhead)

    @property
    def nbytes(self) -> int:
        """Resident bytes of the staging block (free ring included) —
        the ``staging_bytes`` footprint gauge's source."""
        return int(self._buf.nbytes) + int(self._free.nbytes)

    # ------------------------------------------------- free-slot ring

    def _free_extend(self, slots) -> None:
        m = len(slots)
        cap = len(self._free)
        if self._ftail - self._fhead + m > cap:  # pragma: no cover
            raise AssertionError("staging free-ring overflow")
        t = self._ftail & (cap - 1)
        first = min(cap - t, m)
        self._free[t: t + first] = slots[:first]
        if first < m:
            self._free[: m - first] = slots[first:]
        self._ftail += m

    def _free_popn(self, m: int) -> np.ndarray:
        cap = len(self._free)
        h = self._fhead & (cap - 1)
        first = min(cap - h, m)
        out = np.empty(m, np.int64)
        out[:first] = self._free[h: h + first]
        if first < m:
            out[first:] = self._free[: m - first]
        self._fhead += m
        return out

    def _grow(self, need: int = 0) -> None:
        """Double the block — or jump straight past ``need`` total
        slots in ONE reallocation: a 10k-session delivery round staging
        its whole window cohort must not pay log2 copies of the buffer
        on the way up (the SoA host plane's arena-sizing contract)."""
        cap = len(self._buf)
        new_cap = cap * 2
        while new_cap < need:
            new_cap *= 2
        buf = np.empty((new_cap, self.window, self.channels), np.float32)
        buf[:cap] = self._buf
        self._buf = buf
        n_free = self._ftail - self._fhead
        free = np.empty(1 << (new_cap - 1).bit_length(), np.int64)
        if n_free:
            free[:n_free] = self._free_popn(n_free)
        free[n_free: n_free + new_cap - cap] = np.arange(cap, new_cap)
        self._free = free
        self._fhead = 0
        self._ftail = n_free + new_cap - cap
        self.grows += 1

    def put(self, window: np.ndarray) -> int:
        """Stage one ``(window, channels)`` snapshot; returns its slot."""
        if self._ftail == self._fhead:
            self._grow()
        slot = self._free[self._fhead & (len(self._free) - 1)]
        self._fhead += 1
        self._buf[slot] = window
        return slot

    def put_block(self, windows: np.ndarray) -> np.ndarray:
        """Stage a ``(m, window, channels)`` block in one vectorized
        copy (the assembler's catch-up-burst path and the batched
        ``push_many`` round staging); returns the slots (an int64
        array — FIFO-recycled, so in steady state an ascending run)."""
        m = len(windows)
        if self._ftail - self._fhead < m:
            self._grow(self.in_use + m)
        slots = self._free_popn(m)
        s0 = self._run_start(slots)
        if s0 is not None:  # FIFO steady state: one basic-slice write
            self._buf[s0: s0 + m] = windows
        else:
            self._buf[slots] = windows
        return slots

    def reserve(self, m: int) -> np.ndarray:
        """Claim ``m`` slots off the FIFO free ring WITHOUT writing —
        the batched ingest reserves a whole delivery round's slots up
        front in DELIVERY order (the FIFO enqueue order), then each
        boundary-offset subgroup writes into its mapped subset
        (``put_block_pair(slots=...)``).  Assigning slots in delivery
        order is what keeps the launch-side gather a contiguous run —
        and therefore zero-copy — even when the round spans many
        subgroups."""
        if self._ftail - self._fhead < m:
            self._grow(self.in_use + m)
        return self._free_popn(m)

    def put_block_pair(
        self, head: np.ndarray, tail: np.ndarray, slots=None
    ) -> np.ndarray:
        """Stage a block of windows whose rows are each split in two
        contiguous parts — ``head[i] ++ tail[i]`` — writing BOTH parts
        straight into the staging storage (no intermediate
        concatenation).  The batched ingest path's mid-chunk window
        snapshots arrive exactly like this: the ring tail up to the
        boundary plus the chunk head that completes the window.
        ``slots`` uses pre-``reserve``d slots instead of popping."""
        m = len(head)
        if slots is None:
            if self._ftail - self._fhead < m:
                self._grow(self.in_use + m)
            slots = self._free_popn(m)
        split = head.shape[1]
        s0 = self._run_start(slots)
        if s0 is not None:  # FIFO steady state: basic-slice writes
            rows = self._buf[s0: s0 + m]
            if split:
                rows[:, :split] = head
            rows[:, split:] = tail
            return slots
        if split:
            self._buf[slots, :split] = head
        self._buf[slots, split:] = tail
        return slots

    def free(self, slot: int) -> None:
        cap = len(self._free)
        if self._ftail - self._fhead >= cap:  # pragma: no cover
            raise AssertionError("staging free-ring overflow")
        self._free[self._ftail & (cap - 1)] = slot
        self._ftail += 1

    def free_block(self, slots) -> None:
        """Vectorized retire-order free: a whole batch's slots return
        to the FIFO ring in one slice write, in their original enqueue
        order — the recycling discipline that keeps future rounds
        contiguous."""
        if len(slots):
            self._free_extend(slots)

    @staticmethod
    def _run_start(idx: np.ndarray):
        """First slot of an ascending +1 run covering the whole index
        array, or None when the request is fragmented — the zero-copy
        eligibility check (host-side index arithmetic throughout)."""
        k = len(idx)
        if not k:
            return None
        s0 = idx[0]
        if idx[k - 1] - s0 != k - 1:
            return None
        if k > 2 and not (idx[1:] - idx[:-1] == 1).all():
            return None
        return s0

    def gather_view(self, slots) -> np.ndarray | None:
        """The zero-copy batch: a slice VIEW over the staged rows when
        ``slots`` is one ascending run (the FIFO-recycled steady
        state), None when fragmented — the fused launch's exact-fit
        path, which then skips the slab entirely."""
        # host-side index-array build (no device fetch)
        # harlint: host-ok
        idx = np.asarray(slots, np.intp)
        s0 = self._run_start(idx)
        if s0 is None:
            return None
        return self._buf[s0: s0 + len(idx)]

    def gather(self, slots) -> np.ndarray:
        """One ``(k, window, channels)`` batch out of the block.  A
        FIFO-contiguous slot run returns a slice VIEW — the staged
        bytes themselves, zero copies (valid until the slots are freed
        AND re-``put``, which retire-ordered freeing defers past the
        dispatch that consumes it); fragmented requests fall back to
        the fancy-index copy."""
        # the slot list is a host-side index array; this is the index-
        # array build for the gather, not a device fetch
        # harlint: host-ok
        idx = np.asarray(slots, np.intp)
        s0 = self._run_start(idx)
        if s0 is not None:
            return self._buf[s0: s0 + len(idx)]
        return self._buf[idx]

    def gather_into(self, slots, out: np.ndarray) -> np.ndarray:
        """Gather ``slots`` into the first ``len(slots)`` rows of a
        PREALLOCATED ``out`` slab and pad the tail by repeating the last
        gathered row — the batch-assembly path of the fused dispatch
        hot loop.  A FIFO-contiguous run degenerates to one contiguous
        block copy (no ``np.take`` scatter-gather); ``out`` must
        already be sized to the scorer's padded shape, and the
        exact-fit case (``len(slots) == len(out)``) skips the tail
        fill entirely."""
        k = len(slots)
        # host-side index-array build, same as gather (no device fetch)
        # harlint: host-ok
        idx = np.asarray(slots, np.intp)
        s0 = self._run_start(idx)
        if s0 is not None:
            out[:k] = self._buf[s0: s0 + k]
        else:
            np.take(self._buf, idx, axis=0, out=out[:k])
        if k < len(out):
            out[k:] = out[k - 1]
        return out

    def state(self) -> dict:
        """Snapshot-provider payload: sizing observability only — the
        staged windows themselves ride the snapshot's existing
        ``pending`` array (gathered at snapshot time), so the on-disk
        format is unchanged and pre-arena journals restore cleanly."""
        return {
            "capacity": self.capacity,
            "in_use": self.in_use,
            "grows": self.grows,
        }


def compact_probs(
    labels: np.ndarray, top: np.ndarray, n_classes: int
) -> np.ndarray:
    """Decision-confidence surrogate distribution for the fused tier.

    The fused program retires only ``(labels, top_probs)`` — the full
    probability matrix never leaves the device.  Downstream consumers
    (vote/passthrough smoothing, events, journal acks, the shadow tap)
    still speak ``(k, C)`` distributions, so this rebuilds one on host:
    ``out[i, labels[i]] = top[i]`` and the remaining mass spread evenly
    over the other classes.  Two guarantees the retire path relies on:

      - ``argmax(out[i]) == labels[i]`` STRICTLY — the off-label mass is
        capped just below the top probability, so a journal replay that
        re-derives the raw label by argmax can never flip it on an
        exact ``top == 1/C`` tie;
      - ``out[i].sum()`` is 1 up to fp rounding, and ``out[i, labels[i]]``
        is exactly the device's top probability — the decision
        confidence every consumer reads is the real one.

    The off-label values are a surrogate (the fused tier's contract is
    LABEL equality with the unfused path, documented in serving.md);
    anything needing the true full distribution serves unfused.
    """
    k = len(labels)
    labels = np.asarray(labels, np.intp)
    top = np.asarray(top, np.float64)
    if n_classes <= 1:
        return np.ones((k, 1), np.float64)
    off = np.minimum(
        (1.0 - top) / (n_classes - 1),
        top * (1.0 - 2.0**-40),
    )
    out = np.repeat(off[:, None], n_classes, axis=1)
    out[np.arange(k), labels] = top
    return out



# --------------------------------------------------------------- scorers


class HostScorer:
    """``model.transform`` verbatim — the synchronous scorer.

    launch() computes the whole predict on the spot (host models have
    nothing to overlap), so depth-1 pipelining through this scorer is
    operation-for-operation the synchronous engine: same transform
    call, same slice, same float64 cast.
    """

    kind = "host"
    devices = 1
    model_axis_shards = 1
    device_labels = ("host",)
    supports_fused = False  # no device program to fuse into

    def __init__(self, model):
        self.model = model
        self.compiled_shapes: set[int] = set()

    def pad(self, windows: np.ndarray) -> np.ndarray:
        return pad_pow2(windows)

    def pad_size(self, k: int) -> int:
        return 1 << (max(int(k), 1) - 1).bit_length()

    def launch(self, windows: np.ndarray):
        self.compiled_shapes.add(len(windows))
        return self.model.transform(windows).probability

    def fetch(self, handle, k: int) -> np.ndarray:
        return np.asarray(handle[:k], np.float64)  # harlint: fetch-ok

    def measure(self, batch: int, iters: int = 16, *,
                fused: bool = False) -> dict:
        raise ValueError(
            "device timing needs a device forward "
            f"(got host-side {type(self.model).__name__}); "
            "e2e latency stats are still available"
        )


@dataclasses.dataclass(eq=False)
class DeviceProgram:
    """The device half of a serving model: ``forward`` maps a float32
    device tensor of windows to device logits.  ``owner`` is the object
    the program belongs to (the fused program is cached on it, so the
    cache dies with the model); ``params`` are its weight tensors, for
    ``params_bytes``."""

    owner: object
    forward: Callable
    device: torch.device
    params: tuple = ()
    supports_fused: bool = True
    # the forward on another device, where it is not a module to copy
    replicate: Callable | None = None


def _split_predict(model):
    """Decompose a serving model into ``(host_pre, DeviceProgram)`` — the
    host-side input transform (fitted scaler, or None) and the device
    forward behind it.  Only the ``scaler + inner`` chain
    (NeuralClassifierModel over NeuralModel, Int8ServingModel) is
    unwrapped: that chain's ``transform`` is exactly scaler → device
    logits → softmax, which the async path replicates bit-identically.
    Objects that carry their own program (``JitDemoModel``, the int8
    inner) expose ``device_program()``; a loaded ``predict.pt2``
    artifact (``export.ExportedPredictor``) unwraps through its
    ``serving_inner()`` adapter.  Wrappers that post-process the logits
    on the host (temperature scaling) are NOT unwrapped — they serve
    through HostScorer, whose launch IS their ``transform``.  Raises
    :class:`NoDeviceProgram` when no such chain exists (trees, MLlib
    replicas, numpy stubs)."""
    pre = None
    inner = model
    for _ in range(4):
        if hasattr(inner, "predict_logits") and hasattr(inner, "module"):
            module = inner.module.eval()  # NeuralModel
            return pre, DeviceProgram(
                inner, module, inner.device, tuple(module.parameters())
            )
        if hasattr(inner, "device_program"):
            return pre, inner.device_program()
        if hasattr(inner, "serving_inner"):
            return pre, inner.serving_inner().device_program()
        nxt = getattr(inner, "inner", None)
        if nxt is None:
            break
        pre = getattr(inner, "scaler", None) or pre
        inner = nxt
    raise NoDeviceProgram(
        "async dispatch needs a NeuralModel-backed classifier "
        f"(got {type(model).__name__})"
    )


def _host_tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor of a host device: the array itself."""
    if device.type != "cpu":
        raise ValueError(f"no staging route to {device}: the copies into a "
                         "card go through PinnedStaging")
    return torch.from_numpy(x)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fused_program(forward, pre, device):
    """cast to f32 → scaler on ``device`` → logits → softmax in f32 →
    argmax (int32) + top-prob, as one function of a device tensor."""
    mean = std = None
    if pre is not None:
        # the fitted scaler's host-side statistics, uploaded once when
        # the program is built; no device buffer is read
        # harlint: host-ok
        mean = torch.as_tensor(np.asarray(pre.mean, np.float32), device=device)
        # harlint: host-ok
        std = torch.as_tensor(np.asarray(pre.std, np.float32), device=device)

    @torch.no_grad()
    def fused(x):
        x = x.to(torch.float32)
        if mean is not None:
            x = (x - mean) / std
        probs = torch.softmax(forward(x).to(torch.float32), dim=-1)
        labels = torch.argmax(probs, dim=-1).to(torch.int32)
        return labels, probs.amax(dim=-1)

    return fused


class DeviceScorer:
    """Async launch/retire over a device forward.

    launch = host scaler + one host-to-device copy that does not wait + the
    forward under ``torch.no_grad()`` — returns the un-synchronised
    device tensor (CUDA launches are asynchronous; the card executes
    while the host moves on).  fetch = ``.cpu()`` (THE synchronisation),
    then the SAME softmax expression ``NeuralModel.transform`` uses, so
    the probabilities are bit-identical to the synchronous path for the
    same model and batch.
    """

    kind = "device"

    def __init__(self, model):
        self.model = model
        self._pre, self._program = _split_predict(model)
        self.device = self._program.device
        self.devices = 1
        self.device_labels = (
            (str(torch.cuda.current_device()),)
            if self.device.type == "cuda" else ("cpu",)
        )
        self.compiled_shapes: set[int] = set()
        # the programs this scorer dispatched, as ("bare" | "fused",
        # padded rows): the port runs eagerly, so a "program" is one
        # distinct padded shape per path (JAX compiles one per shape)
        self._programs: set[tuple[str, int]] = set()
        # the fused hot-loop program (built lazily at the first fused
        # launch): scale + logits + softmax + argmax + top-prob in ONE
        # function, retire fetching only the small (labels, top_probs)
        # pair.  Artifact-backed programs opt out.
        self.supports_fused = self._program.supports_fused
        self._fused = None
        # emulated remote-link round trip (a MODEL attribute, so the
        # engine stays knob-free): a model that sets ``tunnel_rtt_ms``
        # makes fetch block until launch+RTT — the wait pipelining
        # exists to hide, reproducible on any host.
        self.tunnel_rtt_ms = float(
            getattr(model, "tunnel_rtt_ms", 0.0) or 0.0
        )
        # the copies into a card go through pinned buffers
        self._staging = PinnedStaging() if self.device.type == "cuda" else None

    def pad(self, windows: np.ndarray) -> np.ndarray:
        return pad_pow2(windows)

    def pad_size(self, k: int) -> int:
        return 1 << (max(int(k), 1) - 1).bit_length()

    def _place(self, x: np.ndarray) -> torch.Tensor:
        # on a card, through a pinned buffer that no copy still reads;
        # on the CPU the host array is the device tensor (the forward
        # that follows runs to its end inside launch)
        x = np.ascontiguousarray(x)
        if self._staging is not None:
            return self._staging.put(x, [(slice(None), self.device)])[0]
        return _host_tensor(x, self.device)

    def _run(self, x):
        """The bare forward on placed input: device logits."""
        return self._program.forward(x)

    def _sync(self) -> None:
        _synchronize(self.device)

    def _wait_rtt(self, handle):
        if not self.tunnel_rtt_ms:
            return handle
        handle, t_launch = handle
        # the emulated link: the result is not fetchable before launch +
        # RTT.  A retire that arrives later (the host was assembling the
        # next batch) waits for only the remainder.
        wait = self.tunnel_rtt_ms / 1e3 - (time.perf_counter() - t_launch)
        if wait > 0:
            time.sleep(wait)
        return handle

    def launch(self, windows: np.ndarray):
        self.compiled_shapes.add(len(windows))
        self._programs.add(("bare", len(windows)))
        x = windows if self._pre is None else self._pre.transform(windows)
        # cast of the host-side scaler's float64 output before it is
        # placed; no device buffer is touched
        # harlint: host-ok
        x = self._place(np.asarray(x, np.float32))
        with torch.no_grad():
            handle = self._run(x)
        if self.tunnel_rtt_ms:
            return (handle, time.perf_counter())
        return handle

    def fetch(self, handle, k: int) -> np.ndarray:
        logits = self._wait_rtt(handle).cpu().numpy()  # harlint: fetch-ok (THE fetch)
        # harlint: fetch-ok
        probs = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
        return np.asarray(probs[:k], np.float64)  # harlint: fetch-ok

    # ------------------------------------------------- fused hot loop

    def _fused_fn(self):
        """THE fused device program: cast to f32 → scaler on the device
        → logits → softmax in f32 → argmax (int32) + top-prob.  Run
        eagerly: there is no compiled program to donate the input to,
        and retire fetches the small ``(labels, top_probs)`` pair
        instead of the full ``(pad_k, C)`` logits matrix.  The scaler
        runs ON the device here in f32 (the unfused path standardizes
        host-side, also in f32): elementwise, so labels — the fused
        tier's contract — are unchanged."""
        if self._fused is None:
            owner = self._program.owner
            pre = self._pre
            # cached ON the model that owns the program, so a rebuilt
            # FleetServer or a swap back reuses it and it dies with the
            # model (an ordinary gc-collectable cycle); entries are
            # (pre, fn) pairs matched by scaler identity
            entries = getattr(owner, "_har_fused_cache", None)
            if entries is None:
                entries = owner._har_fused_cache = []
            for entry_pre, fn in entries:
                if entry_pre is pre:
                    self._fused = fn
                    return fn
            fused = _fused_program(self._program.forward, pre, self._program.device)
            self._fused = fused
            entries.append((pre, fused))
        return self._fused

    def launch_fused(self, windows: np.ndarray):
        """Fused launch: place the staged slab (already f32, already
        padded — the engine's slab pool guarantees both) and run the
        one fused program, un-synchronised.  No host-side scaler, no
        dtype cast on this path."""
        self.compiled_shapes.add(len(windows))
        self._programs.add(("fused", len(windows)))
        handle = self._fused_fn()(self._place(windows))
        if self.tunnel_rtt_ms:
            return (handle, time.perf_counter())
        return handle

    def fetch_fused(self, handle, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Retire side of the fused program: synchronise on — and copy —
        only ``k`` int32 labels and ``k`` f32 top-probabilities
        (``8 × pad_k`` bytes instead of the unfused ``4 × pad_k × C``
        logits fetch; the saving is counted in
        ``FleetStats.fetch_bytes_saved``)."""
        labels, top = self._wait_rtt(handle)
        labels = labels.cpu().numpy()  # harlint: fetch-ok (THE fetch)
        top = top.cpu().numpy()  # harlint: fetch-ok
        return (
            labels[:k].astype(np.int64),
            np.asarray(top[:k], np.float64),  # harlint: fetch-ok
        )

    def program_count(self) -> int:
        """Programs this scorer dispatched, over the bare forward AND the
        fused program (a fused engine never calls the bare one).  The
        port runs eagerly, so this counts the distinct padded shapes per
        path — the same number JAX's per-shape compile count reaches for
        one scorer — and the compile-budget pin reads it unchanged."""
        return len(self._programs)

    def params_bytes(self) -> dict:
        """Weight bytes the program keeps on its device: total and the
        largest single-device share (the same on one device)."""
        total = sum(
            int(p.numel()) * p.element_size() for p in self._program.params
        )
        return {"total": total, "per_device": total}

    def measure(self, batch: int, iters: int = 16, *,
                fused: bool = False) -> dict:
        """Device p50 for one padded program AT THE SHAPE the dispatch
        path actually emits — device-resident input,
        ``torch.cuda.synchronize`` on the card, no fetch (as
        ``serving.measure_device_latency`` times the single stream).

        ``fused=True`` times the FUSED hot-loop program (scale + logits
        + softmax + argmax + top-prob, the one a fused engine actually
        runs) instead of the bare forward, so ``StreamEvent.device_ms``
        and ``dispatch_p99_attribution`` stay honest when the engine
        serves fused.  Every call (one warm-up and ``iters`` timed) runs
        the model's forward once."""
        x = self._place(np.zeros(
            (int(batch), self.model_window, self.model_channels), np.float32,
        ))
        fn = self._fused_fn() if fused else self._run
        self._programs.add(("fused" if fused else "bare", int(batch)))
        times = []
        with torch.no_grad():
            fn(x)  # warm
            self._sync()
            for _ in range(iters):
                t0 = time.perf_counter()
                fn(x)
                self._sync()
                times.append((time.perf_counter() - t0) * 1e3)
        return {
            "batch": int(batch),
            "iters": int(iters),
            "fused": bool(fused),
            "p50_ms": round(float(np.percentile(times, 50)), 3),
            "min_ms": round(min(times), 3),
        }

    # geometry for measure(); the engine stamps these after construction
    model_window = 200
    model_channels = 3
    # model-axis shard count: 1 everywhere except ModelParallelScorer
    model_axis_shards = 1


def _canonical(device) -> torch.device:
    """``cuda`` with its index filled in, so one card compares equal to
    itself however it was named."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class ShardedScorer(DeviceScorer):
    """DeviceScorer with the batch split over a serving mesh.

    The mesh is a single-controller ``parallel.mesh.ServingMesh``: rows
    split over its data axes, one block a data shard, each placed on its
    shard's first device with one host-to-device copy; that device holds
    a replica of the model (the model's own program where the devices
    are one, a copy of its module or its artifact loaded again on any
    other, made when the scorer is built) and scores its own rows, with
    no collective.  The shards'
    logits are gathered to the engine's device in device order.  Batches
    pad to ``devices × pow2`` (``serving.pad_shard``), so per device
    count the program budget stays the same log2 ladder the single-device
    policy pins.
    """

    kind = "sharded"

    def __init__(self, model, mesh, *, replicas: bool = True):
        super().__init__(model)
        from har_tpu_torch.parallel.mesh import data_shard_count

        self.mesh = mesh
        self.devices = data_shard_count(mesh)
        grid = mesh.devices.reshape(self.devices, -1)
        self._shard_devices = [_canonical(d) for d in grid[:, 0]]
        # one label per mesh cell, its position in the grid (the JAX
        # package's device ids on its dry-run mesh): every cell's share
        # of a batch lands in the device-windows gauge
        self.device_labels = tuple(str(k) for k in range(grid.size))
        cards = all(d.type == "cuda" for d in self._shard_devices)
        self._staging = PinnedStaging() if cards else None
        self._replicas: dict = {}
        if replicas:
            for i in range(self.devices):
                self._shard_forward(i)

    def pad(self, windows: np.ndarray) -> np.ndarray:
        return pad_shard(windows, self.devices)

    def pad_size(self, k: int) -> int:
        per = -(-max(int(k), 1) // self.devices)
        return self.devices * (1 << (per - 1).bit_length())

    def _place(self, x: np.ndarray) -> list:
        # one copy a shard out of one pinned buffer, as DeviceScorer._place
        x = np.ascontiguousarray(x)
        per = len(x) // self.devices
        rows = [slice(i * per, (i + 1) * per) for i in range(self.devices)]
        if self._staging is not None:
            return self._staging.put(x, list(zip(rows, self._shard_devices)))
        return [_host_tensor(x[r], d) for r, d in zip(rows, self._shard_devices)]

    def _shard_forward(self, i: int):
        """Data shard ``i``'s forward: the model's program on its own
        device, a copy of its module (or the program's own replica) on
        any other."""
        device = self._shard_devices[i]
        fwd = self._replicas.get(device)
        if fwd is None:
            fwd = self._program.forward
            if device != _canonical(self._program.device):
                if isinstance(fwd, torch.nn.Module):
                    import copy

                    fwd = copy.deepcopy(fwd).to(device)
                elif self._program.replicate is not None:
                    fwd = self._program.replicate(device)
                else:
                    raise ValueError(
                        f"{type(self.model).__name__}'s program cannot be "
                        f"copied to {device}"
                    )
            self._replicas[device] = fwd
        return fwd

    def _gather(self, outs):
        return torch.cat([o.to(self.device) for o in outs])

    def _run(self, parts):
        return self._gather([self._shard_forward(i)(x) for i, x in enumerate(parts)])

    def _sync(self) -> None:
        devices = {_canonical(d) for d in (*self.mesh.devices.flat, self.device)}
        for d in sorted(devices, key=str):
            _synchronize(d)

    def _fused_fn(self):
        if self._fused is None:
            progs = [
                _fused_program(self._shard_forward(i), self._pre, d)
                for i, d in enumerate(self._shard_devices)
            ]

            def fused(parts):
                outs = [f(x) for f, x in zip(progs, parts)]
                return (self._gather([o[0] for o in outs]),
                        self._gather([o[1] for o in outs]))

            self._fused = fused
        return self._fused


class ModelParallelScorer(ShardedScorer):
    """ShardedScorer with the WEIGHTS placed over the mesh's model axis.

    The 2D ``(dp, tp)`` layout: rows split over the data axes exactly as
    in ShardedScorer (``pad_shard`` pads per BATCH-shard count), while the
    model's weight leaves split over ``tp`` in the layout of the family's
    partition-rule table (``parallel.rules``, the tables the tp trainer
    reads; ``rules`` overrides it).  Placement happens ONCE, here; every
    launch (bare, fused, calibration) runs the tensor-parallel forward of
    ``serve.model_parallel`` on the placed leaves, one data shard at a
    time.  Per-device residency is the sharded leaves' 1/tp share,
    reported by ``params_bytes`` (an int8 tier counts its stored leaves,
    as the JAX package counts its program's weight inputs).

    The placement is a runtime resource like the mesh: a journal recovery
    or an engine ``resize`` onto a model-axis mesh rebuilds the scorer,
    which re-places the weights through the same table.  A model whose
    layout does not divide the mesh raises
    ``model_parallel.NotModelParallel``, and ``make_scorer`` takes the
    batch-only rung; a program with no tensor-parallel forward here (a
    sequence-sharded transformer, an int8 artifact without its leaf
    record) raises ``model_parallel.NoTensorParallelForward``, which it
    lets through.  A loaded artifact is served as the JAX package serves
    its exported program: a float one whole on each row's first device
    (no weight leaves), an int8 one by its recorded weight leaves
    (``model_parallel._artifact_program``).
    """

    kind = "model_parallel"

    def __init__(self, model, mesh, rules=None):
        super().__init__(model, mesh, replicas=False)
        from har_tpu_torch.parallel.mesh import model_shard_count
        from har_tpu_torch.serve.model_parallel import tp_program

        self._tp = tp_program(model, self._program, mesh, rules)
        self.rules = self._tp.rules
        self.param_specs = self._tp.specs
        self.model_axis_shards = model_shard_count(mesh)

    def _shard_forward(self, i: int):
        return lambda x: self._tp.forward_row(i, x)

    def params_bytes(self) -> dict:
        return self._tp.params_bytes()


def make_scorer(model, mesh=None, *, tier: str = "f32",
                window: int = 200, channels: int = 3, rules=None):
    """The one scorer-selection policy: a mesh with a model axis
    (``tp > 1``) gets the 2D model-parallel path (weights placed once via
    the family's partition-rule table — ``rules`` overrides the
    auto-detected table), any other >1-device mesh the batch-sharded
    path, a model with a device forward the async single-device path,
    and everything else (the models :func:`_split_predict` refuses with
    :class:`NoDeviceProgram`) the synchronous HostScorer.  A host model,
    or a layout that does not divide the mesh (hidden dims or heads),
    takes the next rung down, as in the JAX package; any other error
    propagates: a program with no tensor-parallel forward in the port
    (``model_parallel.NoTensorParallelForward``) is refused on a model
    axis rather than served on fewer devices than asked, and a device
    program that fails to build is never quietly served on the host.
    Model swaps rebuild the scorer — the engine calls this again with
    the new model.

    ``tier="int8"`` serves the weight-only int8 quantization of the
    model (har_tpu_torch.quantize.quantize_serving) behind the SAME
    ticket / fused-program interface; a model that is already
    int8-backed (``Int8ServingModel``, an int8 artifact) passes through
    unchanged, and a host-only model raises ValueError (there is no
    device program to quantize)."""
    if tier == "int8":
        from har_tpu_torch.quantize import Int8ServingModel, quantize_serving

        if not isinstance(model, Int8ServingModel) and not bool(
            getattr(model, "int8_weights", False)
        ):
            model = quantize_serving(model)
    elif tier != "f32":
        raise ValueError(f"unknown serving tier {tier!r}")
    scorer = None
    if mesh is not None:
        from har_tpu_torch.parallel.mesh import data_shard_count, model_shard_count
        from har_tpu_torch.serve.model_parallel import NotModelParallel

        if model_shard_count(mesh) > 1:
            try:
                scorer = ModelParallelScorer(model, mesh, rules=rules)
            except (NoDeviceProgram, NotModelParallel):
                scorer = None
        if scorer is None and data_shard_count(mesh) > 1:
            try:
                scorer = ShardedScorer(model, mesh)
            except NoDeviceProgram:
                scorer = None
    if scorer is None:
        try:
            scorer = DeviceScorer(model)
        except NoDeviceProgram:
            scorer = HostScorer(model)
    scorer.model_window = int(window)
    scorer.model_channels = int(channels)
    return scorer
