"""Real-time streaming inference: sliding-window HAR classification.

Port of ``har_tpu/serving.py``'s single-stream half.  The host parts
(``StreamEvent``, ``finite_rows``, ``pad_pow2``, ``pad_shard``, the ring
buffer ``_WindowAssembler``, the ``_Smoother``, ``SessionResult`` and
``classify_session``'s strided view) are numpy, copied; the model runs on
its own device (``checkpoint.load_model(path, device)``, default ``cuda``).

  ``StreamingClassifier``  — ring-buffer sliding windows over an
    incremental sample stream; one predict per hop, plus probability
    smoothing (EMA or k-window majority vote), because single-window
    flips are the dominant error mode of deployed HAR.

  ``classify_session``  — offline replay of a recorded stream at full
    batch throughput: strided window view → one batched ``transform``.
    Equal to streaming the same samples with smoothing off on the CPU
    (tested: tests/test_torch_serving.py); on the card a batch of 1 and
    one of 111 may take different GEMM kernels, so labels are held equal
    there and the probabilities within bf16's rounding.

Catch-up bursts (a transport hiccup delivers seconds of samples at once)
are scored in BATCHED predicts — one per 256 completed windows, padded to
power-of-two batch shapes — instead of one round trip per hop; smoothing
still runs sequentially, so events are identical to hop-by-hop pushes.

Device timing (``device_latency_ms``) runs the bare forward on a
device-resident input and waits with ``torch.cuda.synchronize`` (where
JAX waited with ``block_until_ready``), never fetching the result, so
the gap to the per-hop end-to-end time is host staging, copies and the
softmax on the host.  The fleet engine that multiplexes many such
streams through one predict path is ``har_tpu_torch.serve``.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One classification emitted at a hop boundary."""

    t_index: int  # stream sample index of the window END (exclusive)
    label: int  # smoothed class decision
    raw_label: int  # this window's own argmax (pre-smoothing)
    probability: np.ndarray  # (C,) decision distribution: EMA-smoothed
    #   probs ("ema"), trailing vote fractions ("vote"), or the window's
    #   own probs ("none"); probability[label] is the decision confidence
    latency_ms: float  # wall-clock of the predict for this window
    drift: bool = False  # input stream out of training distribution
    #   (only when a monitoring.DriftMonitor is attached; see
    #   StreamingClassifier(monitor=...))
    device_ms: float | None = None  # calibrated DEVICE share of
    #   latency_ms for this window's dispatch (None before a device
    #   calibration exists); latency_ms - device_ms is host/transfer
    #   overhead — what lets a serving consumer attribute a p99 spike
    #   to the host vs the card per event


def _percentile(values: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def finite_rows(
    samples: np.ndarray, max_abs: float | None = 1e6
) -> tuple[np.ndarray, int]:
    """THE ingest guard shared by StreamingClassifier.push and
    FleetServer.push: drop sample rows that are non-finite (NaN/Inf) or
    wildly out of range (any |value| > max_abs; None disables the range
    check).  Returns ``(clean_rows, n_rejected)``.

    One poisoned row would otherwise ride a window into the device
    predict and NaN-poison the whole micro-batch — on the fleet path
    that is 256 sessions' windows dying to one broken sensor.  Rejection
    is per ROW and silent by design (counted, never raised): the
    serving loop must keep serving the finite samples it does get.

    ONE reduction over the pushed block classifies all three failure
    modes: the per-row abs-max is NaN for any NaN entry, +inf for any
    ±Inf entry, and > max_abs for an out-of-range one — so a single
    ``m <= max_abs`` comparison (NaN/Inf both compare False against any
    finite bound) replaces the separate isfinite + range passes.  The
    equivalence with the two-pass guard is test-pinned on poisoned
    streams.

    Fast path first: the CHUNK-level scalar abs-max answers the common
    all-clean case in one reduction with no per-row bookkeeping at all
    (a NaN/Inf/out-of-range entry makes the scalar fail its bound
    check, falling through to the row-classifying path) — at fleet
    ingest rates the guard runs per delivery chunk for thousands of
    sessions per round, and the row machinery was measurably on the
    serving hot path.
    """
    if samples.size == 0:
        return samples, 0
    # no errstate on the fast path: abs/max propagate NaN silently and
    # the scalar comparison below is plain Python — only the per-row
    # classification needs the invalid-compare guard
    chunk_max = float(np.abs(samples).max())
    clean = (
        chunk_max <= max_abs  # NaN/Inf compare False: fall through
        if max_abs is not None
        else np.isfinite(chunk_max)
    )
    if clean:
        return samples, 0
    with np.errstate(invalid="ignore"):
        m = np.abs(samples).max(axis=-1)
        if max_abs is not None:
            good = m <= max_abs
        else:
            # range check disabled: only NaN/Inf rows are rejected
            good = np.isfinite(m)
    n_bad = int(len(good) - good.sum())
    if n_bad:
        return samples[good], n_bad
    return samples, 0


def pad_pow2(windows: np.ndarray) -> np.ndarray:
    """Pad a ``(k, ...)`` batch to the next power-of-two rows by
    repeating the last row — THE batch-shape policy of every scoring
    path (streaming catch-up bursts, fleet dispatches, shadow mirrors),
    so at most log2(max_batch)+1 batch shapes ever reach the device
    (the JAX package's compiled-program budget, kept so the two
    packages score the same batches)."""
    k = len(windows)
    pad_k = 1 << (k - 1).bit_length()
    if pad_k == k:
        return windows
    return np.concatenate(
        [windows, np.repeat(windows[-1:], pad_k - k, axis=0)]
    )


def pad_shard(windows: np.ndarray, shards: int = 1) -> np.ndarray:
    """Pad a ``(k, ...)`` batch to ``shards × pow2(ceil(k / shards))``
    rows by repeating the last row — the batch-shape policy of the
    mesh-sharded dispatch path (har_tpu.serve.dispatch).  The leading
    dim always divides the shard count (a NamedSharding over the batch
    axis needs it), and per device count the padded sizes still walk a
    power-of-two ladder, so at most log2(max_batch)+1 programs compile
    per device shape — the same compiled-program budget as the
    single-device ``pad_pow2`` policy (``shards=1`` is exactly it)."""
    k = len(windows)
    per = -(-k // shards)  # ceil
    pad_k = shards * (1 << (per - 1).bit_length())
    if pad_k == k:
        return windows
    return np.concatenate(
        [windows, np.repeat(windows[-1:], pad_k - k, axis=0)]
    )


def _device_program(model):
    """(forward on a device tensor, its device) behind any serving
    wrapper chain; see :func:`device_predict_fn`.  The fleet's
    ``serve.dispatch._split_predict`` owns the unwrapping; timing also
    looks through a temperature (``.model``), which the fleet serves on
    the host."""
    from har_tpu_torch.serve.dispatch import NoDeviceProgram, _split_predict

    inner = model
    while not hasattr(inner, "inner") and hasattr(inner, "model"):
        inner = inner.model  # TemperatureScaledModel: host-side division
    try:
        _, program = _split_predict(inner)
    except NoDeviceProgram:
        raise ValueError(
            "device timing needs a NeuralModel-backed or exported-"
            f"artifact classifier (got {type(model).__name__}); "
            "e2e latency stats are still available"
        ) from None
    return program.forward, program.device


def device_predict_fn(model):
    """The device forward behind any serving wrapper chain.

    Unwraps NeuralClassifierModel's ``.inner`` and
    TemperatureScaledModel's ``.model`` (the device program is the same
    base forward either way — temperature and scaler are host-side); an
    ExportedPredictor (torch.export artifact) is reached via its
    ``device_call``.  Shared by ``StreamingClassifier.device_latency_ms``
    and ``classify_session(timing=True)`` so both report the same
    device-vs-host decomposition.  Raises ValueError for models without
    a device forward (trees, MLlib replicas, host-side stubs).
    """
    return _device_program(model)[0]


def measure_device_latency(
    model, *, window: int, channels: int, batch: int = 1, iters: int = 16
) -> dict:
    """Device launch+compute p50 for one ``(batch, window, channels)``
    predict: device-resident input, ``torch.cuda.synchronize`` on a CUDA
    device, no host staging, no scaler, no result fetch.  See
    ``StreamingClassifier.device_latency_ms`` for the interpretation."""
    fn, device = _device_program(model)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    x = torch.zeros((batch, window, channels), dtype=torch.float32, device=device)
    times = []
    with torch.no_grad():
        fn(x)  # warm
        sync()
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(x)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
    return {
        "batch": batch,
        "iters": iters,
        "p50_ms": round(_percentile(times, 50), 3),
        "min_ms": round(min(times), 3),
    }


class _WindowAssembler:
    """Ring-buffer sliding-window ingestion over an incremental stream.

    One implementation shared by the single-stream StreamingClassifier
    and the fleet engine's per-session state (har_tpu.serve): a
    multiplexed session therefore produces bit-identical window
    snapshots — and drift verdicts, which are chunk-cadence-dependent
    EWMAs — to a standalone classifier fed the same delivery chunks.
    """

    __slots__ = (
        "window", "hop", "channels", "monitor", "drift_report",
        "_ring", "_n_seen", "_next_emit",
    )

    def __init__(
        self, window: int, hop: int, channels: int, monitor=None,
        ring: np.ndarray | None = None,
    ):
        self.window = window
        self.hop = hop
        self.channels = channels
        self.monitor = monitor
        self.drift_report = None
        # ``ring`` — optional externally-owned storage (must arrive
        # zeroed): the fleet engine's session arena passes one row of
        # its contiguous ring block here (har_tpu.serve.arena), so ten
        # thousand sessions share one allocation instead of ten
        # thousand scattered ones.  The assembler's logic is identical
        # either way — which is the bit-identity argument for the
        # structure-of-arrays host plane.
        self._ring = (
            np.zeros((window, channels), np.float32)
            if ring is None
            else ring
        )
        self._n_seen = 0
        self._next_emit = window

    @property
    def n_seen(self) -> int:
        return self._n_seen

    def consume(
        self, samples: np.ndarray, sink=None
    ) -> list[tuple[int, object, bool]]:
        """Absorb ``(n, channels)`` samples; return the ``(t_index,
        window_snapshot, drift)`` tuple for every hop boundary they
        complete (scoring is the caller's job).

        ``sink`` — optional staging target with ``put(window) -> token``
        (and optionally ``put_block(windows) -> [token]``): each
        completed window is written ONCE into the sink's storage and the
        returned tuples carry the token instead of a fresh array copy.
        The fleet engine passes its contiguous staging arena here
        (har_tpu.serve.dispatch.StagingArena), so batch assembly later
        is a gather out of one preallocated block instead of a stack of
        per-window allocations.

        When no drift monitor is attached and a chunk completes several
        windows at once (catch-up bursts, offline replay), the window
        snapshots are produced VECTORIZED: one strided view over
        ``ring ++ samples`` and one block copy, instead of a ring roll +
        copy per hop boundary.  The produced windows are byte-identical
        to the sequential path's — same stream rows, same dtype — which
        the equivalence suite pins by construction (chunking never
        changes events).
        """
        if (
            not isinstance(samples, np.ndarray)
            or samples.ndim != 2
            or samples.dtype != np.float32
        ):
            # already-clean (n, C) f32 input (the fleet engine's push
            # normalized it) skips the per-chunk conversion churn — at
            # 20 Hz × thousands of sessions these two calls were
            # measurably on the ingest hot path
            samples = np.atleast_2d(np.asarray(samples, np.float32))
        if samples.shape[-1] != self.channels:
            raise ValueError(
                f"expected (n, {self.channels}) samples, got "
                f"{samples.shape}"
            )
        pending: list[tuple[int, object, bool]] = []
        pos = 0
        n = len(samples)
        if self.monitor is None and n:
            # boundaries this chunk completes: next_emit, next_emit+hop,
            # ... <= n_seen + n (drift is False for all of them — no
            # monitor — so per-boundary sequencing has nothing to order)
            nb = (self._n_seen + n - self._next_emit) // self.hop + 1
            if nb >= 2:
                return self._consume_vectorized(samples, nb, sink)
        while pos < n:
            # advance at most to the next emission boundary, so no
            # boundary inside a large chunk is skipped
            take = min(self._next_emit - self._n_seen, n - pos)
            chunk = samples[pos : pos + take]
            if self.monitor is not None and take:
                # per consumed chunk, NOT per push: a whole recording
                # pushed at once must step the monitor at the same
                # cadence live streaming would, or the debounce could
                # never fire and events would all share one end-of-
                # recording verdict
                self.drift_report = self.monitor.update(chunk)
            # roll the ring by `take`: cheap at stream chunk sizes, and
            # keeps the window contiguous for the device transfer
            if take >= self.window:
                self._ring[:] = chunk[-self.window :]
            else:
                self._ring[: self.window - take] = self._ring[take:]
                self._ring[self.window - take :] = chunk
            self._n_seen += take
            pos += take
            if self._n_seen == self._next_emit:
                pending.append(
                    (
                        self._n_seen,
                        (
                            self._ring.copy()
                            if sink is None
                            else sink.put(self._ring)
                        ),
                        bool(
                            self.drift_report is not None
                            and self.drift_report.drifting
                        ),
                    )
                )
                self._next_emit += self.hop
        return pending

    def _consume_vectorized(
        self, samples: np.ndarray, nb: int, sink
    ) -> list[tuple[int, object, bool]]:
        """Multi-boundary fast path (no monitor attached): one strided
        view over ``ring ++ samples`` yields every completed window, one
        block copy stages them all.  State updates collapse to closed
        forms — the final ring is the last ``window`` stream rows either
        way."""
        n = len(samples)
        buf = np.ascontiguousarray(np.concatenate([self._ring, samples]))
        # buf[i] is stream row (n_seen - window + i); the window ending
        # at boundary b spans buf[b - n_seen : b - n_seen + window]
        first = self._next_emit - self._n_seen
        s0, s1 = buf.strides
        view = np.lib.stride_tricks.as_strided(
            buf[first:],
            shape=(nb, self.window, self.channels),
            strides=(self.hop * s0, s0, s1),
            writeable=False,
        )
        if sink is None:
            snaps = list(np.ascontiguousarray(view))
        elif hasattr(sink, "put_block"):
            snaps = sink.put_block(view)
        else:
            snaps = [sink.put(w) for w in view]
        t0 = self._next_emit
        pending = [
            (t0 + i * self.hop, snap, False)
            for i, snap in enumerate(snaps)
        ]
        self._next_emit = t0 + nb * self.hop
        self._n_seen += n
        if n >= self.window:
            self._ring[:] = samples[-self.window :]
        else:
            self._ring[: self.window - n] = self._ring[n:]
            self._ring[self.window - n :] = samples
        return pending


class _Smoother:
    """Sequential decision smoothing over per-window probabilities.

    The one implementation of the EMA / majority-vote / passthrough
    decision rule, shared by StreamingClassifier and the fleet engine's
    per-session state — fleet-multiplexed smoothing is bit-identical to
    standalone smoothing by construction, not by parallel maintenance.
    """

    __slots__ = ("smoothing", "ema_alpha", "_ema", "_votes")

    def __init__(self, smoothing: str, ema_alpha: float, vote_depth: int):
        self.smoothing = smoothing
        self.ema_alpha = ema_alpha
        self._ema: np.ndarray | None = None
        self._votes: deque[int] = deque(maxlen=vote_depth)

    def step(self, probs: np.ndarray) -> tuple[int, int, np.ndarray]:
        """Absorb one window's ``(C,)`` probabilities (in emission
        order); return ``(label, raw_label, decision_probs)``."""
        return self._step_raw(int(probs.argmax()), probs)

    def _step_raw(
        self, raw_label: int, probs: np.ndarray
    ) -> tuple[int, int, np.ndarray]:
        """``step`` with the raw argmax precomputed — ``update_many``
        vectorizes the argmax over a session's whole block (one
        reduction instead of one per row) and feeds the recurrence
        through here; the decision logic is byte-for-byte ``step``'s."""
        if self.smoothing == "ema":
            self._ema = (
                probs
                if self._ema is None
                else self.ema_alpha * probs
                + (1.0 - self.ema_alpha) * self._ema
            )
            smoothed = self._ema
            label = int(smoothed.argmax())
        elif self.smoothing == "vote":
            votes = self._votes
            votes.append(raw_label)
            # integer vote counting in plain Python: the deque holds at
            # most vote_depth small ints, and per-window np.bincount/
            # max/array churn was measurably on the fleet retire hot
            # path.  Integer arithmetic is exact, so the counts — and
            # the float64 division below — are bit-identical to the
            # previous numpy formulation (test-pinned vs step-by-step).
            # Width mirrors bincount(minlength=C): a stale vote from
            # before a swap to a NARROWER model still counts instead of
            # crashing the retire loop with an IndexError.
            width = probs.shape[0]
            for v in votes:
                if v >= width:
                    width = v + 1
            counts = [0] * width
            for v in votes:
                counts[v] += 1
            best = max(counts)
            # ties break toward the newest label that achieves the max
            label = next(
                v for v in reversed(votes) if counts[v] == best
            )
            # the event's probability must describe the DECISION, so in
            # vote mode it is the trailing vote distribution (the raw
            # window's own distribution stays reachable via raw_label);
            # probability[label] is then the vote confidence
            smoothed = np.asarray(counts, np.float64) / len(votes)
        else:
            smoothed = probs
            label = raw_label
        return label, raw_label, smoothed

    def update_many(
        self, probs: np.ndarray
    ) -> list[tuple[int, int, np.ndarray]]:
        """Absorb a ``(m, C)`` block of one session's per-window
        probabilities IN EMISSION ORDER; returns ``step``'s tuple per
        row.  The fleet engine's retire path calls this once per
        (session, batch) instead of ``step`` per row: the stateless
        passthrough mode vectorizes outright (one argmax over the
        block), while the stateful EMA/vote modes run the SAME
        sequential recurrence — vectorizing an EMA would re-associate
        the float chain and break the bit-identity contract with a
        standalone classifier."""
        if self.smoothing == "none":
            raws = probs.argmax(axis=1)
            return [
                (int(r), int(r), p) for r, p in zip(raws, probs)
            ]
        # stateful modes: the raw argmax is still one vectorized
        # reduction over the block; only the recurrence runs per row
        raws = probs.argmax(axis=1)
        return [
            self._step_raw(int(r), p) for r, p in zip(raws, probs)
        ]


class StreamingClassifier:
    """Sliding-window online classifier over an incremental stream.

    Parameters
    ----------
    model:
        Any fitted model with ``transform(x) -> Predictions`` over
        ``(n, window, channels)`` raw windows — a
        ``NeuralClassifierModel`` (scaler applied inside) or a bare
        ``NeuralModel``.
    window, hop:
        Window length and emission stride in samples.  The WISDM
        protocol is 200-sample (10 s @ 20 Hz) windows; ``hop=20`` emits
        one decision per second.
    smoothing:
        ``"ema"`` — exponential moving average over class probabilities
        (``ema_alpha`` = weight of the newest window);
        ``"vote"`` — majority vote over the last ``vote_depth`` raw
        labels (ties break toward the newest);
        ``"none"`` — every event reports its own window verbatim.
    """

    def __init__(
        self,
        model,
        *,
        window: int = 200,
        hop: int = 20,
        channels: int = 3,
        smoothing: str = "ema",
        ema_alpha: float = 0.4,
        vote_depth: int = 5,
        class_names: Sequence[str] | None = None,
        monitor=None,
        max_abs_sample: float | None = 1e6,
    ):
        if window <= 0 or hop <= 0:
            raise ValueError("window and hop must be positive")
        if smoothing not in ("ema", "vote", "none"):
            raise ValueError(f"unknown smoothing {smoothing!r}")
        if smoothing == "ema" and not (0.0 < ema_alpha <= 1.0):
            raise ValueError("ema_alpha must be in (0, 1]")
        if smoothing == "vote" and vote_depth < 1:
            raise ValueError("vote_depth must be >= 1")
        self.model = model
        self.window = int(window)
        self.hop = int(hop)
        self.channels = int(channels)
        self.smoothing = smoothing
        self.ema_alpha = float(ema_alpha)
        self.vote_depth = int(vote_depth)
        self.class_names = list(class_names) if class_names else None
        # optional monitoring.DriftMonitor: fed every pushed sample;
        # events carry drift=True while the stream is out of the
        # training distribution
        self.monitor = monitor
        # ingest guard (finite_rows): rejected rows are counted here,
        # never raised — the same per-session guard FleetServer applies,
        # so a multiplexed session stays bit-identical to this class
        self.max_abs_sample = max_abs_sample
        self.rejected_samples = 0
        self.reset()

    @classmethod
    def from_checkpoint(
        cls, path: str, device: str | torch.device = "cuda", **kwargs
    ) -> "StreamingClassifier":
        """Serve a saved neural checkpoint (``checkpoint.save_model``'s
        layout) on ``device``.

        Window geometry defaults to the checkpoint's recorded
        ``input_shape`` and a conflicting explicit ``window``/``channels``
        is rejected: a pooled CNN runs at any window length, so a
        mismatch would not error — it would silently emit predictions on
        a distribution the params never saw.  ``None`` kwargs mean
        "unset" (use the checkpoint's geometry).
        """
        from har_tpu_torch.checkpoint import load_model, load_model_meta

        kwargs = {k: v for k, v in kwargs.items() if v is not None}
        try:
            meta = load_model_meta(path)
        except OSError:
            meta = {}
        if meta.get("format") == "classical":
            raise ValueError(
                "streaming serves neural checkpoints trained on raw "
                f"windows; {path} holds a classical "
                f"{meta.get('model_name')} model"
            )
        shape = meta.get("input_shape")
        if shape and len(shape) == 2:
            trained = {"window": int(shape[0]), "channels": int(shape[1])}
            for name, value in trained.items():
                asked = kwargs.get(name)
                if asked is not None and asked != value:
                    raise ValueError(
                        f"checkpoint records input_shape={shape} "
                        f"({name}={value}); serving with {name}={asked} "
                        "would feed the model windows it was never "
                        "trained on"
                    )
                kwargs.setdefault(name, value)
        model = load_model(path, device)
        if kwargs.get("monitor") == "auto":
            # drift detection against the checkpoint's own training
            # statistics (the scaler's mean/std)
            from har_tpu_torch.monitoring import DriftMonitor

            if getattr(model, "scaler", None) is None:
                raise ValueError(
                    "this checkpoint records no training statistics "
                    "(model trained with standardize=False), so "
                    "monitor='auto' has nothing to compare against; "
                    "build DriftMonitor.from_windows(training_windows) "
                    "and pass it as monitor= instead"
                )
            kwargs["monitor"] = DriftMonitor.from_model(model)
        return cls(model, **kwargs)

    def reset(self) -> None:
        """Drop buffered samples and smoothing state (stream restart)."""
        # ring buffer of the newest `window` samples; decisions fire at
        # sample counts window, window+hop, window+2*hop, ... — shared
        # with the fleet engine's per-session state (har_tpu.serve)
        self._asm = _WindowAssembler(
            self.window, self.hop, self.channels,
            monitor=getattr(self, "monitor", None),
        )
        self._smoother = _Smoother(
            self.smoothing, self.ema_alpha, self.vote_depth
        )
        # bounded: a deployed 20 Hz session runs for days (the paper's
        # elderly-monitoring use case) — percentiles over a trailing
        # window keep the stats current AND the memory constant; 4096
        # dispatches ≈ 68 min of hop-per-second serving
        self._latencies: deque[float] = deque(maxlen=4096)
        # device-only calibration results keyed by batch size; survives
        # reset() would be wrong — a restarted stream may follow a
        # checkpoint swap, so measurements restart with the session
        self._device_ms: dict[int, dict] = {}
        if getattr(self, "monitor", None) is not None:
            self.monitor.reset()
        # the first predict EVER pays compilation; a reset() on a warm
        # classifier starts a session whose first sample is already fast
        self._session_starts_cold = not getattr(
            self, "_ever_predicted", False
        )

    # ---------------------------------------------------------- streaming

    def push(self, samples: np.ndarray) -> list[StreamEvent]:
        """Feed ``(n, channels)`` samples; return events for every hop
        boundary they complete.  Chunking is irrelevant: pushing a
        recording sample-by-sample or all at once yields identical
        events (the test suite pins this)."""
        # Pass 0: the ingest guard — a NaN/Inf or out-of-range row must
        # never reach the device predict (it would poison the whole
        # window, and on the fleet path the whole micro-batch)
        samples = np.atleast_2d(np.asarray(samples, np.float32))
        samples, n_bad = finite_rows(samples, self.max_abs_sample)
        self.rejected_samples += n_bad
        # Pass 1: consume samples, collecting the window snapshot (and
        # the drift verdict as of that moment) at every boundary — the
        # shared _WindowAssembler, so the fleet engine's sessions see
        # identical snapshots for identical delivery chunks.
        pending = self._asm.consume(samples)
        # Pass 2: score every completed window with as few dispatches as
        # possible — catch-up bursts (and offline replay through push)
        # pay one batched predict per _MAX_BATCH windows, not one
        # host-device round trip per hop.  Smoothing then runs sequentially over the rows, so
        # events are identical to hop-by-hop pushes.
        events: list[StreamEvent] = []
        for start in range(0, len(pending), self._MAX_BATCH):
            block = pending[start : start + self._MAX_BATCH]
            probs_block, lat_share = self._score(
                np.stack([w for _, w, _ in block])
            )
            for (t_index, _, drift), probs in zip(block, probs_block):
                events.append(
                    self._make_event(t_index, probs, lat_share, drift)
                )
        return events

    # windows scored per predict call; bursts beyond this loop.  Batch
    # shapes are padded to powers of two so at most log2(_MAX_BATCH)+1
    # distinct shapes ever reach the device.
    _MAX_BATCH = 256

    def _score(self, windows: np.ndarray) -> tuple[np.ndarray, float]:
        """(probs (k, C), per-window latency share in ms) — ONE timed
        model.transform for the whole block."""
        k = len(windows)
        windows = pad_pow2(windows)
        t0 = time.perf_counter()
        preds = self.model.transform(windows)
        latency_ms = (time.perf_counter() - t0) * 1e3
        self._latencies.append(latency_ms)
        self._ever_predicted = True
        return (
            np.asarray(preds.probability[:k], np.float64),
            latency_ms / k,
        )

    def _make_event(
        self, t_index: int, probs: np.ndarray, latency_ms: float,
        drift: bool,
    ) -> StreamEvent:
        label, raw_label, smoothed = self._smoother.step(probs)
        return StreamEvent(
            t_index=t_index,
            label=label,
            raw_label=raw_label,
            probability=smoothed.copy(),
            latency_ms=latency_ms,
            drift=drift,
        )

    def replay(
        self, samples: np.ndarray, *, calibrate: bool = True
    ) -> list[StreamEvent]:
        """Replay a recording at the LIVE cadence: hop-sized pushes, one
        dispatch per hop, so ``latency_stats()`` afterwards is the
        per-hop serving floor (a single whole-recording ``push`` batches
        into one dispatch and measures replay throughput instead — that
        path is ``classify_session``).  With ``calibrate``, runs the
        batch-1 ``device_latency_ms`` measurement afterwards (skipped
        silently for models without a device forward) so the stats also
        separate device compute from host/transfer overhead.
        Events are identical to any other chunking of the same samples.
        """
        samples = np.atleast_2d(np.asarray(samples, np.float32))
        events: list[StreamEvent] = []
        for start in range(0, len(samples), self.hop):
            events.extend(self.push(samples[start : start + self.hop]))
        if calibrate:
            try:
                self.device_latency_ms(batch=1)
            except ValueError:
                pass
        return events

    # ---------------------------------------------------------- reporting

    def device_latency_ms(self, batch: int = 1, iters: int = 16) -> dict:
        """Measure DEVICE execution time for the forward.

        Runs the inner module (or an artifact's program) on a
        device-resident ``(batch, window, channels)`` input, then
        ``torch.cuda.synchronize`` — no host numpy staging, no scaler,
        no result fetch — so the number is launch + device compute
        only (on the CPU, the forward's time).  The gap between this and
        the e2e ``latency_stats()`` percentiles is host staging, the
        copies and the host softmax.

        The result is cached per batch size and folded into
        ``latency_stats()`` as ``device_p50_ms`` / ``host_overhead_p50_ms``.
        Raises ValueError for models without a device forward (trees,
        MLlib replicas).
        """
        # unwrap + measure via the shared helpers (device_predict_fn /
        # measure_device_latency), which classify_session uses too
        result = measure_device_latency(
            self.model,
            window=self.window,
            channels=self.channels,
            batch=batch,
            iters=iters,
        )
        self._device_ms[batch] = result
        return result

    def latency_stats(self) -> dict:
        """Per-PREDICT end-to-end wall-clock distribution (ms) over the
        TRAILING window of the last 4096 dispatches (the full session
        since ``reset()`` until that rotates — a deployed 20 Hz session
        runs for days, so the stats stay current and the memory
        constant; ``count`` is therefore capped at the window length,
        not a lifetime dispatch total).

        One sample per dispatched batch: a live hop-by-hop stream gets
        one sample per hop, while a burst/replay push contributes one
        sample per batched predict (events carry the amortized
        per-window share in ``latency_ms``).

        Contract: ``steady_p50_ms`` is ``None`` when there is no
        warm evidence (a cold session that dispatched only once: its
        first call pays the kernels' loading and CUDA's lazy set-up) —
        consumers must treat it as optional, never as 0.  All ``*_ms``
        keys are e2e (host staging + transfer + device + fetch); after a
        ``device_latency_ms()`` calibration the dict also carries
        ``device_p50_ms`` (device launch+compute only) and
        ``host_overhead_p50_ms`` (steady e2e minus device — the host and
        copy share).
        """
        if not self._latencies:
            return {"count": 0}
        lat = list(self._latencies)
        # steady = samples after compilation; only the classifier's very
        # first session pays it, and with a single (cold) sample there is
        # no steady evidence at all — report None, not the compile time.
        # (Once the trailing window has rotated past the cold sample the
        # first entry is steady too, but dropping one steady sample is
        # harmless and the distinction is untrackable after rotation.)
        steady = lat[1:] if self._session_starts_cold else lat
        stats = {
            "count": len(lat),
            "p50_ms": round(_percentile(lat, 50), 3),
            "p95_ms": round(_percentile(lat, 95), 3),
            "max_ms": round(max(lat), 3),
            "steady_p50_ms": (
                round(_percentile(steady, 50), 3) if steady else None
            ),
        }
        dev = self._device_ms.get(1) or next(
            iter(self._device_ms.values()), None
        )
        if dev is not None:
            stats["device_p50_ms"] = dev["p50_ms"]
            stats["device_batch"] = dev["batch"]
            e2e_ref = stats["steady_p50_ms"]
            # the overhead subtraction is only meaningful against a
            # batch-1 calibration (hops dispatch single windows) — a
            # batch-k device time against per-hop e2e would understate
            # or zero-clamp the published overhead
            if e2e_ref is not None and dev["batch"] == 1:
                stats["host_overhead_p50_ms"] = round(
                    max(0.0, e2e_ref - dev["p50_ms"]), 3
                )
        return stats

    @property
    def drift_report(self):
        """The attached monitor's latest DriftReport (None without a
        monitor or before the first push)."""
        return self._asm.drift_report

    def label_name(self, label: int) -> str:
        if self.class_names and 0 <= label < len(self.class_names):
            return self.class_names[label]
        return str(label)


def classify_session(
    model,
    samples: np.ndarray,
    *,
    window: int = 200,
    hop: int = 20,
    timing: bool = False,
) -> "SessionResult":
    """Offline sliding-window classification of a full recording.

    Builds the strided ``(k, window, C)`` view (zero-copy) and scores it
    in one batched ``transform`` — the throughput path; equals the
    streaming path's raw labels.

    With ``timing=True`` the result carries the same device-vs-host
    latency decomposition the streaming path reports: ``e2e_ms`` (host
    staging + transfer + device + fetch for the one batched dispatch),
    ``device_p50_ms`` (the forward on a device-resident batch of the
    same shape, synchronized, no fetch) and ``host_overhead_ms`` — the
    host and copy share a serving consumer attributes p99 spikes to.
    ``device_p50_ms`` is None for models without a device forward
    (trees, MLlib replicas).
    """
    samples = np.ascontiguousarray(np.asarray(samples, np.float32))
    if samples.ndim != 2:
        raise ValueError(f"expected (n, channels) samples, got {samples.shape}")
    n = len(samples)
    if n < window:
        raise ValueError(f"recording shorter ({n}) than one window ({window})")
    k = (n - window) // hop + 1
    stride0 = samples.strides[0]
    windows = np.lib.stride_tricks.as_strided(
        samples,
        shape=(k, window, samples.shape[1]),
        strides=(hop * stride0, stride0, samples.strides[1]),
        writeable=False,
    )
    if timing:
        # warm the (k, window, C) forward OUTSIDE the timed region —
        # otherwise e2e_ms includes the first call's set-up and
        # host_overhead_ms reports it as host overhead, misdirecting the
        # attribution this mode exists for
        model.transform(windows)
    t0 = time.perf_counter()
    preds = model.transform(windows)
    e2e_ms = (time.perf_counter() - t0) * 1e3
    ends = window + hop * np.arange(k)
    timing_stats = None
    if timing:
        try:
            dev = measure_device_latency(
                model, window=window, channels=samples.shape[1], batch=k
            )
        except ValueError:
            dev = None  # no device program behind this model
        timing_stats = {
            "n_windows": k,
            "e2e_ms": round(e2e_ms, 3),
            "per_window_ms": round(e2e_ms / k, 4),
            "device_p50_ms": None if dev is None else dev["p50_ms"],
            "host_overhead_ms": (
                None
                if dev is None
                else round(max(0.0, e2e_ms - dev["p50_ms"]), 3)
            ),
        }
    return SessionResult(
        t_index=ends,
        labels=np.asarray(preds.prediction, np.int32),
        probability=np.asarray(preds.probability),
        timing=timing_stats,
    )


@dataclasses.dataclass(frozen=True)
class SessionResult:
    """classify_session output: one row per emitted window."""

    t_index: np.ndarray  # (k,) window-end sample indices
    labels: np.ndarray  # (k,)
    probability: np.ndarray  # (k, C)
    timing: dict | None = None  # device-vs-host decomposition of the
    #   one batched dispatch (classify_session(timing=True) only)

    def __len__(self) -> int:
        return len(self.labels)

    def segments(self) -> list[tuple[int, int, int]]:
        """Run-length merge: [(start_t, end_t, label)] over the session,
        the activity timeline a monitoring UI renders (the paper's
        stated use case is elderly-activity monitoring)."""
        if not len(self.labels):
            return []
        out = []
        start = 0
        for i in range(1, len(self.labels)):
            if self.labels[i] != self.labels[start]:
                out.append(
                    (
                        int(self.t_index[start]),
                        int(self.t_index[i - 1]),
                        int(self.labels[start]),
                    )
                )
                start = i
        out.append(
            (
                int(self.t_index[start]),
                int(self.t_index[-1]),
                int(self.labels[start]),
            )
        )
        return out
