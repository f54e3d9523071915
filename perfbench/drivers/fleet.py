"""The fleet engine (``serve.engine.FleetServer``) serving a raw-window
classifier to many sessions: the general generator of every traffic mix
of kind ``fleet``.

Mix keys: ``sessions``, ``hop``, ``chunk`` (samples a delivery),
``pool_windows``, ``class_signal`` (``harness.inputs.raw_windows``),
``smoothing``, ``ema_alpha``, ``fleet`` (``FleetConfig`` fields),
``check_sessions``, and ``arrivals``:

- ``"backlog"``: ``drive_fleet``'s delivery, copied: round-robin over the
  sessions, one chunk each a round, the first chunk of a session shorter
  by a seeded phase offset, as fast as the fleet takes them (a poll after
  every round), each round's sessions in a seeded order (so every
  session's windows take every place in a batch); the window ends at the
  first round after ``--seconds``, then the queue is flushed.
  ``serve_windows_per_s`` is the windows scored over the window's wall
  time.
- ``"poisson"``: an open loop.  Each session sends its chunks at Poisson
  times, at ``offered_windows_per_s`` windows a second over the fleet,
  scheduled from the seed for ``--seconds``; the loop pushes every chunk
  once it is due (chunks of one session in order; one ``push_many`` per
  rank of arrival within the round) and polls.  After the schedule ends
  the loop polls until every window is answered or shed (at most 60 s),
  then flushes.  ``event_p95_ms`` is the 95th percentile, over every
  window completed in the window, of the time from the scheduled due time
  of the chunk that completed it to the return of the poll that emitted
  its event (a shed window counts at the end of the drain).

A session's stream is the seeded pool of windows, read cyclically from
a seeded offset, so its k-th window is pool window (offset + k) mod the
pool's size.  Set-up: the pool, the offsets and the model's weights are
drawn on the card; every padded batch shape (powers of two to the
target batch) is warmed up through warm-up sessions that leave before
the window, and the engine's arenas are grown to the fleet's size.

After the window the peak memory is read, the program freed, and the
events of ``check_sessions`` sessions drawn from the seed are judged
(``reference/fleet_check.py``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from drivers.train_fits import build_module, free
from harness import inputs
from harness.result import Observed, RunOutput, limited
from harness.trace import Tracer, span
from reference import fleet_check
from reference.precision import MATMULS, exact_tf32_off

DRAIN_LIMIT_S = 60.0
TRACE_START = 0.3  # of the window
TRACE_SECONDS = 3.0


def build_model(cfg: dict, ref, weights: dict, device):
    """The program's served model: a ``NeuralModel`` over the
    configuration's module, holding the benchmark's weights."""
    from har_tpu_torch.train.trainer import NeuralModel

    module = build_module(cfg, ref).to(device)
    module.load_state_dict(weights)
    return NeuralModel(module=module.eval(), num_classes=cfg["num_classes"])


class Streams:
    """Every session's stream as views into one flat copy of the pool,
    extended by one window so that a chunk of at most a window never
    wraps."""

    def __init__(self, pool: np.ndarray, offsets: np.ndarray):
        p, t, c = pool.shape
        self.period = p * t
        self.flat = np.ascontiguousarray(
            np.concatenate([pool.reshape(-1, c), pool[0]], axis=0))
        self.base = offsets.astype(np.int64) * t

    def chunk(self, session: int, start: int, length: int) -> np.ndarray:
        p = int((self.base[session] + start) % self.period)
        return self.flat[p:p + length]


class Recorder:
    """Counts every event and keeps the checked sessions' answers; with
    ``latency``, each window's emission time by (session, t_index)."""

    def __init__(self, checked: set, latency: bool):
        self.checked = checked
        self.count = 0
        self.answers: dict[int, list] = {s: [] for s in checked}
        self.latency = latency
        self.sessions: list[np.ndarray] = []
        self.t_index: list[np.ndarray] = []
        self.emitted_at: list[np.ndarray] = []

    def take(self, events, now: float) -> None:
        self.count += len(events)
        if self.latency and events:
            self.sessions.append(np.fromiter((e.session_id for e in events), np.int64,
                                             len(events)))
            self.t_index.append(np.fromiter((e.event.t_index for e in events), np.int64,
                                            len(events)))
            self.emitted_at.append(np.full(len(events), now))
        for e in events:
            if e.session_id in self.checked:
                self.answers[e.session_id].append(
                    (int(e.event.t_index), np.asarray(e.event.probability, np.float64)))


def host_profile_ms(server) -> float:
    prof = server.host_profile
    return sum(getattr(prof, name).total_ms for name in prof.PHASES)


def warm_up(server, traffic: dict, pool: np.ndarray) -> None:
    """Every padded batch shape the cell can dispatch, through sessions
    that leave before the window: first one window each for as many
    sessions as the fleet holds (the engine's arenas grow to the fleet's
    size), then one batch of each power of two below the target."""
    window = pool[0]
    sizes = [traffic["sessions"]]
    b = 1
    while b < traffic["fleet"]["target_batch"]:
        sizes.append(b)
        b *= 2
    for size in sizes:
        ids = [f"warm-{i}" for i in range(size)]
        for sid in ids:
            server.add_session(sid)
        server.push_many(ids, [window] * size)
        server.flush()
        for sid in ids:
            server.remove_session(sid)


def prepare(ctx, profile_host: bool = False) -> dict:
    from har_tpu_torch.serve.engine import FleetConfig, FleetServer

    ref, device, traffic, cfg = ctx.reference, ctx.device, ctx.cell.traffic, ctx.cell.config
    _, _, _, _, t, c, k = ref.dims(cfg)
    s = traffic["sessions"]
    pool_dev, _ = inputs.raw_windows(ctx.seed, traffic["pool_windows"], t, c, k, device,
                                     traffic.get("class_signal", 0.0))
    pool = pool_dev.cpu().numpy()
    weights = inputs.initial_weights(ref.state_shapes(cfg), ctx.seed, device)
    model = build_model(cfg, ref, weights, device)
    del pool_dev, weights
    ctx.note("pool, weights and model ready")
    rng = np.random.default_rng(inputs.sub_seed(ctx.seed, "sessions"))
    offsets = rng.integers(0, traffic["pool_windows"], size=s)
    checked = set(int(v) for v in rng.choice(s, size=traffic["check_sessions"], replace=False))
    config = FleetConfig.for_sessions(s, profile_host=profile_host, **traffic["fleet"])
    server = FleetServer(model, window=t, hop=traffic["hop"], channels=c,
                         smoothing=traffic["smoothing"], ema_alpha=traffic["ema_alpha"],
                         config=config)
    warm_up(server, traffic, pool)
    for sid in range(s):
        server.add_session(sid)
    ctx.note("batch shapes warmed, sessions admitted")
    return dict(server=server, streams=Streams(pool, offsets), offsets=offsets,
                checked=checked, rng=rng)


class Window:
    """The measured window's clock and, with ``--trace 1``, the traced
    region inside it and the counters taken over it."""

    def __init__(self, ctx, server):
        self.ctx, self.server = ctx, server
        self.t0 = time.perf_counter()
        self.tracer = None
        self.traced = False
        self.counters: dict = {}
        self._start: dict = {}

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def tick(self, recorder: Recorder, late_ms: list | None = None) -> None:
        """Open or close the traced region at the window's time."""
        if not self.ctx.trace or self.traced:
            return
        el = self.elapsed()
        start = TRACE_START * self.ctx.seconds
        if self.tracer is None and el >= start:
            self.tracer = Tracer(self.ctx.device).__enter__()
            self._start = self._read(recorder, late_ms)
        elif self.tracer is not None and el >= start + min(TRACE_SECONDS, 0.4 * self.ctx.seconds):
            self.close(recorder, late_ms)

    def close(self, recorder: Recorder, late_ms: list | None = None) -> None:
        if self.tracer is None or self.traced:
            return
        self.tracer.__exit__(None, None, None)
        self.traced = True
        end = self._read(recorder, late_ms)
        a = self._start
        stats = self.server.stats
        self.counters["windows_in_trace"] = end["events"] - a["events"]
        if self.server.host_profile is not None and end["dispatches"] > a["dispatches"]:
            self.counters["fleet_host_ms_per_dispatch"] = (
                (end["host_ms"] - a["host_ms"]) / (end["dispatches"] - a["dispatches"]))
        wait = stats.queue_wait.percentile(95)
        if wait is not None:
            self.counters["fleet_queue_wait_p95_ms"] = wait
        if late_ms is not None and len(late_ms) > a["late"]:
            self.counters["loadgen_late_p95_ms"] = float(
                np.percentile(np.concatenate(late_ms[a["late"]:]), 95))

    def _read(self, recorder: Recorder, late_ms) -> dict:
        server = self.server
        return {"events": recorder.count, "dispatches": server.stats.dispatches,
                "host_ms": host_profile_ms(server) if server.host_profile else 0.0,
                "late": len(late_ms) if late_ms is not None else 0}


def run_backlog(ctx, s: dict, recorder: Recorder) -> tuple[Window, float]:
    server, streams, traffic = s["server"], s["streams"], ctx.cell.traffic
    n = traffic["sessions"]
    chunk = traffic["chunk"]
    phase = s["rng"].integers(0, chunk, size=n)
    cursors = np.zeros(n, np.int64)
    order_rng = np.random.default_rng(inputs.sub_seed(ctx.seed, "rounds"))
    win = Window(ctx, server)
    first = True
    spent = {"deliver": 0.0, "push": 0.0, "poll": 0.0, "take": 0.0}
    rounds = 0
    gc_before = [g["collections"] for g in gc.get_stats()]
    while True:
        t = time.perf_counter()
        lengths = np.maximum(1, chunk - phase) if first else np.full(n, chunk)
        ids = order_rng.permutation(n).tolist()
        payloads = [streams.chunk(i, int(cursors[i]), int(lengths[i])) for i in ids]
        cursors += lengths
        first = False
        t1 = time.perf_counter()
        with span("push"):
            server.push_many(ids, payloads)
        t2 = time.perf_counter()
        with span("poll"):
            events = server.poll()
        t3 = time.perf_counter()
        recorder.take(events, 0.0)
        t4 = time.perf_counter()
        for k, dt in zip(spent, (t1 - t, t2 - t1, t3 - t2, t4 - t3)):
            spent[k] += dt
        rounds += 1
        win.tick(recorder)
        if win.elapsed() >= ctx.seconds and (not ctx.trace or win.traced):
            break
    gc_runs = [g["collections"] - b for g, b in zip(gc.get_stats(), gc_before)]
    ctx.note(f"{rounds} rounds, gc collections {gc_runs}; seconds in "
             + ", ".join(f"{k} {v:.3f}" for k, v in spent.items()))
    with span("flush"):
        events = server.flush()
    recorder.take(events, 0.0)
    win.close(recorder)
    s["delivered"] = cursors
    return win, win.elapsed()


def poisson_schedule(seed: int, sessions: int, rate_per_session: float, seconds: float):
    """Every chunk due in [0, seconds): (due times sorted, session,
    chunk index), and the (sessions, chunks) matrix of due times (inf
    past the end)."""
    rng = np.random.default_rng(inputs.sub_seed(seed, "arrivals"))
    mean = rate_per_session * seconds
    width = int(mean + 8 * np.sqrt(mean) + 16)
    due = np.cumsum(rng.exponential(1.0 / rate_per_session, size=(sessions, width)), axis=1)
    due[due >= seconds] = np.inf
    if np.isfinite(due[:, -1]).any():
        raise RuntimeError("the schedule's width is too small for its rate")
    sess, idx = np.nonzero(np.isfinite(due))
    times = due[sess, idx]
    order = np.argsort(times, kind="stable")
    return times[order], sess[order], idx[order], due


def arrival_ranks(sessions: np.ndarray) -> np.ndarray:
    """For each entry, how many earlier entries of the same session the
    round holds (0 for a session's first chunk in the round)."""
    order = np.argsort(sessions, kind="stable")
    sorted_s = sessions[order]
    starts = np.r_[0, np.nonzero(np.diff(sorted_s))[0] + 1]
    run_start = np.repeat(starts, np.diff(np.r_[starts, len(sorted_s)]))
    ranks = np.empty(len(sessions), np.int64)
    ranks[order] = np.arange(len(sessions)) - run_start
    return ranks


def run_poisson(ctx, s: dict, recorder: Recorder, late_ms: list) -> tuple[Window, dict]:
    server, streams, traffic = s["server"], s["streams"], ctx.cell.traffic
    n, chunk, hop = traffic["sessions"], traffic["chunk"], traffic["hop"]
    per_session = traffic["offered_windows_per_s"] / n * hop / chunk
    times, sess, idx, due = poisson_schedule(ctx.seed, n, per_session, ctx.seconds)
    total = len(times)
    ptr = 0
    win = Window(ctx, server)
    t0 = win.t0
    while ptr < total:
        now = time.perf_counter() - t0
        hi = int(np.searchsorted(times, now, side="right"))
        if hi > ptr:
            rs, ri = sess[ptr:hi], idx[ptr:hi]
            ranks = arrival_ranks(rs)
            with span("push"):
                for rank in range(int(ranks.max()) + 1):
                    pick = ranks == rank
                    ids = rs[pick].tolist()
                    server.push_many(ids, [streams.chunk(i, int(j) * chunk, chunk)
                                           for i, j in zip(ids, ri[pick])])
            late_ms.append((time.perf_counter() - t0 - times[ptr:hi]) * 1e3)
            ptr = hi
        with span("poll"):
            events = server.poll()
        recorder.take(events, time.perf_counter() - t0)
        win.tick(recorder, late_ms)
    window_s = win.elapsed()
    queue_at_close = server.stats.queue_depth
    deadline = time.perf_counter() + DRAIN_LIMIT_S
    stats = server.stats
    while stats.scored + stats.dropped_total < stats.enqueued and time.perf_counter() < deadline:
        with span("poll"):
            events = server.poll()
        recorder.take(events, time.perf_counter() - t0)
    with span("flush"):
        events = server.flush()
    drained_at = time.perf_counter() - t0
    recorder.take(events, drained_at)
    win.close(recorder, late_ms)
    # each session's windows that its chunks due in the window completed
    s["delivered"] = np.isfinite(due).sum(axis=1) * chunk
    windows_due = windows_in(s["delivered"], ctx.cell.config["window"], hop)
    return win, {"window_s": window_s, "due": due, "windows_due": windows_due,
                 "drained_at": drained_at, "queue_at_close": queue_at_close}


def windows_in(samples: np.ndarray, window: int, hop: int) -> np.ndarray:
    """Windows a stream of ``samples`` samples completes."""
    return np.where(samples >= window, (samples - window) // hop + 1, 0)


def event_latencies_ms(recorder: Recorder, due: np.ndarray, attempted: int, chunk: int,
                       unanswered_ms: float) -> np.ndarray:
    """Each window completed in the window: from the due time of the
    chunk that completed it to the return of the poll that emitted its
    event; a window never answered counts ``unanswered_ms``."""
    sessions = np.concatenate(recorder.sessions) if recorder.sessions else np.zeros(0, np.int64)
    t_index = np.concatenate(recorder.t_index) if recorder.t_index else np.zeros(0, np.int64)
    emitted = np.concatenate(recorder.emitted_at) if recorder.emitted_at else np.zeros(0)
    completing = -(-t_index // chunk) - 1
    lat = (emitted - due[sessions, completing]) * 1e3
    missing = max(0, attempted - len(lat))
    return np.concatenate([lat, np.full(missing, unanswered_ms)])


def accounting(server, before: dict | None = None) -> dict:
    stats = server.stats
    now = {"enqueued": stats.enqueued, "scored": stats.scored, "dropped": stats.dropped_total}
    return now if before is None else {k: now[k] - before[k] for k in now}


def reference_inputs(ctx) -> tuple[torch.Tensor, dict]:
    """The pool and the weights, drawn again from the seed."""
    ref, cfg, device = ctx.reference, ctx.cell.config, ctx.device
    _, _, _, _, t, c, k = ref.dims(cfg)
    exact_tf32_off()
    pool, _ = inputs.raw_windows(ctx.seed, ctx.cell.traffic["pool_windows"], t, c, k, device,
                                 ctx.cell.traffic.get("class_signal", 0.0))
    return pool, inputs.initial_weights(ref.state_shapes(cfg), ctx.seed, device)


def judge(ctx, s: dict, answers: dict, acct: dict, events: int) -> dict[str, float]:
    """The check's numbers: the checked sessions' answers against the
    reference (``prob_gap``, ``order_faults``), the windows their
    deliveries completed that were neither answered nor covered by the
    fleet's declared sheds (``missing``), and the fleet's accounting over
    the window (``unaccounted``: windows enqueued that were neither
    answered nor declared shed, and events the accounting does not
    count)."""
    pool, weights = reference_inputs(ctx)
    numbers = fleet_check.readings(ctx.reference, ctx.cell.config, ctx.cell.traffic, pool,
                                   s["offsets"], weights, answers, MATMULS["float32"])
    checked = sorted(answers)
    expected = int(windows_in(s["delivered"][checked], ctx.cell.config["window"],
                              ctx.cell.traffic["hop"]).sum())
    answered = sum(len(answers[sid]) for sid in checked)
    numbers["missing"] = float(max(0, expected - answered - acct["dropped"]))
    numbers["unaccounted"] = float(abs(acct["enqueued"] - acct["scored"] - acct["dropped"])
                                   + abs(acct["scored"] - events))
    return numbers


def measure(ctx) -> tuple[dict, Recorder, RunOutput]:
    """Set-up and the window; the program freed on return."""
    device, traffic = ctx.device, ctx.cell.traffic
    s = prepare(ctx, profile_host=ctx.trace)
    server = s["server"]
    before = accounting(server)
    poisson = traffic["arrivals"] == "poisson"
    recorder = Recorder(s["checked"], latency=poisson)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    if poisson:
        late_ms: list = []
        win, info = run_poisson(ctx, s, recorder, late_ms)
        attempted = int(info["windows_due"].sum())
        lat = event_latencies_ms(recorder, info["due"], attempted, traffic["chunk"],
                                 (info["drained_at"] - ctx.seconds) * 1e3)
        failed = max(0, attempted - recorder.count)
        e2e = {"event_p95_ms": float(np.percentile(lat, 95))}
        s["open_loop"] = {"window_s": info["window_s"], "queue_at_close": info["queue_at_close"],
                          "answered_in_window": int((np.concatenate(recorder.emitted_at)
                                                     <= info["window_s"]).sum())
                          if recorder.emitted_at else 0}
    else:
        win, window_s = run_backlog(ctx, s, recorder)
        e2e = {"serve_windows_per_s": recorder.count / window_s}
    acct = accounting(server, before)
    if not poisson:
        attempted, failed = acct["enqueued"], acct["dropped"]
    e2e["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out = RunOutput(
        attempted=attempted, failed=failed, e2e=e2e, checks={}, memory_peak_bytes=peak,
        observed=Observed(trace=win.tracer.summary if win.tracer else None,
                          counters=win.counters, cell=ctx.cell, reference=ctx.reference))
    s["acct"] = acct
    del server, win
    s["server"] = None
    free(device)
    return s, recorder, out


def run(ctx) -> RunOutput:
    s, recorder, out = measure(ctx)
    numbers = judge(ctx, s, recorder.answers, s["acct"], recorder.count)
    out.checks = limited(ctx, numbers)
    return out


def altered_answer_fault():
    """Plant step 3's fault in the program: the first answer of every
    dispatch comes back with its classes rotated by one."""
    from unittest import mock

    from har_tpu_torch.serve import dispatch

    real = dispatch.DeviceScorer.fetch

    def fetch(self, handle, k):
        probs = real(self, handle, k)
        probs[0] = np.roll(probs[0], 1)
        return probs

    return mock.patch.object(dispatch.DeviceScorer, "fetch", fetch)


def half_batch_fault():
    """Plant step 3's fault in the program: of every dispatch, only the
    first half of its events reach the caller."""
    from unittest import mock

    from har_tpu_torch.serve.engine import FleetServer

    real = FleetServer._retire_ticket

    def retire(self, ticket):
        events = real(self, ticket)
        return events[: (len(events) + 1) // 2]

    return mock.patch.object(FleetServer, "_retire_ticket", retire)


FAULTS = {"altered_answer": altered_answer_fault, "half_batch": half_batch_fault}


def calibrate(ctx, kind: str) -> dict[str, float]:
    """One seed's readings for setting limits: ``kind`` "program" (a run
    of the cell), "control" (the reference in fp8 answering the same
    sessions' windows in the program's place), or a fault of ``FAULTS``
    planted in the program."""
    if kind in FAULTS:
        with FAULTS[kind]():
            s, recorder, _ = measure(ctx)
    else:
        s, recorder, _ = measure(ctx)
    if kind == "control":
        pool, weights = reference_inputs(ctx)
        answers = fleet_check.reference_answers(
            ctx.reference, ctx.cell.config, ctx.cell.traffic, pool, s["offsets"], weights,
            recorder.answers, MATMULS["fp8"])
        return judge(ctx, s, answers, s["acct"], recorder.count)
    return judge(ctx, s, recorder.answers, s["acct"], recorder.count)
