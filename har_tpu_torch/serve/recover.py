"""Crash recovery for a journaled FleetServer: load the newest
snapshot, replay the journal suffix, resume serving.

Recovery is deliberately boring: it re-executes the SAME code paths the
live engine ran, with journaling suppressed —

  - ``push`` records feed the exact pre-crash sample rows back through
    the shared ``_WindowAssembler``, so ring buffers, window
    completions, monitor EWMAs and drift verdicts recover
    bit-identically by construction (the fleet's equivalence argument,
    reused as a durability argument);
  - ``ack`` records consume the completed window they scored and
    re-step the smoother with the recorded probabilities — the event is
    NOT re-emitted (its consumer already saw it: acks are flushed
    before ``poll`` returns), so nothing is ever double-scored or
    double-counted;
  - ``drop`` records re-apply dispatch-time sheds (dispatch failures,
    SLO sheds) that replay could not re-derive; push-time sheds
    (session/global queue bounds) re-derive deterministically from the
    record stream and are therefore not journaled at all;
  - whatever remains un-acked and un-dropped is exactly the pre-crash
    pending queue, re-enqueued in the original global FIFO order and
    scored after restart — with a deterministic model, bit-identically
    to the uninterrupted run.

What recovery canNOT conjure is data that never reached the disk: the
tail of pushes inside the last flush interval.  The transport closes
that gap by re-delivering from ``FleetServer.watermark(sid)`` (lossless
recovery, the chaos harness's default) or declares the gap via
``FleetServer.declare_lost`` — which extends the conservation law to
``enqueued == scored + dropped + pending + lost_in_crash``.

Port of ``har_tpu/serve/recover.py`` (copied), the recovery benchmark
behind ``har_tpu_torch.bench``'s ``fleet_recovery`` lane included.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from collections import deque
from typing import Callable

import numpy as np

from har_tpu_torch.serve.journal import (
    FleetJournal,
    JournalConfig,
    JournalError,
    load_journal,
    monitor_from_state,
)


class RecoveryError(RuntimeError):
    """Journal contents inconsistent with the engine's invariants (an
    ack for a window replay never completed, a record for an unknown
    session) — corruption, not a normal crash signature."""


# Record types whose WRITER has been superseded but whose journals are
# still in the field.  Per-event `ack` records were replaced by the
# group-committed `acks` record (one batched write per retire); the
# `ack` handler below stays forever — old journals never migrate, and a
# mixed log (old `ack` + new `acks`) restores through both handlers in
# record order.  HL003 pins this declaration both ways: a retired type
# must keep its handler, and a type with a live writer must not hide
# here.
RETIRED_RECORD_TYPES = ("ack",)


def _oldest_live(server, sess):
    """The session's oldest live pending index, discarding (and
    releasing the session-list reference of) flagged-dropped heads —
    the SoA pending queue's replay-side head walk (the entries' queue-
    side references stay in the FIFO ring, which skips them at the
    next poll exactly like the live engine)."""
    pq = server._pending
    arena = server._session_arena
    slot = sess.slot
    h = arena.pend_head[slot]
    while h >= 0 and pq.dropped[h]:
        nxt = pq.next_idx[h]
        arena.pend_head[slot] = nxt
        if nxt < 0:
            arena.pend_tail[slot] = -1
        pq.release(h)
        h = nxt
    return int(h) if h >= 0 else None


def _consume_ack(server, sess, ti, ver, shed, probs):
    pq = server._pending
    p = _oldest_live(server, sess)
    if p is None or pq.t_index[p] != ti:
        raise RecoveryError(
            f"ack for session {sess.sid!r} t_index={ti} does not match "
            f"the oldest recovered window "
            f"({None if p is None else int(pq.t_index[p])}) — a window "
            "would be double-scored; refusing to recover from this "
            "journal"
        )
    server._session_pop_head(sess)
    # consumed: hide it from the global FIFO and free its arena slot
    server._release_pending(p)
    sess.n_scored += 1
    server.stats.note_scored(1, ver)
    if shed:
        server.stats.degraded_events += 1
    else:
        # re-step the smoother with the recorded decision inputs: the
        # post-recovery smoothing state equals the pre-crash one, so
        # the NEXT event continues the stream seamlessly
        sess.smoother.step(probs)


def _consume_drop(server, sess, ti, reason):
    pq = server._pending
    h = server._session_arena.pend_head[sess.slot]
    while h >= 0:
        if not pq.dropped[h] and pq.t_index[h] == ti:
            # flagged in place (list position kept for the FIFO
            # unlink), exactly like the live engine's sheds
            server._release_pending(int(h))
            sess.n_dropped += 1
            server.stats.drop(1, reason)
            return
        h = pq.next_idx[h]
    raise RecoveryError(
        f"drop record for session {sess.sid!r} t_index={ti} matches no "
        "recovered window"
    )


def apply_record(server, meta, payload) -> None:
    """Apply ONE journal record to a replaying server — the record
    dispatch shared by crash recovery (``restore_server``'s suffix
    replay) and continuous replication (``har_tpu_torch.serve.replica``'s
    warm standby, which feeds tailed records through this exact body
    as they arrive).  The caller owns the ``server._replaying`` guard;
    this function only interprets records.  Unknown record types are
    skipped: a newer writer's extra records must not brick an older
    reader (harlint HL003 pins the writer↔handler bijection)."""
    channels = server.channels
    t = meta.get("t")
    if t == "push":
        n = int(meta["n"])
        samples = np.frombuffer(payload, np.float32).reshape(
            n, channels
        )
        server.push(meta["sid"], samples)
        # the record's samples are post-guard: re-align the raw
        # transport watermark with the rows the guard rejected
        rejected = int(meta.get("rn", n)) - n
        if rejected:
            server._sessions[meta["sid"]].raw_seen += rejected
            server.stats.rejected_samples += rejected
    elif t == "ack":
        sess = server._sessions.get(meta["sid"])
        if sess is None:
            raise RecoveryError(
                f"ack for unknown session {meta['sid']!r}"
            )
        _consume_ack(
            server, sess, int(meta["ti"]), meta.get("ver", "v0"),
            bool(meta.get("shed")),
            np.frombuffer(payload, np.float64),
        )
    elif t == "acks":
        # group-committed acks (one record per retire): the
        # entries ride in the retire loop's emit order, so
        # replaying them through the same per-event
        # _consume_ack sequence re-steps each smoother
        # bit-identically to a per-record `ack` log.  The
        # per-record handler above stays — old and mixed logs
        # replay without migration.  Each entry's t_index is
        # NOT stored (the push records already determine it:
        # it's the session's oldest live pending); the record
        # carries one crc32 over the expected int64 column
        # ("tic") so a journal that diverged from the engine's
        # ack order still refuses to recover, at 4 bytes per
        # RECORD instead of 8 per entry.
        n = int(meta["n"])
        ver = meta.get("ver", "v0")
        a_shed = bool(meta.get("shed"))
        rows = np.frombuffer(payload, np.float64).reshape(n, -1)
        pq = server._pending
        tis = np.empty(n, np.int64)
        for j, (sid, row) in enumerate(
            zip(meta["sids"], rows)
        ):
            sess = server._sessions.get(sid)
            if sess is None:
                raise RecoveryError(
                    f"ack for unknown session {sid!r}"
                )
            p = _oldest_live(server, sess)
            if p is None:
                raise RecoveryError(
                    f"ack for session {sid!r} but no window "
                    "was recovered pending — a window would "
                    "be double-scored; refusing to recover "
                    "from this journal"
                )
            tis[j] = int(pq.t_index[p])
            _consume_ack(
                server, sess, int(tis[j]), ver, a_shed, row
            )
        crc = zlib.crc32(tis.tobytes()) & 0xFFFFFFFF
        if int(meta.get("tic", crc)) != crc:
            raise RecoveryError(
                "acks record t_index checksum mismatch "
                f"(recorded {meta['tic']}, replayed {crc}) — "
                "the journal's ack order diverged from the "
                "recovered pending queue; refusing to recover"
            )
    elif t == "drop":
        sess = server._sessions.get(meta["sid"])
        if sess is None:
            raise RecoveryError(
                f"drop for unknown session {meta['sid']!r}"
            )
        _consume_drop(
            server, sess, int(meta["ti"]), meta.get("reason", "?")
        )
    elif t == "add":
        server.add_session(
            meta["sid"],
            monitor=monitor_from_state(meta.get("mon")),
        )
    elif t == "remove":
        server.remove_session(meta["sid"])
    elif t == "swap":
        server.model_version = meta["ver"]
        server.stats.model_swaps += 1
        server._device_ms.clear()
    elif t == "resize":
        # elastic capacity resize (FleetServer.resize): the
        # schedule knobs replay exactly; the mesh OBJECT is a
        # runtime resource — recovery shards onto whatever mesh
        # restore_server was given, same stance as the model
        server.config = dataclasses.replace(
            server.config,
            target_batch=int(meta["tb"]),
            pipeline_depth=int(meta["depth"]),
        )
        server.stats.resizes += 1
        if int(meta.get("dir", 0)) > 0:
            server.stats.scale_ups += 1
        elif int(meta.get("dir", 0)) < 0:
            server.stats.scale_downs += 1
    elif t == "disc":
        # graceful disconnect, flush half: re-derive the final
        # partial window from the recovered ring — bit-identical
        # by construction (same _flush_partial, same ring); the
        # following ack then consumes it like any other window
        sess = server._sessions.get(meta["sid"])
        if sess is None:
            raise RecoveryError(
                f"disc record for unknown session {meta['sid']!r}"
            )
        server._flush_partial(sess)
    elif t == "shed":
        on = bool(meta.get("on"))
        if on and not server._smoothing_shed:
            server.stats.smoothing_shed_transitions += 1
        server._smoothing_shed = on
    elif t == "adopt":
        # cluster hand-off, receiving half: rebuild the migrated
        # session from the record's full state payload (ring
        # float32, then the EMA float64 when meta["ema"]) —
        # the same adopt_session path the live migration ran.
        # The stored `handoffs` already counts this adoption;
        # adopt_session re-bumps, so hand it the predecessor's.
        window = server.window
        ring_bytes = window * channels * 4
        ema = None
        if meta.get("ema"):
            ema = np.frombuffer(payload[ring_bytes:], np.float64)
        server.adopt_session(
            {
                "sid": meta["sid"],
                "ring": np.frombuffer(
                    payload[:ring_bytes], np.float32
                ).reshape(window, channels),
                "n_seen": meta["n_seen"],
                "raw_seen": meta["raw_seen"],
                "next_emit": meta["next_emit"],
                "n_enqueued": meta.get("n_enqueued", 0),
                "n_scored": meta.get("n_scored", 0),
                "n_dropped": meta.get("n_dropped", 0),
                "handoffs": int(meta.get("handoffs", 1)) - 1,
                "votes": meta.get("votes") or [],
                "ema": ema,
                "monitor": meta.get("mon"),
            }
        )
    elif t == "handoff":
        # cluster hand-off, source half: the session moved to
        # another worker — evict without dropping (the drain
        # guarantee re-derives: replay reaches this record with
        # the session's queue empty, or the journal is corrupt)
        if meta["sid"] not in server._sessions:
            raise RecoveryError(
                f"handoff record for unknown session "
                f"{meta['sid']!r}"
            )
        server._apply_handoff(meta["sid"])
    elif t == "lost":
        server.declare_lost(meta["sid"], int(meta["pos"]))
    elif t == "adapt":
        server.recovered_adapt_records.append(meta)
    # unknown record types are skipped: a newer writer's extra
    # records must not brick an older reader


def restore_server(
    journal_dir: str,
    model,
    *,
    clock: Callable[[], float] | None = None,
    fault_hook: Callable | None = None,
    journal_config: JournalConfig | None = None,
    reattach: bool = True,
    mesh=None,
    inflight_ship_ok: bool = False,
):
    """Rebuild a FleetServer from its journal directory.

    ``model`` is either a model object (served as-is under the
    recovered version label) or a callable ``version_label -> model``
    (resolved AFTER replay, so a crash mid-swap serves whichever
    version the journal proves durable — typically a loader over the
    adapt ModelRegistry).

    The restored server has ``stats.recoveries`` incremented, the full
    pre-crash pending queue re-enqueued, and (with ``reattach``) a
    fresh journal attached with a recovery-point snapshot — so crashes
    compose: a second kill recovers from the first recovery.

    ``mesh`` — optional device mesh for the recovered server's dispatch
    plane (runtime resource, never journaled: the process that died may
    have run on different hardware than the one recovering).
    ``pipeline_depth`` rides the snapshot's FleetConfig; in-flight
    tickets are NOT part of any snapshot — a ticket in flight at crash
    time was un-acked by construction, so its windows recover as
    pending from the replayed pushes and are simply re-scored.
    """
    from har_tpu_torch.serve.engine import FleetConfig, FleetServer

    state, arrays, records = load_journal(
        journal_dir, inflight_ship_ok=inflight_ship_ok
    )
    geo = state.get("geometry")
    if not geo:
        raise JournalError("snapshot lacks the geometry block")
    cfg_fields = {f.name for f in dataclasses.fields(FleetConfig)}
    config = FleetConfig(
        **{
            k: v
            for k, v in (state.get("config") or {}).items()
            if k in cfg_fields
        }
    )
    server = FleetServer(
        None,  # resolved after replay (mid-swap crashes change it)
        window=geo["window"],
        hop=geo["hop"],
        channels=geo["channels"],
        smoothing=geo["smoothing"],
        ema_alpha=geo["ema_alpha"],
        vote_depth=geo["vote_depth"],
        class_names=geo.get("class_names"),
        config=config,
        fault_hook=fault_hook,
        clock=clock,
        model_version=geo.get("model_version", "v0"),
        mesh=mesh,
    )
    server._replaying = True
    try:
        # ---- snapshot: per-session state -------------------------------
        ladder = state.get("ladder") or {}
        server._smoothing_shed = bool(ladder.get("smoothing_shed", False))
        server._breaches = int(ladder.get("breaches", 0))
        server._ok_streak = int(ladder.get("ok_streak", 0))
        server.stats.load_state(state.get("stats") or {})
        now = server._clock()
        sess_list = state.get("sessions") or []
        for i, s in enumerate(sess_list):
            server.add_session(
                s["sid"], monitor=monitor_from_state(s.get("monitor"))
            )
            sess = server._sessions[s["sid"]]
            asm = sess.asm
            ring = arrays.get(f"ring{i}")
            if ring is not None:
                asm._ring[:] = ring
            asm._n_seen = int(s["n_seen"])
            sess.raw_seen = int(s.get("raw_seen", s["n_seen"]))
            asm._next_emit = int(s["next_emit"])
            sess.n_enqueued = int(s.get("n_enqueued", 0))
            sess.n_scored = int(s.get("n_scored", 0))
            sess.n_dropped = int(s.get("n_dropped", 0))
            # pre-cluster snapshots have no hand-off generation
            sess.handoffs = int(s.get("handoffs", 0))
            ema = arrays.get(f"ema{i}")
            if ema is not None:
                sess.smoother._ema = np.asarray(ema, np.float64)
            votes = s.get("votes") or []
            sess.smoother._votes = deque(
                (int(v) for v in votes), maxlen=geo["vote_depth"]
            )
        # ---- snapshot: the live queue, original FIFO order -------------
        # (re-staged into the arena; pre-arena snapshots carry the same
        # stacked ``pending`` array, so both generations restore here)
        pend_windows = arrays.get("pending")
        for j, (sidx, ti, drift) in enumerate(state.get("pending") or []):
            sess = server._sessions[sess_list[sidx]["sid"]]
            server._restore_pending(
                sess, int(ti),
                np.asarray(pend_windows[j], np.float32), bool(drift), now,
            )
        server.recovered_extra = state.get("extra") or {}
        server.recovered_adapt_records = []

        # ---- replay the journal suffix ---------------------------------
        for meta, payload in records:
            apply_record(server, meta, payload)
    finally:
        server._replaying = False

    server.model = model(server.model_version) if callable(model) else model
    server.stats.recoveries += 1
    server.stats.note_queue_depth(server._n_live)
    if reattach:
        server.attach_journal(
            FleetJournal(journal_dir, journal_config),
            snapshot=True,
            require_fresh=False,  # this IS the resume path
        )
    return server


def recovery_benchmark(
    session_counts,
    n_runs: int = 3,
    *,
    windows_per_session: int = 2,
    seed: int = 13,
    flush_every: int = 64,
) -> list[dict]:
    """THE recovery-time measurement behind ``har_tpu_torch.bench``'s
    ``fleet_recovery`` lane: per session count, drive a journaled
    fleet under live load, kill it (``FleetJournal.kill`` drops the
    un-flushed buffer — the SIGKILL model), and time
    ``FleetServer.restore``; ``contract_ok`` pins the accounting
    invariant across every measured recovery."""
    import shutil
    import tempfile
    import time

    from har_tpu_torch.serve.engine import FleetConfig, FleetServer
    from har_tpu_torch.serve.journal import FleetJournal, JournalConfig
    from har_tpu_torch.serve.loadgen import (
        AnalyticDemoModel,
        drive_fleet,
        synthetic_sessions,
    )

    model = AnalyticDemoModel()
    rows = []
    for n_sessions in session_counts:
        recordings, _ = synthetic_sessions(
            n_sessions, windows_per_session=windows_per_session, seed=seed
        )
        times, journal_mb, ok = [], 0.0, True
        for _ in range(int(n_runs)):
            root = tempfile.mkdtemp(prefix="har_recovery_bench_")
            try:
                server = FleetServer(
                    model, window=200, hop=200, smoothing="ema",
                    config=FleetConfig(max_sessions=n_sessions),
                    journal=FleetJournal(
                        root,
                        JournalConfig(
                            flush_every=flush_every, snapshot_every=0
                        ),
                    ),
                )
                for i in range(n_sessions):
                    server.add_session(i)
                drive_fleet(server, recordings, seed=seed)
                expected = server.stats.scored
                journal_mb = round(
                    sum(
                        os.path.getsize(os.path.join(dirpath, f))
                        for dirpath, _, files in os.walk(root)
                        for f in files
                    )
                    / 1e6,
                    3,
                )
                server.journal.kill()  # SIGKILL model
                t0 = time.perf_counter()
                restored = FleetServer.restore(root, model)
                times.append((time.perf_counter() - t0) * 1e3)
                acct = restored.stats.accounting()
                ok = ok and (
                    acct["balanced"]
                    and acct["scored"] == expected
                    and acct["pending"] == 0
                    and restored.stats.recoveries == 1
                    and len(restored.sessions) == n_sessions
                )
            finally:
                shutil.rmtree(root, ignore_errors=True)
        rows.append(
            {
                "n_sessions": int(n_sessions),
                "windows": int(n_sessions) * windows_per_session,
                "recovery_ms_median": round(float(np.median(times)), 3),
                "recovery_ms_std": round(float(np.std(times)), 3),
                "recovery_ms_runs": [round(t, 3) for t in times],
                "journal_mb": journal_mb,
                "contract_ok": ok,
            }
        )
    return rows


def recovery_benchmark_summary(
    rows: list[dict], n_runs: int, *, windows_per_session: int = 2
) -> dict:
    """The summary the ``fleet_recovery`` lane publishes for
    ``recovery_benchmark``'s rows: the largest session count's median
    and spread, and ``contract_ok`` over every row."""
    return {
        "model": "analytic_demo",
        "n_runs": int(n_runs),
        "windows_per_session": int(windows_per_session),
        "rows": rows,
        "recovery_ms_median": rows[-1]["recovery_ms_median"],
        "recovery_ms_std": rows[-1]["recovery_ms_std"],
        "contract_ok": all(r["contract_ok"] for r in rows),
    }


def recovery_smoke(
    sessions: int = 16, *, seed: int = 0, kill_points=None
) -> dict:
    """The release gate's crash-recovery check: kill a journaled fleet
    at representative stage boundaries, recover each one, and demand
    the full contract — accounting intact, zero windows lost (the
    harness's transport replays from the watermark), and bit-identical
    acked scores vs an uninterrupted run.  Returns a JSON-ready verdict
    with the ``{kill_points, recovered, windows_lost, recovery_ms}``
    stamp the gate log carries."""
    from har_tpu_torch.serve.chaos import KILL_POINTS, run_kill_point

    points = list(kill_points or KILL_POINTS[:3])
    recovered = 0
    windows_lost = 0
    recovery_ms = []
    failures = []
    for point in points:
        out = run_kill_point(point, sessions=sessions, seed=seed)
        if out["ok"]:
            recovered += 1
        else:
            failures.append({"point": point, "why": out["why"]})
        windows_lost += out["windows_lost"]
        recovery_ms.append(out["recovery_ms"])
    return {
        "ok": recovered == len(points) and windows_lost == 0,
        "kill_points": points,
        "recovered": recovered,
        "windows_lost": windows_lost,
        "recovery_ms": round(float(np.median(recovery_ms)), 3),
        "failures": failures,
    }


if __name__ == "__main__":
    import json

    print(json.dumps(recovery_smoke()))
