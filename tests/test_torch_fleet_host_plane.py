"""Structure-of-arrays host plane (har_tpu_torch.serve.arena).

Pins the contracts the SoA session estate ships on:

  1. bit-identity — the batched ingest (``push_many``) and batched
     retire (arena EMA/vote kernels) paths emit event streams
     bit-identical to the sequential shared-code paths, and the fleet
     stays bit-identical to N independent ``StreamingClassifier``s
     (the pre-SoA reference implementation) under FakeClock +
     DispatchFaults across chunk sizes, smoothing modes, churn
     (add / graceful disconnect / cluster hand-off mid-run) and ring
     depths 1–4 — seed-randomized;
  2. arena mechanics — slot alloc/recycle scrubbing, geometric growth
     with live-ring re-pointing, the batched smoother kernels equal to
     the scalar ``_Smoother`` recurrences bitwise, batched drift-
     monitor EWMA updates equal to sequential ``update`` bitwise;
  3. back-compat — a pre-SoA snapshot (per-session ``ring{i}`` /
     ``ema{i}`` arrays + metadata dicts) restores into the arena
     cleanly, and today's snapshots still WRITE that same layout;
  4. the CLI path — ``FleetConfig.for_sessions`` auto-raises
     ``max_sessions`` past the 4096 default so ``har serve --sessions
     10000`` admits, and ``--profile-host`` stamps the per-poll
     breakdown into the summary JSON.
"""

import json

import numpy as np
import pytest

from har_tpu_torch.monitoring import DriftMonitor
from har_tpu_torch.serve import (
    DispatchFaults,
    FakeClock,
    FleetConfig,
    FleetServer,
    SessionArena,
    StagingArena,
    events_equal,
)
from har_tpu_torch.serve.stats import StageHistogram
from har_tpu_torch.serving import StreamingClassifier, _Smoother


class _StubModel:
    """Row-deterministic numpy stand-in — batch-composition-independent
    per-row outputs, the fleet-equivalence oracle's model."""

    num_classes = 3

    def transform(self, x):
        from har_tpu_torch.models.base import Predictions

        x = np.asarray(x)
        m = x.mean(axis=(1, 2))
        raw = np.stack([-m, m, np.zeros_like(m)], axis=-1)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return Predictions.from_raw(raw, e / e.sum(axis=-1, keepdims=True))


# ------------------------------------------------------ arena mechanics


def test_arena_alloc_scrubs_recycled_slots():
    a = SessionArena(10, 3, vote_depth=4, capacity=8)
    s = a.alloc()
    a.rings[s] += 7.0
    a.n_seen[s] = 123
    a.next_emit[s] = 456
    a.n_scored[s] = 9
    a.votes[s, 0] = 2
    a.vote_len[s] = 3
    a.ema_set[s] = True
    a.release(s)
    s2 = a.alloc()
    assert s2 == s  # recycled
    assert not a.rings[s2].any()
    assert a.n_seen[s2] == 0
    assert a.next_emit[s2] == 10  # a fresh assembler's first boundary
    assert a.n_scored[s2] == 0
    assert a.vote_len[s2] == 0 and a.vote_head[s2] == 0
    assert not a.ema_set[s2] and not a.ema_local[s2]


def test_arena_growth_repoints_live_rings():
    """Admitting past the arena's capacity reallocates the ring block;
    every live assembler's ring view must follow (the engine re-points
    on growth), and the streams keep scoring correctly."""
    n = 70
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(max_sessions=4096),
    )
    # engine sizes the arena at min(max_sessions, 1024); shrink it so
    # the test forces growth without 1k admissions
    from har_tpu_torch.serve.arena import SessionArena as SA

    server._session_arena = SA(10, 3, 5, capacity=8)
    server._ema_kernel = server._session_arena.ema_block_for(0.4)
    for i in range(n):
        server.add_session(i)
    arena = server._session_arena
    assert arena.grows >= 1
    for sess in server._sessions.values():
        assert np.shares_memory(sess.asm._ring, arena.rings)
    rng = np.random.default_rng(0)
    for i in range(n):
        server.push(i, rng.normal(size=(10, 3)).astype(np.float32))
    events = server.flush()
    assert len(events) == n
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0


@pytest.mark.parametrize("mode", ["ema", "vote"])
def test_batched_smoother_kernels_bitwise_equal_scalar(mode):
    """The arena's batched EMA/vote kernels against the scalar
    ``_Smoother`` recurrence, row by row, bitwise — the math behind the
    retire path's one-vectorized-call smoothing."""
    rng = np.random.default_rng(3)
    m, C, depth = 17, 5, 4
    arena = SessionArena(10, 3, vote_depth=depth, capacity=32)
    slots = np.asarray([arena.alloc() for _ in range(m)], np.intp)
    refs = [_Smoother(mode, 0.35, depth) for _ in range(m)]
    kernel = arena.ema_block_for(0.35)
    for _ in range(7):
        probs = rng.random((m, C))
        probs /= probs.sum(axis=1, keepdims=True)
        raws = probs.argmax(axis=1)
        if mode == "ema":
            block = kernel(slots, probs)
            labels = block.argmax(axis=1)
        else:
            labels, block = arena.vote_block(slots, raws, C)
        for j, ref in enumerate(refs):
            want_label, want_raw, want_sm = ref.step(probs[j].copy())
            assert int(labels[j]) == want_label
            assert int(raws[j]) == want_raw
            np.testing.assert_array_equal(block[j], want_sm)


def test_vote_block_stale_wide_vote_defers_without_mutation():
    """A stale vote wider than the class count must make the kernel
    decline BEFORE touching the rings — the scalar fallback then does
    the per-session widening as the FIRST push of that label."""
    arena = SessionArena(10, 3, vote_depth=3, capacity=8)
    s = arena.alloc()
    arena.votes[s, 0] = 7  # stale vote from a wider model
    arena.vote_len[s] = 1
    arena.vote_head[s] = 1
    before = (
        arena.votes.copy(), arena.vote_len.copy(), arena.vote_head.copy()
    )
    out = arena.vote_block(
        np.asarray([s], np.intp), np.asarray([1]), n_classes=3
    )
    assert out is None
    np.testing.assert_array_equal(arena.votes, before[0])
    np.testing.assert_array_equal(arena.vote_len, before[1])
    np.testing.assert_array_equal(arena.vote_head, before[2])


def test_monitor_update_many_bitwise_equals_update():
    """Batched drift EWMA step == sequential update, bitwise, verdicts
    included — the journal-replay argument (replay re-runs updates
    sequentially, so an ulp of batched drift would surface post-crash)."""
    rng = np.random.default_rng(5)
    m, n, C = 9, 20, 3
    ref_mean, ref_std = rng.normal(size=C), rng.random(C) + 0.5
    mons_a = [
        DriftMonitor(ref_mean, ref_std, halflife=50.0, patience=2)
        for _ in range(m)
    ]
    mons_b = [
        DriftMonitor(ref_mean, ref_std, halflife=50.0, patience=2)
        for _ in range(m)
    ]
    mons_a[3] = mons_b[3] = None  # None rows pass through
    for step in range(6):
        block = rng.normal(
            3.0 if step >= 3 else 0.0, 1.0, size=(m, n, C)
        )
        reports = DriftMonitor.update_many(mons_a, block)
        for j in range(m):
            if mons_b[j] is None:
                assert reports[j] is None
                continue
            want = mons_b[j].update(block[j])
            got = reports[j]
            assert got.drifting == want.drifting
            assert got.onset == want.onset
            assert got.n_samples == want.n_samples
            np.testing.assert_array_equal(got.location_z, want.location_z)
            np.testing.assert_array_equal(
                got.scale_log_ratio, want.scale_log_ratio
            )
            np.testing.assert_array_equal(mons_a[j]._mean, mons_b[j]._mean)
            np.testing.assert_array_equal(mons_a[j]._var, mons_b[j]._var)


def test_stage_histogram_record_many_equals_record():
    rng = np.random.default_rng(11)
    vals = rng.gamma(2.0, 5.0, size=300)
    a, b = StageHistogram(), StageHistogram()
    for v in vals:
        a.record(float(v))
    b.record_many(vals)
    assert a.count == b.count
    assert a.buckets == b.buckets
    assert a.max_ms == b.max_ms
    assert abs(a.total_ms - b.total_ms) < 1e-6 * a.total_ms
    assert list(a._recent) == pytest.approx(list(b._recent))


def test_staging_put_block_pair_matches_concat():
    arena = StagingArena(10, 3, capacity=8)
    rng = np.random.default_rng(2)
    head = rng.normal(size=(5, 6, 3)).astype(np.float32)
    tail = rng.normal(size=(5, 4, 3)).astype(np.float32)
    toks = arena.put_block_pair(head, tail)
    want = np.concatenate([head, tail], axis=1)
    np.testing.assert_array_equal(arena.gather(toks), want)
    # zero-length head (boundary == full window from the chunk)
    toks2 = arena.put_block_pair(
        np.empty((2, 0, 3), np.float32), want[:2]
    )
    np.testing.assert_array_equal(arena.gather(toks2), want[:2])


# -------------------------------------------- push_many bit-identity


@pytest.mark.parametrize("smoothing", ["ema", "vote", "none"])
def test_push_many_bit_identical_to_sequential_push(smoothing):
    """Batched rounds (mid-chunk boundaries, bursts, monitors on half
    the fleet, occasional poisoned rows) against per-session pushes:
    same events, same accounting, bitwise."""
    n = 32
    rng = np.random.default_rng(17)
    recs = [
        rng.normal(size=(520, 3)).astype(np.float32) for _ in range(n)
    ]
    recs[4][100] = np.nan  # ingest guard must behave identically
    recs[9][30] = 1e9
    ref_mean, ref_std = np.zeros(3), np.ones(3)

    def run(batched):
        server = FleetServer(
            _StubModel(), window=100, hop=20, smoothing=smoothing,
            config=FleetConfig(max_sessions=n, target_batch=64),
        )
        for i in range(n):
            server.add_session(
                i,
                monitor=(
                    DriftMonitor(ref_mean, ref_std, halflife=60.0)
                    if i % 2
                    else None
                ),
            )
        cursors = [0] * n
        offs = np.random.default_rng(23).integers(1, 20, size=n)
        events = []
        r = 0
        while any(c < len(recs[i]) for i, c in enumerate(cursors)):
            ids, chunks = [], []
            for i in range(n):
                if cursors[i] >= len(recs[i]):
                    continue
                # mixed sizes: steady 20s, a couple of phase lengths,
                # and an occasional multi-window catch-up burst
                if r == 0:
                    take = int(offs[i])
                elif (i + r) % 11 == 0:
                    take = 150
                else:
                    take = 20
                ids.append(i)
                chunks.append(recs[i][cursors[i]: cursors[i] + take])
                cursors[i] += take
            if batched:
                server.push_many(ids, chunks)
            else:
                for sid, c in zip(ids, chunks):
                    server.push(sid, c)
            events.extend(server.poll(force=True))
            r += 1
        events.extend(server.flush())
        by = {i: [] for i in range(n)}
        for fe in events:
            by[fe.session_id].append(fe.event)
        return server, by

    s_seq, seq = run(False)
    s_bat, bat = run(True)
    for i in range(n):
        assert len(seq[i]) == len(bat[i]) > 0
        for a, b in zip(seq[i], bat[i]):
            assert events_equal(a, b)
            np.testing.assert_array_equal(a.probability, b.probability)
    assert s_seq.stats.enqueued == s_bat.stats.enqueued
    assert s_seq.stats.scored == s_bat.stats.scored
    assert s_seq.stats.rejected_samples == s_bat.stats.rejected_samples
    for s in (s_seq, s_bat):
        acct = s.stats.accounting()
        assert acct["balanced"] and acct["pending"] == 0


def test_push_many_rejects_malformed_chunk_before_any_mutation():
    """A wrong-channel chunk anywhere in the round must raise BEFORE
    any ring roll / staging / counter advance — a mid-round raise
    after fast rows had ingested would strand the fleet in a state no
    push sequence can produce (regression: the stranded fast
    rows leaked staging slots and broke export/accounting)."""
    n = 3
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(max_sessions=n),
    )
    for i in range(n):
        server.add_session(i)
    good = np.ones((10, 3), np.float32)
    with pytest.raises(ValueError, match="expected"):
        server.push_many(
            [0, 1, 2], [good, np.ones((5, 4), np.float32), good]
        )
    # nothing advanced: no windows, no watermarks, sessions exportable
    assert server.stats.enqueued == 0
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    for i in range(n):
        assert server.watermark(i) == 0
        server.export_session(i)  # no phantom live windows
    assert server._arena.in_use == 0  # no leaked staging slots


def test_push_many_mid_chunk_drift_flag_reads_head_report():
    """The emitted window's drift flag must come from the monitor state
    AT the boundary (after the head sub-chunk update, before the tail
    one) — exactly the sequential consume's cadence.  A chunk whose
    tail flips the verdict must not leak the post-boundary verdict
    onto the window emitted at the boundary (regression)."""
    window, hop = 10, 5
    ref_mean, ref_std = np.zeros(3), np.ones(3)
    rng = np.random.default_rng(1)
    head = rng.normal(0, 1, size=(8, 3)).astype(np.float32)
    tail = np.concatenate(
        [
            rng.normal(0, 1, size=(2, 3)),
            np.full((2, 3), 50.0),  # the tail sub-chunk drifts hard
        ]
    ).astype(np.float32)

    def run(batched):
        server = FleetServer(
            _StubModel(), window=window, hop=hop, smoothing="none",
            config=FleetConfig(max_sessions=1, max_abs_sample=None),
        )
        server.add_session(
            0,
            monitor=DriftMonitor(
                ref_mean, ref_std, halflife=4.0, patience=1
            ),
        )
        server.push(0, head)
        if batched:
            server.push_many([0], [tail])
        else:
            server.push(0, tail)
        return server.flush()

    seq = run(False)
    bat = run(True)
    assert [e.event.t_index for e in seq] == [10]
    assert [e.event.t_index for e in bat] == [10]
    assert seq[0].event.drift == bat[0].event.drift


# -------------------------- the SoA-vs-reference churn property test


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_soa_fleet_bit_identical_under_churn_and_depths(seed):
    """THE tentpole pin, seed-randomized: a SoA fleet at a drawn ring
    depth (1–4) under FakeClock + DispatchFaults, with mid-run churn —
    new sessions admitted, a cohort gracefully disconnected, a cohort
    migrated to a second worker via export/adopt — must emit
    per-session event streams bit-identical to independent
    ``StreamingClassifier``s (the pre-SoA shared-code reference) fed
    the same delivery chunks.  Disconnect flush windows (off the hop
    grid by construction) are excluded from the oracle comparison —
    a standalone classifier has no disconnect."""
    rng = np.random.default_rng((seed, 0xC0FFEE))
    n = 64
    depth = int(rng.integers(1, 5))
    smoothing = ("ema", "vote", "none")[seed % 3]
    window, hop = 100, 50
    recs = [
        rng.normal(size=(int(rng.integers(400, 700)), 3)).astype(
            np.float32
        )
        for _ in range(n + 8)
    ]
    clock = FakeClock()

    def build(max_sessions):
        return FleetServer(
            _StubModel(), window=window, hop=hop, smoothing=smoothing,
            config=FleetConfig(
                max_sessions=max_sessions, target_batch=32,
                max_delay_ms=0.0, retries=1, pipeline_depth=depth,
            ),
            fault_hook=DispatchFaults(
                stall_every=4, stall_ms=1.0, fail_every=7,
                fake_clock=clock,
            ),
            clock=clock,
        )

    server_a = build(n + 8)
    server_b = build(16)
    for i in range(n):
        server_a.add_session(i)
    chunks_by_sid: dict[int, list] = {i: [] for i in range(n + 8)}
    where = {i: "a" for i in range(n)}
    events_by_sid: dict[int, list] = {i: [] for i in range(n + 8)}

    def collect(evs):
        for fe in evs:
            events_by_sid[fe.session_id].append(fe.event)

    cursors = [0] * (n + 8)
    r = 0
    while any(
        cursors[i] < len(recs[i])
        for i in range(n + 8)
        if where.get(i) not in (None, "gone")
    ) or r < 4:
        if r == 3:
            # churn burst: admit 8 new sessions, gracefully disconnect
            # 4, migrate 4 to the second worker (drain, then
            # export/adopt — the cluster hand-off path)
            for i in range(n, n + 8):
                server_a.add_session(i)
                where[i] = "a"
            collect(server_a.flush())  # drain before export
            collect(server_a.disconnect_sessions([0, 1, 2, 3]))
            for i in (0, 1, 2, 3):
                where[i] = "gone"
            for i in (4, 5, 6, 7):
                server_b.adopt_session(server_a.handoff_session(i))
                where[i] = "b"
        for i in range(n + 8):
            w = where.get(i)
            if w in (None, "gone") or cursors[i] >= len(recs[i]):
                continue
            step = int(rng.integers(10, 140))
            chunk = recs[i][cursors[i]: cursors[i] + step]
            cursors[i] += step
            chunks_by_sid[i].append(chunk)
            (server_a if w == "a" else server_b).push(i, chunk)
        collect(server_a.poll(force=True))
        collect(server_b.poll(force=True))
        clock.advance(0.01)
        r += 1
    collect(server_a.flush())
    collect(server_b.flush())

    checked = 0
    for i in range(n + 8):
        if not chunks_by_sid[i]:
            continue
        sc = StreamingClassifier(
            _StubModel(), window=window, hop=hop, smoothing=smoothing
        )
        want = []
        for c in chunks_by_sid[i]:
            want.extend(sc.push(c))
        got = [
            ev for ev in events_by_sid[i]
            # the one off-grid event a graceful disconnect flushes
            if (ev.t_index - window) % hop == 0
        ]
        assert len(got) == len(want), (i, len(got), len(want))
        for g, w in zip(got, want):
            assert events_equal(g, w)
            np.testing.assert_array_equal(g.probability, w.probability)
        checked += len(got)
    assert checked > n
    for s in (server_a, server_b):
        acct = s.stats.accounting()
        assert acct["balanced"]


# ------------------------------------------------- snapshot back-compat


def test_pre_soa_snapshot_restores_into_arena(tmp_path):
    """A snapshot written in the pre-SoA per-session layout — ring{i}/
    ema{i} arrays, per-session metadata dicts, votes as lists, a
    stacked ``pending`` array with [sidx, t_index, drift] metadata
    rows, NO session_arena/pending_arena extras — restores cleanly:
    state lands in the SoA arenas through the façades, the recovered
    pending window re-stages and scores, streams continue
    bit-identically, and no new record types were needed (the pending queue's
    SoA pending queue serializes back to this exact layout)."""
    from har_tpu_torch.serve.journal import FleetJournal, JournalConfig

    root = str(tmp_path / "old")
    j = FleetJournal(root, JournalConfig(flush_every=1, snapshot_every=0))
    rng = np.random.default_rng(4)
    ring = rng.normal(size=(100, 3)).astype(np.float32)
    ema = rng.random(3)
    pend = rng.normal(size=(1, 100, 3)).astype(np.float32)
    state = {
        "geometry": {
            "window": 100, "hop": 50, "channels": 3,
            "smoothing": "ema", "ema_alpha": 0.4, "vote_depth": 5,
            "class_names": None, "model_version": "v0",
        },
        "config": {"max_sessions": 8, "target_batch": 32},
        "ladder": {
            "smoothing_shed": False, "breaches": 0, "ok_streak": 0,
        },
        "stats": {"counters": {"enqueued": 4, "scored": 3}},
        "sessions": [
            {
                "sid": 0, "n_seen": 250, "raw_seen": 250,
                "next_emit": 300, "n_enqueued": 4, "n_scored": 3,
                "n_dropped": 0, "votes": [1, 2], "monitor": None,
            }
        ],
        # one un-acked window, the pre-crash queue's FIFO layout
        "pending": [[0, 250, False]],
        "extra": {},  # pre-SoA: no session_arena/pending_arena record
    }
    j.write_snapshot(
        state, {"ring0": ring, "ema0": ema, "pending": pend}
    )
    j.close()
    restored = FleetServer.restore(root, _StubModel(), reattach=False)
    sess = restored._sessions[0]
    np.testing.assert_array_equal(sess.asm._ring, ring)
    assert sess.asm._n_seen == 250 and sess.asm._next_emit == 300
    assert sess.n_scored == 3 and sess.raw_seen == 250
    np.testing.assert_array_equal(sess.smoother._ema, ema)
    assert list(sess.smoother._votes) == [1, 2]
    # the recovered pending window re-staged into the SoA queue ...
    assert sess.n_live == 1 and restored._pending.queued == 1
    np.testing.assert_array_equal(
        restored._arena.gather(
            restored._pending.stage_slot[
                restored._pending.ring_indices()
            ]
        )[0],
        pend[0],
    )
    # ... and scores first, then the stream continues at t=300
    evs = restored.flush()
    assert [e.event.t_index for e in evs] == [250]
    assert restored.push(
        0, rng.normal(size=(50, 3)).astype(np.float32)
    ) == 1
    evs = restored.flush()
    assert [e.event.t_index for e in evs] == [300]
    # today's snapshot writes the SAME per-session layout back
    restored.attach_journal(
        str(tmp_path / "new"), JournalConfig(snapshot_every=0)
    )
    from har_tpu_torch.serve.journal import load_journal

    state2, arrays2, _ = load_journal(str(tmp_path / "new"))
    assert "ring0" in arrays2 and "ema0" in arrays2
    assert state2["sessions"][0]["n_seen"] == 300
    assert "session_arena" in state2["extra"]  # observability only
    assert "pending_arena" in state2["extra"]  # observability only


# --------------------------------------------------- CLI path pins


def test_fleet_config_for_sessions_auto_raises_and_respects_override():
    assert FleetConfig().max_sessions == 4096
    assert FleetConfig.for_sessions(10000).max_sessions == 10000
    assert FleetConfig.for_sessions(100).max_sessions == 100
    # the explicit-config override still wins
    assert (
        FleetConfig.for_sessions(10000, max_sessions=4096).max_sessions
        == 4096
    )


def test_ten_thousand_sessions_admit_through_cli_config():
    """The admission half of the CLI pin without a 10k-session drive:
    the config the CLI builds for --sessions 10000 must admit 10000
    sessions (pre-SoA this died at the 4096 default when a config
    omitted max_sessions)."""
    server = FleetServer(
        _StubModel(), window=10, hop=10,
        config=FleetConfig.for_sessions(10000),
    )
    for i in range(10000):
        server.add_session(i)
    assert len(server.sessions) == 10000


def test_cli_serve_profile_host_stamps_breakdown(capsys):
    from har_tpu_torch.cli import main

    main([
        "serve", "--device", "cpu", "--sessions", "24", "--windows-per-session", "1",
        "--profile-host",
    ])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["sessions"] == 24
    prof = out["host_profile"]
    assert prof is not None
    for phase in (
        "ingest_ms", "due_select_ms", "gather_ms", "retire_ms",
        "journal_ms",
    ):
        assert phase in prof
    assert prof["ingest_ms"]["count"] > 0
    assert prof["retire_ms"]["count"] > 0
    # the full breakdown also rides the stats snapshot
    assert out["stats"]["host_profile"] == prof
