"""SoA pending queue + zero-copy staging.

Pins the contracts the pending-arena refactor ships on:

  1. zero allocation — the steady-state enqueue→retire path creates
     ZERO per-window Python objects (gc object census: enqueueing N
     windows adds O(1) tracked objects, and a full enqueue→poll→retire
     cycle leaves O(1) residue once its events are dropped);
  2. pending-arena mechanics — slot refcount lifecycle (ring/ticket +
     session-list references), FIFO ring wrap + growth, dropped-entry
     skip semantics identical to the per-object queue;
  3. zero-copy staging — FIFO-recycled slots make a delivery round's
     batch one ascending run, so ``gather`` returns a slice VIEW (the
     launch hands the device the staged bytes themselves) and
     ``gather_into`` degenerates to a block copy; fragmented rounds
     (mid-flight evictions punch holes) fall back to the scatter-gather
     copy — both directions pinned at the arena AND the engine level;
  4. the queue as chaos/recovery currency — covered by the existing
     kill-point matrix, snapshot fixtures and churn property tests
     (tests/test_recovery.py, tests/test_host_plane.py), which run
     unchanged against the SoA queue.
"""

import gc

import numpy as np
import pytest

from har_tpu_torch.serve import (
    FleetConfig,
    FleetServer,
    PendingArena,
    StagingArena,
)


class _StubModel:
    num_classes = 3

    def transform(self, x):
        from har_tpu_torch.models.base import Predictions

        x = np.asarray(x)
        m = x.mean(axis=(1, 2))
        raw = np.stack([-m, m, np.zeros_like(m)], axis=-1)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return Predictions.from_raw(raw, e / e.sum(axis=-1, keepdims=True))


# ------------------------------------------------ pending-arena mechanics


def test_pending_arena_slot_lifecycle_and_refcounts():
    pq = PendingArena(capacity=32)
    i = pq.add(5, 100, 7, True, 1.5)
    assert pq.sess_slot[i] == 5 and pq.t_index[i] == 100
    assert pq.stage_slot[i] == 7 and pq.drift[i]
    assert pq.refs[i] == 2 and pq.queued == 1
    # launch pop TRANSFERS the queue-side ref (count unchanged)
    batch = pq.pop_batch(8)
    assert list(batch) == [i]
    assert pq.launched[i] and pq.refs[i] == 2 and pq.queued == 0
    # session-list release then ticket release recycles the slot
    pq.release(i)
    assert pq.refs[i] == 1 and pq.in_use == 1
    pq.release_block(batch)
    assert pq.in_use == 0
    # the recycled slot comes back with fresh flags
    j = pq.add(3, 200, 9, False, 2.0)
    assert not pq.dropped[j] and not pq.launched[j] and pq.refs[j] == 2


def test_pending_arena_dropped_entries_skip_and_release_on_pop():
    pq = PendingArena(capacity=32)
    a = pq.add(0, 0, 0, False, 0.0)
    b = pq.add(1, 0, 1, False, 0.0)
    c = pq.add(2, 0, 2, False, 0.0)
    pq.dropped[b] = True
    batch = pq.pop_batch(2)
    assert list(batch) == [a, c]  # b skipped, queue-side ref released
    assert pq.refs[b] == 1
    pq.release(b)  # session-list clear
    assert pq.in_use == 2  # b recycled, a and c still live


def test_pending_arena_ring_wraps_and_grows():
    pq = PendingArena(capacity=32)
    rng = np.random.default_rng(0)
    live = []
    for step in range(200):
        i = pq.add(0, step, step, False, float(step))
        live.append(i)
        if rng.random() < 0.5 and live:
            batch = pq.pop_batch(1)
            for j in batch:
                pq.release(int(j))  # session-list ref
            pq.release_block(batch)  # ticket ref
            live.remove(int(batch[0]))
    order = pq.ring_indices()
    # FIFO order survives wraps/growth: t_index strictly increasing
    t = pq.t_index[order]
    assert (t[1:] > t[:-1]).all()
    assert pq.queued == len(live)


def test_oldest_live_enqueue_skips_dropped_heads():
    pq = PendingArena(capacity=32)
    a = pq.add(0, 0, 0, False, 1.0)
    pq.add(1, 0, 1, False, 2.0)
    pq.dropped[a] = True
    assert pq.oldest_live_enqueue() == 2.0
    assert pq.refs[a] == 1  # popped off the ring on the way
    assert pq.queued == 1


# ---------------------------------------------- zero-allocation census


def _steady_server(n=256):
    server = FleetServer(
        _StubModel(), window=100, hop=20, smoothing="none",
        config=FleetConfig(max_sessions=n, target_batch=256),
    )
    for i in range(n):
        server.add_session(i)
    return server


def test_zero_per_window_python_objects_on_enqueue_and_retire():
    """THE allocation pin: a steady-state delivery round (one uniform
    hop-sized chunk per session, every session completing one window)
    enqueues through the SoA pending queue with O(1) — NOT O(windows)
    — new gc-tracked Python objects, and a full enqueue→poll→retire
    cycle leaves O(1) residue once its events are released.  The
    per-window ``_Pending`` class itself is gone from the engine."""
    import har_tpu_torch.serve.engine as engine_mod

    assert not hasattr(engine_mod, "_Pending")
    n = 256
    server = _steady_server(n)
    rng = np.random.default_rng(7)
    rounds = [
        [rng.normal(size=(20, 3)).astype(np.float32) for _ in range(n)]
        for _ in range(8)
    ]
    ids = list(range(n))
    # warmup: fill rings past the first boundary, grow every arena to
    # its steady capacity, and — critically — let several REAL
    # dispatches run (the first dispatch pays one-time lazy imports
    # and scorer construction, which would swamp the census)
    for r in range(7):
        server.push_many(ids, rounds[r])
        server.poll(force=True)
    assert server.stats.dispatches >= 2
    gc.collect()
    gc.disable()
    try:
        # NO asserts inside the census window: the first comparison in
        # a pytest-rewritten assert lazily imports the assertion-repr
        # machinery (thousands of objects) and would swamp the count
        before = len(gc.get_objects())
        server.push_many(ids, rounds[7])  # enqueues n windows
        after_enqueue = len(gc.get_objects())
        events = server.poll(force=True)
        n_events = len(events)
        del events
        gc.collect()
        after_cycle = len(gc.get_objects())
    finally:
        gc.enable()
    assert n_events == n
    enqueue_delta = after_enqueue - before
    cycle_delta = after_cycle - before
    # O(1) bounds far below one-object-per-window (n == 256)
    assert enqueue_delta < 64, enqueue_delta
    assert cycle_delta < 96, cycle_delta
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0


# ------------------------------------------------- zero-copy staging


def test_staging_gather_returns_view_on_contiguous_run():
    arena = StagingArena(10, 3, capacity=16)
    wins = np.random.default_rng(1).normal(size=(5, 10, 3)).astype(
        np.float32
    )
    slots = arena.put_block(wins)
    assert (np.diff(slots) == 1).all()  # FIFO alloc: ascending run
    got = arena.gather(slots)
    assert np.shares_memory(got, arena._buf)  # a VIEW, no copy
    np.testing.assert_array_equal(got, wins)
    # gather_view: the fused exact-fit path's explicit check
    assert np.shares_memory(arena.gather_view(slots), arena._buf)
    # fragmented request: falls back to a fancy-index COPY
    frag = np.asarray([slots[0], slots[2], slots[4]])
    got2 = arena.gather(frag)
    assert not np.shares_memory(got2, arena._buf)
    np.testing.assert_array_equal(got2, wins[[0, 2, 4]])
    assert arena.gather_view(frag) is None
    # gather_into on a contiguous run: block copy, same bytes as take
    out = np.empty((8, 10, 3), np.float32)
    arena.gather_into(slots, out)
    np.testing.assert_array_equal(out[:5], wins)
    np.testing.assert_array_equal(out[5], wins[-1])  # tail fill


def test_staging_fifo_recycling_keeps_rounds_contiguous():
    """Retire-order ``free_block`` recycling: the NEXT round's block
    allocation reuses the freed slots in their original order, so
    steady-state rounds stay ascending runs round after round."""
    arena = StagingArena(10, 3, capacity=8)
    for _ in range(5):  # several full cycles through the 8-slot block
        slots = arena.put_block(np.zeros((6, 10, 3), np.float32))
        assert (np.diff(slots) == 1).all() or (
            # the wrap round: one seam where the ring restarts
            (np.diff(slots) == 1).sum() >= len(slots) - 2
        )
        assert arena.gather(slots).shape == (6, 10, 3)
        arena.free_block(slots)


def test_launch_hands_the_scorer_a_staging_view_on_in_order_rounds():
    """Engine-level zero-copy pin: on an in-order exact-fit round the
    batch the scorer receives IS the staging buffer (a slice view —
    the staged-window double copy is gone); a round fragmented by a
    mid-flight eviction falls back to the gather copy and still scores
    correctly."""
    captured = []
    stub = _StubModel()

    class SpyModel:
        num_classes = 3

        def transform(self, x):
            captured.append(x)
            return stub.transform(x)

    server = FleetServer(
        SpyModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(max_sessions=8, target_batch=4,
                           max_delay_ms=0.0),
    )
    for i in range(4):
        server.add_session(i)
    rng = np.random.default_rng(3)
    for i in range(4):
        server.push(i, rng.normal(size=(10, 3)).astype(np.float32))
    events = server.poll(force=True)
    assert len(events) == 4
    assert np.shares_memory(captured[-1], server._arena._buf)
    # fragment: enqueue 3 windows, evict the middle session before the
    # poll — its staging slot frees early (un-launched), the batch's
    # slots are no longer one run, the copy fallback serves
    for i in range(3):
        server.push(i, rng.normal(size=(10, 3)).astype(np.float32))
    server.remove_session(1)
    events = server.poll(force=True)
    assert sorted(fe.session_id for fe in events) == [0, 2]
    assert not np.shares_memory(captured[-1], server._arena._buf)
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0


# --------------------------------- mid-flight eviction + shed pressure


def test_remove_session_while_launched_defers_staging_free_to_retire():
    """A session removed while its windows ride a carried ticket: the
    flagged rows emit no event, their staging slots free at RETIRE
    (never re-staged under the in-flight view), accounting balances,
    and the pending slots recycle exactly once."""
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(
            max_sessions=8, target_batch=4, max_delay_ms=0.0,
            pipeline_depth=2,
        ),
    )
    for i in range(4):
        server.add_session(i)
    rng = np.random.default_rng(5)
    for i in range(4):
        server.push(i, rng.normal(size=(10, 3)).astype(np.float32))
    # non-forced poll with depth 2: the ticket launches and CARRIES
    events = server.poll()
    assert events == [] and len(server._inflight) == 1
    in_use_before = server._arena.in_use
    server.remove_session(2)  # its launched window is mid-flight
    # deferred: the staging slot is NOT freed at eviction time
    assert server._arena.in_use == in_use_before
    events = server.flush()
    assert sorted(fe.session_id for fe in events) == [0, 1, 3]
    assert server._arena.in_use == 0  # freed at retire, exactly once
    assert server._pending.in_use == 0
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert acct["dropped"] == 1
    assert server.stats.dropped == {"session_removed": 1}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_soa_queue_under_shed_pressure_and_eviction_matches_oracle(seed):
    """The churn property test's pressure extension: N=64
    sessions under FakeClock + DispatchFaults at a drawn ring depth,
    with TIGHT drawn queue bounds (per-session and global sheds fire
    constantly) and sessions evicted mid-run while their windows ride
    carried tickets.  The oracle is unchanged — independent
    ``StreamingClassifier``s fed the same chunks — and because
    smoothing is stateless here, every event the fleet DOES emit must
    be bitwise equal to the oracle's event at the same ``t_index``
    (shed windows simply have no event), and the conservation law must
    balance with every drop attributed to a declared reason."""
    from har_tpu_torch.serve import DispatchFaults, FakeClock
    from har_tpu_torch.serving import StreamingClassifier

    rng = np.random.default_rng((seed, 0x50A2))
    n = 64
    depth = int(rng.integers(1, 5))
    max_pending = int(rng.integers(2, 5))
    max_queue = int(rng.integers(24, 64))
    window, hop = 100, 50
    clock = FakeClock()
    server = FleetServer(
        _StubModel(), window=window, hop=hop, smoothing="none",
        config=FleetConfig(
            max_sessions=n, target_batch=16, max_delay_ms=0.0,
            retries=1, pipeline_depth=depth,
            max_pending_per_session=max_pending,
            max_queue_windows=max_queue,
        ),
        fault_hook=DispatchFaults(
            stall_every=5, stall_ms=1.0, fail_every=9, fake_clock=clock
        ),
        clock=clock,
    )
    recs = [
        rng.normal(size=(int(rng.integers(500, 900)), 3)).astype(
            np.float32
        )
        for _ in range(n)
    ]
    for i in range(n):
        server.add_session(i)
    chunks_by_sid: dict[int, list] = {i: [] for i in range(n)}
    events_by_sid: dict[int, list] = {i: [] for i in range(n)}
    gone: set[int] = set()
    cursors = [0] * n
    r = 0
    while any(
        cursors[i] < len(recs[i]) for i in range(n) if i not in gone
    ):
        for i in range(n):
            if i in gone or cursors[i] >= len(recs[i]):
                continue
            step = int(rng.integers(20, 260))
            chunk = recs[i][cursors[i]: cursors[i] + step]
            cursors[i] += step
            chunks_by_sid[i].append(chunk)
            server.push(i, chunk)
        # every third round polls un-forced so carried tickets fly,
        # then an eviction lands while windows are launched
        forced = r % 3 != 2
        for fe in server.poll(force=forced):
            events_by_sid[fe.session_id].append(fe.event)
        if r in (2, 5, 8):
            victim = int(rng.integers(0, n))
            if victim not in gone:
                server.remove_session(victim)
                gone.add(victim)
        clock.advance(0.01)
        r += 1
    for fe in server.flush():
        events_by_sid[fe.session_id].append(fe.event)

    shed_reasons = {
        "session_queue", "backpressure", "dispatch_failed",
        "session_removed", "slo_shed",
    }
    assert set(server.stats.dropped) <= shed_reasons
    assert server.stats.dropped_total > 0  # pressure actually fired
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    # estate hygiene: every staging slot freed, and any pending slot
    # still allocated is a flagged-dropped leftover lazily parked in a
    # ring/session-list position (the per-object queue kept dropped
    # deque entries exactly the same way, bounded by the queue caps) —
    # a LIVE slot surviving the drain would be a leak
    pq = server._pending
    assert np.all(pq.dropped[pq.refs > 0])
    assert server._arena.in_use == 0

    checked = 0
    for i in range(n):
        if not chunks_by_sid[i]:
            continue
        sc = StreamingClassifier(
            _StubModel(), window=window, hop=hop, smoothing="none"
        )
        want = {}
        for c in chunks_by_sid[i]:
            for ev in sc.push(c):
                want[ev.t_index] = ev
        for got in events_by_sid[i]:
            w = want[got.t_index]  # KeyError = phantom window
            assert got.label == w.label
            assert got.raw_label == w.raw_label
            assert got.drift == w.drift
            np.testing.assert_array_equal(got.probability, w.probability)
            checked += 1
    assert checked > n  # the fleet still served plenty under pressure
