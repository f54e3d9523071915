"""Structure-of-arrays session estate for the fleet engine.

With the device side of a dispatch made nearly free (fused program,
8 B/window fetch, pooled slabs), the Python host plane was the next
bottleneck at 1,000 sessions: every session owned its
own ring-buffer array, smoother arrays and Python counters, so each
delivery round and each retire paid thousands of scattered small-object
operations.  This module turns that dict-of-objects estate into
structure-of-arrays form — the ROADMAP "Host-plane scale: 10k–100k
sessions per worker" item:

  ``SessionArena`` — ONE contiguous block per kind of per-session
    state: ring buffers ``(capacity, window, channels)``, ring
    heads/fills (``n_seen`` / ``next_emit``) as int arrays, per-session
    accounting counters as int arrays, EMA smoother state as one
    ``(capacity, C)`` float64 block, and vote smoother state as an
    integer ring ``(capacity, vote_depth)``.  A session is a SLOT index
    into these arrays; admission allocates a slot, removal/hand-off
    recycles it (``release`` is O(1); the recycled row is reset at the
    next ``alloc``).  The batched ingest and retire paths then run ONE
    vectorized numpy operation over a whole delivery round or dispatch
    batch where the object estate ran thousands of Python statements.

  ``_ArenaAssembler`` / ``_SlotSmoother`` — the per-session façades.
    They subclass the SHARED ``_WindowAssembler`` / ``_Smoother``
    (har_tpu_torch.serving — the same classes a standalone
    ``StreamingClassifier`` runs), redirecting storage into the arena
    through properties: the sequential code paths (odd chunk sizes,
    journal replay, snapshot/export/adopt) execute the parent classes'
    logic VERBATIM over arena-backed state, which is the bit-identity
    argument — there is no second implementation of window assembly or
    smoothing to drift.  The batched kernels below are the only new
    math, and each one is elementwise-identical to the sequential
    recurrence it replaces (EMA: the same ``a*p + (1-a)*e`` per
    element; vote: the same integer counts and the same
    newest-first tie-break; test-pinned at N=64 against independent
    classifiers across smoothing modes, chunkings, churn and ring
    depths 1–4).

  ``PendingArena`` — the queued-window estate in the same SoA form
    (once a Python object per window).  One completed,
    not-yet-scored window is a SLOT into parallel arrays — owning
    session's arena slot, ``t_index``, staging slot, enqueue clock,
    drift flag, ``dropped``/``launched`` bitmasks, a ``next_idx``
    link — plus the global FIFO as an index RING over those slots.
    Each session's pending view is the ``next_idx`` linked list hung
    off the session arena's ``pend_head``/``pend_tail`` columns, so
    enqueue, due-selection, batch assembly, shed-stalest walks,
    ``remove_session`` drop-flagging and retire unlinking are all
    array operations with zero per-window Python object allocation
    (test-pinned by an object-census test).  A slot is recycled when
    its two references — the ring-or-ticket one and the session-list
    one — are both released (``refs`` starts at 2; flagging a drop
    releases neither: flagged entries keep their queue position for
    the FIFO unlink, exactly like the per-object queue did).

What stays per-object, deliberately: drift monitors (their state is
per-session objects; their EWMA update is batched via
``DriftMonitor.update_many`` instead), the emitted ``StreamEvent``s
(they ARE the API), and the ``_FleetSession`` handle itself (a
slot-carrying façade whose counter attributes read through to the
arena).  Snapshots serialize slots BACK to the per-session layout
(``ring{i}`` / ``ema{i}`` arrays, per-session metadata dicts) and the
pending queue back to the stacked ``pending`` array in global FIFO
order, so the on-disk journal format is unchanged and pre-SoA
snapshots restore cleanly — test-pinned.

Port of ``har_tpu/serve/arena.py`` (numpy, copied) over the port's
``serving._WindowAssembler`` and ``serving._Smoother``.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from har_tpu_torch.serving import _Smoother, _WindowAssembler


class SessionArena:
    """Contiguous SoA storage for every per-session scalar and array.

    Grows geometrically (amortized — steady-state serving never
    reallocates).  Growth reallocates the blocks, which orphans any
    ring VIEW handed to an assembler — the engine re-points live
    assemblers when ``grows`` advances (``FleetServer._new_session``).
    """

    def __init__(
        self,
        window: int,
        channels: int,
        vote_depth: int = 5,
        capacity: int = 64,
    ):
        self.window = int(window)
        self.channels = int(channels)
        self.vote_depth = max(int(vote_depth), 1)
        capacity = max(int(capacity), 8)
        self.rings = np.zeros(
            (capacity, self.window, self.channels), np.float32
        )
        # ring heads/fills: samples absorbed, next emission boundary
        self.n_seen = np.zeros(capacity, np.int64)
        self.next_emit = np.zeros(capacity, np.int64)
        # per-session accounting (the _FleetSession façade reads these)
        self.raw_seen = np.zeros(capacity, np.int64)
        self.n_enqueued = np.zeros(capacity, np.int64)
        self.n_scored = np.zeros(capacity, np.int64)
        self.n_dropped = np.zeros(capacity, np.int64)
        self.n_live = np.zeros(capacity, np.int64)
        self.handoffs = np.zeros(capacity, np.int64)
        # vote smoother: integer ring of the last vote_depth raw labels
        self.votes = np.zeros((capacity, self.vote_depth), np.int64)
        self.vote_len = np.zeros(capacity, np.int64)
        self.vote_head = np.zeros(capacity, np.int64)
        # EMA smoother: allocated at the first EMA step (the class
        # count comes from the first scored probabilities); ema_set
        # marks slots whose row holds real state, ema_local marks
        # slots that fell back to façade-local storage (a width
        # mismatch after a swap to a model with a different C)
        self.ema: np.ndarray | None = None
        self.ema_set = np.zeros(capacity, bool)
        self.ema_local = np.zeros(capacity, bool)
        # per-session pending view (PendingArena): head/tail indices of
        # the session's next_idx linked list through the pending slots
        # (-1 = empty) — derived queue state, rebuilt by replay like
        # the queue itself, never serialized per session
        self.pend_head = np.full(capacity, -1, np.int64)
        self.pend_tail = np.full(capacity, -1, np.int64)
        self._free = list(range(capacity - 1, -1, -1))
        self.grows = 0

    # every per-slot block the arena owns — THE table state()/
    # load_state/_grow/alloc all read, so a field added to __init__
    # without joining it trips harlint HL002's state-completeness rule
    # (acceptance mutation pinned in tests/test_harlint.py; the slot
    # CONTENT itself is serialized per session by the engine snapshot,
    # which is what keeps the on-disk format pre-SoA-compatible)
    _SLOT_ARRAYS = (
        "rings", "n_seen", "next_emit", "raw_seen", "n_enqueued",
        "n_scored", "n_dropped", "n_live", "handoffs", "votes",
        "vote_len", "vote_head", "ema_set", "ema_local",
        "pend_head", "pend_tail",
    )

    @property
    def capacity(self) -> int:
        return len(self.rings)

    @property
    def in_use(self) -> int:
        return len(self.rings) - len(self._free)

    def _grow(self) -> None:
        cap = self.capacity
        new_cap = cap * 2
        for name in self._SLOT_ARRAYS:
            old = getattr(self, name)
            buf = np.zeros((new_cap,) + old.shape[1:], old.dtype)
            buf[:cap] = old
            setattr(self, name, buf)
        if self.ema is not None:
            buf = np.zeros((new_cap, self.ema.shape[1]), np.float64)
            buf[:cap] = self.ema
            self.ema = buf
        self._free.extend(range(new_cap - 1, cap - 1, -1))
        self.grows += 1

    def alloc(self) -> int:
        """Claim a slot with freshly reset state (recycled slots are
        scrubbed HERE, so ``release`` stays O(1) on the eviction path)."""
        if not self._free:
            self._grow()
        slot = self._free.pop()
        self.rings[slot].fill(0.0)
        self.n_seen[slot] = 0
        self.next_emit[slot] = self.window
        for name in (
            "raw_seen", "n_enqueued", "n_scored", "n_dropped", "n_live",
            "handoffs", "vote_len", "vote_head",
        ):
            getattr(self, name)[slot] = 0
        self.ema_set[slot] = False
        self.ema_local[slot] = False
        # fresh pending view: empty linked list (growth zero-fills the
        # slot arrays, and 0 is a VALID pending index — the scrub here
        # is what makes -1 the reliable empty sentinel)
        self.pend_head[slot] = -1
        self.pend_tail[slot] = -1
        return slot

    def release(self, slot: int) -> None:
        self._free.append(slot)

    # ------------------------------------------------- smoother blocks

    def ema_rows(self, width: int) -> np.ndarray | None:
        """The EMA block at the given class width — allocated on first
        use; None when an existing block has a DIFFERENT width (a swap
        to a model with another class count: those sessions fall back
        to façade-local state, flagged in ``ema_local``)."""
        if self.ema is None:
            self.ema = np.zeros((self.capacity, int(width)), np.float64)
        return self.ema if self.ema.shape[1] == int(width) else None

    def ema_block_for(self, alpha: float):
        """The batched EMA recurrence, bound to the engine's alpha:
        ``kernel(slots, probs)`` runs ``e' = a*p + (1-a)*e`` per
        element for initialized rows and ``e' = p`` for first-step
        rows over a block of DISTINCT slots — exactly the sequential
        ``_Smoother`` recurrence, one vectorized operation per case
        (elementwise, so bit-identical to per-session steps).  Returns
        the updated ``(m, C)`` block (a fresh gather), or None when
        the block cannot run vectorized (width mismatch /
        local-fallback rows) — the caller then steps the façades
        sequentially."""
        a = float(alpha)

        def kernel(slots: np.ndarray, probs: np.ndarray):
            if self.ema_local[slots].any():
                return None
            block = self.ema_rows(probs.shape[1])
            if block is None:
                return None
            initialized = self.ema_set[slots]
            if initialized.all():
                block[slots] = a * probs + (1.0 - a) * block[slots]
            else:
                fresh = slots[~initialized]
                block[fresh] = probs[~initialized]
                old = slots[initialized]
                if len(old):
                    block[old] = (
                        a * probs[initialized]
                        + (1.0 - a) * block[old]
                    )
                self.ema_set[slots] = True
            return block[slots]

        return kernel

    def vote_block(
        self, slots: np.ndarray, raws: np.ndarray, n_classes: int
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Batched majority-vote step for a block of DISTINCT slots:
        push each row's raw label into its integer vote ring, rebuild
        the counts, and decide with the same newest-first tie-break the
        sequential ``_Smoother`` uses.  Returns ``(labels, smoothed)``
        where ``smoothed`` is the trailing vote distribution per row —
        integer counts divided in float64, exactly the scalar math —
        or None when a stale vote exceeds the class width (a swap to a
        narrower model: the scalar path widens per session; those
        blocks fall back to façade steps)."""
        depth = self.vote_depth
        v, hd, ln = self.votes, self.vote_head[slots], self.vote_len[slots]
        # stale-wide check BEFORE any mutation: a vote from before a
        # swap to a narrower model needs the scalar path's per-session
        # count widening — returning None must leave the rings
        # untouched so the façade fallback is the FIRST push
        m = len(slots)
        ages = np.arange(depth)
        old_valid = ages[None, :] < ln[:, None]
        widest = int(raws.max()) if m else -1
        if old_valid.any():
            widest = max(widest, int(v[slots][old_valid].max()))
        if widest >= int(n_classes):
            return None  # stale wider vote: per-session widening path
        v[slots, hd] = raws
        hd2 = (hd + 1) % depth
        ln2 = np.minimum(ln + 1, depth)
        self.vote_head[slots] = hd2
        self.vote_len[slots] = ln2
        rows = v[slots]  # (m, depth) gather
        valid = ages[None, :] < ln2[:, None]  # (m, depth)
        # newest-first positions in the ring: age 0 = the vote just
        # pushed, age ln2-1 = the oldest surviving one
        pos = (hd2[:, None] - 1 - ages[None, :]) % depth  # (m, depth)
        votes_by_age = np.take_along_axis(rows, pos, axis=1)
        counts = np.zeros((m, int(n_classes)), np.int64)
        ridx = np.arange(m)
        for age in range(depth):
            live = valid[:, age]
            if not live.any():
                break
            np.add.at(counts, (ridx[live], votes_by_age[live, age]), 1)
        best = counts.max(axis=1)
        labels = np.full(m, -1, np.int64)
        for age in range(depth):
            undecided = labels < 0
            if not undecided.any():
                break
            cand = votes_by_age[:, age]
            pick = (
                undecided
                & valid[:, age]
                & (counts[ridx, cand] == best)
            )
            labels[pick] = cand[pick]
        smoothed = counts.astype(np.float64) / ln2[:, None]
        return labels, smoothed

    # ------------------------------------------------- observability

    @property
    def nbytes(self) -> int:
        """Resident bytes of every slot block (EMA included) — the
        ``arena_bytes`` footprint gauge's source (the 20k-session point
        of the scaling curve is partially memory-bound; this is the
        visibility the ROADMAP asked for)."""
        total = sum(
            int(getattr(self, name).nbytes) for name in self._SLOT_ARRAYS
        )
        if self.ema is not None:
            total += int(self.ema.nbytes)
        return total

    def state(self) -> dict:
        """Snapshot-provider payload: geometry + sizing observability,
        with one entry PER SLOT ARRAY (``_SLOT_ARRAYS``) — the
        per-session CONTENT itself is serialized back to the journal's
        per-session layout (``ring{i}``/``ema{i}`` arrays + metadata
        dicts) by the engine's snapshot builder, so the on-disk format
        is unchanged and pre-SoA snapshots restore cleanly.  Deleting a
        slot-array key from this serializer (the ``_SLOT_ARRAYS``
        table) fails the harlint HL002 gate — acceptance mutation
        pinned in tests/test_harlint.py."""
        return {
            "window": self.window,
            "channels": self.channels,
            "vote_depth": self.vote_depth,
            "capacity": self.capacity,
            "in_use": self.in_use,
            "grows": self.grows,
            "ema_width": (
                None if self.ema is None else int(self.ema.shape[1])
            ),
            "arrays": {
                name: int(getattr(self, name).nbytes)
                for name in self._SLOT_ARRAYS
            },
        }

    def load_state(self, state: dict) -> None:
        """Restore the geometry/observability gauges.  The slot arrays
        named in ``_SLOT_ARRAYS`` re-fill through the engine's
        per-session restore path (add_session + push/ack replay), and
        the EMA block re-derives its width at the first scored batch —
        what survives HERE is the construction geometry and the
        cumulative ``grows`` counter; ``capacity``/``in_use`` are live
        allocation properties recomputed by the restored engine's own
        admissions."""
        self.window = int(state.get("window", self.window))
        self.channels = int(state.get("channels", self.channels))
        self.vote_depth = int(state.get("vote_depth", self.vote_depth))
        self.grows = int(state.get("grows", 0))
        if state.get("ema_width") is None:
            self.ema = None
        unknown = [
            name
            for name in (state.get("arrays") or {})
            if name not in self._SLOT_ARRAYS
        ]
        if unknown:
            import warnings

            warnings.warn(
                "SessionArena.load_state: unknown slot arrays "
                f"{sorted(unknown)} — written by a newer version?",
                RuntimeWarning,
                stacklevel=2,
            )


class _ArenaAssembler(_WindowAssembler):
    """``_WindowAssembler`` whose ring and head/fill scalars live in a
    ``SessionArena`` slot.  ``consume`` (and every other parent method)
    runs VERBATIM: the ring is an arena row view, and the ``_n_seen`` /
    ``_next_emit`` scalars read/write the arena's int arrays through
    the properties below — so the sequential ingest path is the exact
    shared-code path, and only the engine's batched ``push_many`` fast
    path touches the arrays wholesale."""

    __slots__ = ("_arena", "_slot")

    def __init__(self, arena: SessionArena, slot: int, window, hop,
                 channels, monitor=None):
        self._arena = arena
        self._slot = slot
        super().__init__(
            window, hop, channels, monitor=monitor,
            ring=arena.rings[slot],
        )

    @property
    def _n_seen(self):
        return int(self._arena.n_seen[self._slot])

    @_n_seen.setter
    def _n_seen(self, value):
        self._arena.n_seen[self._slot] = value

    @property
    def _next_emit(self):
        return int(self._arena.next_emit[self._slot])

    @_next_emit.setter
    def _next_emit(self, value):
        self._arena.next_emit[self._slot] = value


class _SlotSmoother(_Smoother):
    """``_Smoother`` whose EMA/vote state lives in a ``SessionArena``
    slot.  The EMA recurrence is the parent's own ``_step_raw`` running
    through the ``_ema`` property (read: arena row or None; write:
    in-place row assignment — same float64 values).  The vote step
    round-trips the arena's integer ring through the parent's deque
    logic, so the decision code has exactly one implementation.  A
    width-mismatched EMA (model swap to a different class count) falls
    back to façade-local storage, flagged so the batched kernel skips
    those slots."""

    __slots__ = ("_arena", "_slot", "_ema_store")

    def __init__(self, arena: SessionArena, slot: int, smoothing,
                 ema_alpha, vote_depth):
        self._arena = arena
        self._slot = slot
        self._ema_store = None
        super().__init__(smoothing, ema_alpha, vote_depth)

    # ------------------------------------------------------ EMA state

    @property
    def _ema(self):
        if self._ema_store is not None:
            return self._ema_store
        a, s = self._arena, self._slot
        if a.ema is None or not a.ema_set[s]:
            return None
        return a.ema[s]

    @_ema.setter
    def _ema(self, value):
        a, s = self._arena, self._slot
        if value is None:
            self._ema_store = None
            a.ema_set[s] = False
            a.ema_local[s] = False
            return
        value = np.asarray(value, np.float64)
        rows = a.ema_rows(value.shape[0])
        if rows is None:
            # width mismatch with the allocated block: per-session
            # fallback (counted so the batched kernel skips the slot)
            self._ema_store = value
            a.ema_local[s] = True
            return
        rows[s] = value
        a.ema_set[s] = True
        a.ema_local[s] = False
        self._ema_store = None

    # ----------------------------------------------------- vote state

    @property
    def _votes(self):
        a, s = self._arena, self._slot
        depth = a.vote_depth
        ln = int(a.vote_len[s])
        hd = int(a.vote_head[s])
        d: deque[int] = deque(maxlen=depth)
        for i in range(ln):  # oldest → newest
            d.append(int(a.votes[s, (hd - ln + i) % depth]))
        return d

    @_votes.setter
    def _votes(self, value):
        a, s = self._arena, self._slot
        depth = a.vote_depth
        vals = [int(v) for v in value][-depth:]
        a.votes[s, : len(vals)] = vals
        a.vote_len[s] = len(vals)
        a.vote_head[s] = len(vals) % depth

    def _step_raw(self, raw_label, probs):
        if self.smoothing == "vote":
            # round-trip the arena ring through the PARENT's deque
            # logic: one decision implementation, arena-backed storage
            tmp = _Smoother(
                "vote", self.ema_alpha, self._arena.vote_depth
            )
            tmp._votes = self._votes
            out = _Smoother._step_raw(tmp, raw_label, probs)
            self._votes = tmp._votes
            return out
        out = super()._step_raw(raw_label, probs)
        if self.smoothing == "ema" and self._ema_store is None:
            # the parent returned the arena ROW (a live view): snapshot
            # it — the plain _Smoother allocates a fresh array per
            # step, so two windows of one session in one batch must
            # see two distinct EMA states, not the final one twice
            return (out[0], out[1], out[2].copy())
        return out


class PendingArena:
    """Slot-indexed SoA storage for the pending (queued-window) estate.

    One completed, not-yet-scored window is an index into parallel
    arrays; the global FIFO is an index RING over those slots.  A slot
    carries exactly what the per-object ``_Pending`` carried — owning
    session's arena slot, ``t_index``, staging slot, enqueue clock,
    drift flag, ``dropped``/``launched`` marks — plus the ``next_idx``
    link that threads each session's pending view (heads/tails live in
    the session arena's ``pend_head``/``pend_tail`` columns, engine-
    managed).

    Slot lifetime is reference-counted with exactly TWO references:
    the queue-side one (the FIFO ring until launch, then the dispatch
    ticket until retire — launch TRANSFERS it, so the count never
    moves on the hot path) and the session-list one (released at the
    retire unlink / lazy dropped-prefix discard / ``remove_session``
    clear).  Flagging a window ``dropped`` releases neither reference:
    flagged entries keep their position in both views, exactly the
    per-object queue's contract, and the slot recycles when the second
    reference goes (``release`` pushes it back on the free stack).

    Growth is geometric and amortized; steady-state serving allocates
    nothing per window — enqueue/pop/flag/release are all array writes
    (the zero-allocation contract is pinned by an object-census test).
    """

    def __init__(self, capacity: int = 256):
        capacity = max(int(capacity), 32)
        # per-slot columns — everything the per-object _Pending carried
        self.sess_slot = np.full(capacity, -1, np.int64)
        self.t_index = np.zeros(capacity, np.int64)
        self.stage_slot = np.zeros(capacity, np.int64)
        self.t_enqueue = np.zeros(capacity, np.float64)
        self.drift = np.zeros(capacity, bool)
        self.dropped = np.zeros(capacity, bool)
        self.launched = np.zeros(capacity, bool)
        self.next_idx = np.full(capacity, -1, np.int64)
        self.refs = np.zeros(capacity, np.uint8)
        self.grows = 0
        # free slots as an int stack (array + count): block allocation
        # is one slice, never a per-slot Python pop
        self._free = np.arange(capacity - 1, -1, -1, dtype=np.int64)
        self._n_free = capacity
        # the global FIFO: a power-of-two circular index ring with
        # monotonic head/tail counters.  Ring size is bounded by the
        # slot capacity (a ring entry holds a slot reference), so the
        # ring grows in step with the slot arrays.
        self._ring = np.empty(_pow2(capacity), np.int64)
        self._rhead = 0
        self._rtail = 0

    # every per-slot column the arena owns — THE table state()/
    # load_state read, so a field added to __init__ without joining it
    # trips harlint HL002's state-completeness rule (acceptance
    # mutation pinned in tests/test_harlint.py; the slot CONTENT
    # itself is serialized back to the snapshot's stacked ``pending``
    # array in global FIFO order by the engine, which is what keeps
    # the on-disk format pre-SoA-compatible)
    _PENDING_ARRAYS = (
        "sess_slot", "t_index", "stage_slot", "t_enqueue", "drift",
        "dropped", "launched", "next_idx", "refs",
    )

    @property
    def capacity(self) -> int:
        return len(self.sess_slot)

    @property
    def in_use(self) -> int:
        return len(self.sess_slot) - self._n_free

    @property
    def queued(self) -> int:
        """Entries currently in the FIFO ring (dropped-but-unpopped
        included) — the due-selection view's raw size."""
        return self._rtail - self._rhead

    @property
    def nbytes(self) -> int:
        """Resident bytes of the pending estate (ring + free stack
        included) — the ``pending_bytes`` footprint gauge's source."""
        return (
            sum(
                int(getattr(self, name).nbytes)
                for name in self._PENDING_ARRAYS
            )
            + int(self._ring.nbytes)
            + int(self._free.nbytes)
        )

    # ---------------------------------------------------- slot estate

    def _grow(self, need: int = 0) -> None:
        cap = self.capacity
        new_cap = cap * 2
        while new_cap < need:
            new_cap *= 2
        for name in self._PENDING_ARRAYS:
            old = getattr(self, name)
            buf = np.zeros(new_cap, old.dtype)
            buf[:cap] = old
            setattr(self, name, buf)
        free = np.empty(new_cap, np.int64)
        free[: self._n_free] = self._free[: self._n_free]
        free[self._n_free: self._n_free + new_cap - cap] = np.arange(
            new_cap - 1, cap - 1, -1
        )
        self._free = free
        self._n_free += new_cap - cap
        self.grows += 1

    def alloc_block(self, m: int) -> np.ndarray:
        """Claim ``m`` fresh slots (flags reset, both references held);
        FIFO position is the caller's job (``ring_extend``)."""
        if self._n_free < m:
            self._grow(self.in_use + m)
        idx = self._free[self._n_free - m: self._n_free].copy()
        self._n_free -= m
        self.dropped[idx] = False
        self.launched[idx] = False
        self.next_idx[idx] = -1
        self.refs[idx] = 2
        return idx

    def add_block(
        self, sess_slots, t_indices, stage_slots, drifts, now: float
    ) -> np.ndarray:
        """Enqueue a block of windows in one shot: claim slots, fill
        every column, append to the FIFO ring in block order.  The
        batched ingest's whole-round enqueue — a handful of array
        writes where the per-object queue ran five Python statements
        per window."""
        idx = self.alloc_block(len(sess_slots))
        self.sess_slot[idx] = sess_slots
        self.t_index[idx] = t_indices
        self.stage_slot[idx] = stage_slots
        self.drift[idx] = drifts
        self.t_enqueue[idx] = now
        self.ring_extend(idx)
        return idx

    def add(
        self, sess_slot: int, t_index: int, stage_slot, drift: bool,
        now: float,
    ) -> int:
        """Scalar enqueue (the sequential ``push`` / replay path)."""
        if not self._n_free:
            self._grow()
        self._n_free -= 1
        i = self._free[self._n_free]
        self.sess_slot[i] = sess_slot
        self.t_index[i] = t_index
        self.stage_slot[i] = stage_slot
        self.t_enqueue[i] = now
        self.drift[i] = drift
        self.dropped[i] = False
        self.launched[i] = False
        self.next_idx[i] = -1
        self.refs[i] = 2
        self._ring_append(i)
        return int(i)

    def release(self, i: int) -> None:
        """Drop one reference; recycle the slot when both are gone."""
        self.refs[i] -= 1
        if not self.refs[i]:
            if self._n_free >= len(self._free):  # pragma: no cover
                raise AssertionError("pending free-stack overflow")
            self._free[self._n_free] = i
            self._n_free += 1

    def release_block(self, idx: np.ndarray) -> None:
        """Vectorized reference drop (the end-of-retire ticket
        release): one subtract, one mask, one slice write."""
        if not len(idx):
            return
        self.refs[idx] -= 1
        done = idx[self.refs[idx] == 0]
        m = len(done)
        if m:
            self._free[self._n_free: self._n_free + m] = done
            self._n_free += m

    # ------------------------------------------------ the FIFO ring

    def _ring_grow(self) -> None:
        cap = len(self._ring)
        size = self._rtail - self._rhead
        buf = np.empty(cap * 2, np.int64)
        h = self._rhead & (cap - 1)
        first = min(cap - h, size)
        buf[:first] = self._ring[h: h + first]
        buf[first:size] = self._ring[: size - first]
        self._ring = buf
        self._rhead = 0
        self._rtail = size

    def _ring_append(self, i: int) -> None:
        if self._rtail - self._rhead >= len(self._ring):
            self._ring_grow()
        self._ring[self._rtail & (len(self._ring) - 1)] = i
        self._rtail += 1

    def ring_extend(self, idx: np.ndarray) -> None:
        m = len(idx)
        while self._rtail - self._rhead + m > len(self._ring):
            self._ring_grow()
        cap = len(self._ring)
        t = self._rtail & (cap - 1)
        first = min(cap - t, m)
        self._ring[t: t + first] = idx[:first]
        if first < m:
            self._ring[: m - first] = idx[first:]
        self._rtail += m

    def ring_indices(self) -> np.ndarray:
        """The FIFO ring's contents in queue order (dropped-but-
        unpopped entries included) — the snapshot serializer's and the
        shed-stalest walk's view.  A fresh array, never a live view."""
        cap = len(self._ring)
        size = self._rtail - self._rhead
        h = self._rhead & (cap - 1)
        first = min(cap - h, size)
        out = np.empty(size, np.int64)
        out[:first] = self._ring[h: h + first]
        out[first:] = self._ring[: size - first]
        return out

    def pop_batch(self, target: int) -> np.ndarray:
        """Pop up to ``target`` LIVE entries off the FIFO head in one
        vectorized sweep per contiguous ring segment, marking them
        launched; dropped entries encountered on the way are popped
        and their queue-side reference released (their session-list
        reference — and their flagged position there — is untouched,
        exactly like the per-object pop-and-skip).  Returns the
        launched indices in FIFO order."""
        taken: list[np.ndarray] = []
        got = 0
        cap = len(self._ring)
        while got < target and self._rtail > self._rhead:
            h = self._rhead & (cap - 1)
            seg = min(
                cap - h, self._rtail - self._rhead, target - got
            )
            chunk = self._ring[h: h + seg].copy()
            mask = self.dropped[chunk]
            if mask.any():
                dead = chunk[mask]
                self.release_block(dead)
                chunk = chunk[~mask]
            self._rhead += seg
            if len(chunk):
                self.launched[chunk] = True
                taken.append(chunk)
                got += len(chunk)
        if not taken:
            return _EMPTY_IDX
        return taken[0] if len(taken) == 1 else np.concatenate(taken)

    def head_live(self, n: int) -> np.ndarray:
        """The first ``n`` LIVE indices from the FIFO head, in queue
        order, WITHOUT popping anything — the shed-stalest walk's
        view.  Stops as soon as ``n`` are found (one vectorized mask
        per ring segment), so shedding one window off a deep queue is
        O(shed + dropped prefix), not O(queue)."""
        found: list[np.ndarray] = []
        got = 0
        cap = len(self._ring)
        pos = self._rhead
        while got < n and pos < self._rtail:
            h = pos & (cap - 1)
            seg = min(cap - h, self._rtail - pos)
            chunk = self._ring[h: h + seg]
            live = chunk[~self.dropped[chunk]]
            if len(live):
                found.append(live[: n - got])
                got += len(found[-1])
            pos += seg
        if not found:
            return _EMPTY_IDX
        return found[0] if len(found) == 1 else np.concatenate(found)

    def oldest_live_enqueue(self) -> float | None:
        """Enqueue clock of the FIFO head's oldest live entry (the
        micro-batcher's deadline input), popping-and-releasing dropped
        heads on the way — the per-object ``_oldest_live`` as array
        ops."""
        cap = len(self._ring)
        while self._rtail > self._rhead:
            h = self._rhead & (cap - 1)
            seg = min(cap - h, self._rtail - self._rhead)
            chunk = self._ring[h: h + seg]
            live = np.flatnonzero(~self.dropped[chunk])
            if len(live):
                n_dead = int(live[0])
                if n_dead:
                    self.release_block(chunk[:n_dead].copy())
                    self._rhead += n_dead
                return float(self.t_enqueue[chunk[n_dead]])
            self.release_block(chunk.copy())
            self._rhead += seg
        return None

    # ------------------------------------------------- observability

    def state(self) -> dict:
        """Snapshot-provider payload: sizing observability only, one
        entry PER PENDING ARRAY (``_PENDING_ARRAYS``) — the queued
        windows themselves serialize back to the snapshot's stacked
        ``pending`` array in global FIFO order (engine snapshot
        builder), so the on-disk format is unchanged and pre-SoA
        snapshots restore cleanly.  Deleting a column key from this
        serializer (the ``_PENDING_ARRAYS`` table) fails the harlint
        HL002 gate — acceptance mutation pinned in
        tests/test_harlint.py."""
        return {
            "capacity": self.capacity,
            "in_use": self.in_use,
            "queued": self.queued,
            "grows": self.grows,
            "nbytes": self.nbytes,
            "arrays": {
                name: int(getattr(self, name).nbytes)
                for name in self._PENDING_ARRAYS
            },
        }

    def load_state(self, state: dict) -> None:
        """Restore the observability gauges.  The columns named in
        ``_PENDING_ARRAYS`` re-fill through the engine's pending-queue
        restore path (snapshot ``pending`` rows + push/ack replay);
        what survives HERE is the cumulative ``grows`` counter —
        ``capacity``/``in_use``/``queued`` are live allocation
        properties recomputed by the restored queue itself."""
        self.grows = int(state.get("grows", 0))
        unknown = [
            name
            for name in (state.get("arrays") or {})
            if name not in self._PENDING_ARRAYS
        ]
        if unknown:
            import warnings

            warnings.warn(
                "PendingArena.load_state: unknown pending arrays "
                f"{sorted(unknown)} — written by a newer version?",
                RuntimeWarning,
                stacklevel=2,
            )


def _pow2(n: int) -> int:
    return 1 << (max(int(n), 2) - 1).bit_length()


_EMPTY_IDX = np.empty(0, np.int64)
