"""The cluster control plane: N FleetServer workers behind one router,
with heartbeat failover and journal hand-off session migration.

``FleetServer`` is structurally one process — one crash takes the whole
fleet down, and its journal can only recover it IN PLACE.  This
module partitions sessions across N worker processes (each an
unmodified ``FleetServer`` + journal directory) behind a consistent-
hash router, and turns the journal's recovery machinery into LIVE
MIGRATION:

  placement   a consistent-hash ring (``router.py``) decides where a
              session is admitted and where a dead worker's sessions
              fail over to; the controller keeps the authoritative
              ``session → worker`` map on top (a migrated session stays
              pinned to its adopter even where the ring disagrees);

  detection   a heartbeat/lease protocol (``membership.py``): poll
              success renews a worker's lease; a worker that stops
              answering is probed at a capped-exponential-backoff
              cadence (``har_tpu_torch.utils.backoff`` — the same policy the
              dispatch retry loop uses) and declared dead only after
              lease expiry AND the probe budget — no wall clocks, the
              injected clock drives everything (FakeClock in tests);

  failover    live session migration via journal hand-off: restore the
              dead worker's partition from its journal+snapshot (the
              ``FleetServer.restore`` path), DRAIN it (score the
              recovered pending windows — acks land in the dead
              worker's journal, so a crash mid-failover re-drains
              idempotently, zero double-scored), then hand each session
              to its surviving ring owner: the target journals an
              ``adopt`` record with the full exported state BEFORE the
              source journals its ``handoff`` eviction, so a crash
              anywhere in the protocol leaves the session on >= 1
              journal and dual ownership resolves by the ``handoffs``
              generation.  The transport resumes delivery at
              ``watermark(sid)`` — migrated event streams are
              bit-identical to an unmigrated run (chaos-pinned);

  accounting  the conservation law extends CROSS-WORKER: summed over
              live workers plus the retired-worker ledger (each dead
              worker's final post-drain accounting, persisted in its
              ``retired.json`` marker), ``enqueued == scored + dropped
              + pending + lost_in_crash`` holds globally through any
              failover — ``accounting()`` is that sum, computed with
              the DrJAX-style ``map_fn``/``reduce_sum`` primitives;

  adaptation  drift evidence aggregates the same way: ``observe_drift``
              feeds every partition's reports into ONE RetrainTrigger,
              so K sessions drifting on a common channel escalate no
              matter how the router spread them across workers.

The control plane is asynchronous and bounded-retry by design (the
Spark-ML perf study, arXiv 1612.01437: coordination overhead, not
compute, dominates distributed ML): heartbeats ride the poll the
caller already makes, probes are backoff-paced, hand-offs retry a
bounded number of times — and none of it ever blocks a healthy
worker's dispatch hot path.

Port of ``har_tpu/serve/cluster/controller.py`` (copied): the
shared-disk failover, the fetch queue that parks a failover whose
partition cannot be fetched yet (``PartitionUnavailable``), and the
warm standbys (``register_standby``, ``har_tpu_torch.serve.replica``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Hashable

from har_tpu_torch.serve.cluster.membership import (
    LeaseConfig,
    Membership,
    WorkerTimeout,
    WorkerUnavailable,
)
from har_tpu_torch.serve.cluster.primitives import map_fn, reduce_sum
from har_tpu_torch.serve.cluster.router import ConsistentHashRouter
from har_tpu_torch.serve.cluster.worker import ClusterWorker
from har_tpu_torch.serve.engine import AdmissionError, FleetServer
from har_tpu_torch.serve.journal import JournalConfig, JournalError
from har_tpu_torch.utils.backoff import Backoff, BackoffPolicy, retry_call
from har_tpu_torch.utils.durable import atomic_write

RETIRED_MARKER = "retired.json"


class ClusterError(RuntimeError):
    """Cluster-level invariant violated (no live target for a hand-off,
    unknown session, duplicate worker id)."""


class PartitionUnavailable(ClusterError):
    """A dead worker's journal could not be FETCHED right now (the
    shared-nothing deployment's ship agent is unreachable,
    har_tpu_torch.serve.net.ship).  Not a failure: the failover PARKS on the
    fetch queue and retries at a later poll — survivors keep serving,
    the dead partition's disk state is untouched, and nothing is lost,
    only delayed."""


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Control-plane knobs: ring shape, failure detection, hand-off
    retry budget."""

    # virtual nodes per worker on the consistent-hash ring
    replicas: int = 64
    # heartbeat/lease failure detection (membership.py)
    lease_s: float = 2.0
    probe_retries: int = 3
    probe_base_ms: float = 50.0
    probe_cap_ms: float = 1000.0
    # transparent re-attempts of one session hand-off before trying the
    # next live worker (bounded: a hand-off must never spin)
    handoff_retries: int = 2
    seed: int = 0

    def lease_config(self) -> LeaseConfig:
        return LeaseConfig(
            lease_s=self.lease_s,
            probe_retries=self.probe_retries,
            probe_base_ms=self.probe_base_ms,
            probe_cap_ms=self.probe_cap_ms,
            seed=self.seed,
        )


class FleetCluster:
    """N journaled FleetServers behind a consistent-hash router.

    Duck-types the slice of ``FleetServer`` the load plane speaks
    (``push`` / ``poll`` / ``flush`` / ``watermark`` / ``hop``), so
    ``drive_fleet`` and the CLI drive a cluster exactly like a single
    server — the partitioning is invisible to the transport except
    when a hand-off moves a session's watermark.

    ``model`` serves every worker; ``loader`` (``version -> model``)
    resolves checkpoints during failover restores and defaults to
    serving ``model`` for every version.  ``fault_hook_for(worker_id)``
    builds per-worker dispatch fault hooks (chaos harness).
    """

    def __init__(
        self,
        model,
        root: str,
        *,
        workers: int = 3,
        window: int = 200,
        hop: int = 20,
        channels: int = 3,
        smoothing: str = "ema",
        fleet_config=None,
        journal_config: JournalConfig | None = None,
        config: ClusterConfig | None = None,
        clock: Callable[[], float] | None = None,
        loader: Callable | None = None,
        fault_hook_for: Callable | None = None,
        class_names=None,
        _workers: list | None = None,
        _ledger: list | None = None,
    ):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.config = config or ClusterConfig()
        self._clock = clock
        self._model = model
        self._loader = loader or (lambda version: model)
        self._fault_hook_for = fault_hook_for
        self._journal_config = journal_config
        self.hop = int(hop)
        self._router = ConsistentHashRouter(self.config.replicas)
        self._membership = Membership(
            self.config.lease_config(), clock=clock
        )
        self._workers: dict = {}
        self._placement: dict = {}  # session -> worker id
        self._ledger: list = list(_ledger or [])
        self.failovers = 0
        # wall time spent inside failover machinery (restore + drain +
        # hand-offs), the control plane's headline latency — bench-lane
        # observable, accumulated with perf_counter duration reads
        self.failover_ms = 0.0
        self.migration_log: list[dict] = []
        self._pending_events: list = []
        # failovers split across two polls: restore+drain returns its
        # events THIS poll; the hand-offs run at the START of the next
        # poll, when no acked events are in flight — so a controller
        # crash at the mid_migration/mid_handoff stage boundaries can
        # never strand an acked-but-undelivered event
        self._handoff_queue: list = []
        # failovers whose partition FETCH failed (shared-nothing ship
        # agent unreachable): (dead_wid, worker) pairs retried at each
        # poll — a dead worker whose host agent is also down parks here
        # while the survivors keep serving
        self._fetch_queue: list = []
        # hand-off retry pacing: the same Backoff policy family as the
        # dispatch retry loop (har_tpu_torch.utils.backoff), seeded — the
        # control plane is deterministic under the chaos harness
        self._handoff_backoff = Backoff(
            BackoffPolicy(
                base_ms=self.config.probe_base_ms,
                cap_ms=self.config.probe_cap_ms,
            ),
            seed=self.config.seed,
        )
        # chaos hook (serve.chaos): raises a simulated crash at the two
        # migration stage boundaries the kill matrix exercises
        self.chaos: Callable[[str], None] | None = None
        # warm standbys (har_tpu_torch.serve.replica.StandbyAgent): cycled at
        # the top of every poll so their tails stay caught up; a
        # failover consults them FIRST — a standby that holds the dead
        # worker's tail finalizes it (verify already-local bytes, pull
        # only the missing suffix) and the cold ship/shared-disk path
        # becomes the fallback.  name -> (standby, prefer_wid)
        self._standbys: dict = {}
        # bytes moved ON the failover path (finalize_tail pulls) — 0
        # for a caught-up tail, vs NetCluster.ship_ms/shipped_bytes
        # which count the steady-state tail + cold ships
        self.failover_path_bytes = 0
        self.standby_fetches = 0
        # dead_wid -> original journal dir for failovers restored from
        # a standby tail: the retired marker lands in the REPLICA dir
        # (the restore source), so commit propagates it back to the
        # original home a takeover/resume scan reads
        self._standby_origin: dict = {}
        if _workers is not None:
            for w in _workers:
                self._adopt_worker(w)
            self._rebuild_placement()
        else:
            os.makedirs(self.root, exist_ok=True)
            for i in range(int(workers)):
                wid = f"w{i}"
                self._adopt_worker(
                    ClusterWorker(
                        wid,
                        FleetServer(
                            model,
                            window=window,
                            hop=hop,
                            channels=channels,
                            smoothing=smoothing,
                            class_names=class_names,
                            config=fleet_config,
                            clock=clock,
                            fault_hook=(
                                fault_hook_for(wid)
                                if fault_hook_for is not None
                                else None
                            ),
                            journal=os.path.join(self.root, wid),
                            journal_config=journal_config,
                        ),
                        os.path.join(self.root, wid),
                    )
                )
        if not self._workers:
            raise ClusterError("a cluster needs at least one worker")

    # ------------------------------------------------------ membership

    def _adopt_worker(self, worker: ClusterWorker) -> None:
        if worker.worker_id in self._workers:
            raise ClusterError(
                f"duplicate worker id {worker.worker_id!r}"
            )
        self._workers[worker.worker_id] = worker
        self._router.add_worker(worker.worker_id)
        self._membership.add(worker.worker_id)

    @property
    def workers(self) -> tuple:
        return tuple(self._workers)

    @property
    def servers(self) -> tuple:
        """The live FleetServers, membership order — what the DrJAX
        primitives and the fleet-global drift trigger map over."""
        return tuple(w.server for w in self._workers.values())

    def worker_of(self, session_id: Hashable):
        wid = self._placement.get(session_id)
        if wid is None:
            raise ClusterError(f"unknown session {session_id!r}")
        return wid

    @property
    def sessions(self) -> tuple:
        return tuple(self._placement)

    def _chaos(self, point: str) -> None:
        if self.chaos is not None:
            self.chaos(point)

    def _note_worker_failure(self, wid, exc: WorkerUnavailable) -> None:
        """Route the two failure species to the detector: a DEADLINE
        (``WorkerTimeout`` — slow link / busy worker) re-paces the
        probe WITHOUT a strike; everything else (connection refused,
        reset — nobody home) counts toward the death verdict."""
        if isinstance(exc, WorkerTimeout):
            self._membership.note_timeout(wid)
        else:
            self._membership.note_failure(wid)

    # ------------------------------------------------------- data plane

    def add_session(self, session_id: Hashable, *, monitor=None) -> None:
        """Admit a session on its ring owner."""
        if session_id in self._placement:
            raise ClusterError(
                f"session {session_id!r} already admitted"
            )
        wid = self._router.owner(session_id)
        self._workers[wid].add_session(session_id, monitor=monitor)
        self._placement[session_id] = wid

    def disconnect_session(self, session_id: Hashable) -> list:
        """Graceful churn disconnect on the session's worker (elastic
        traffic, har_tpu_torch.serve.traffic): the worker flushes the
        assembler's partial window, settles its pending queue (those
        events are returned — the worker's drain is fleet-local), and
        journals the eviction; the placement entry is dropped."""
        wid = self.worker_of(session_id)
        worker = self._workers.get(wid)
        if worker is None:
            raise WorkerUnavailable(
                f"session {session_id!r} is mid-failover"
            )
        try:
            events = worker.disconnect_session(session_id)
        except WorkerUnavailable as exc:
            self._note_worker_failure(wid, exc)
            raise
        self._membership.note_ok(wid)
        del self._placement[session_id]
        return events

    def disconnect_sessions(self, session_ids) -> list:
        """Batched graceful churn disconnect: leavers group by owning
        worker so each worker settles ONCE for its whole departing
        cohort (the storm case) instead of once per session."""
        by_worker: dict = {}
        for sid in session_ids:
            by_worker.setdefault(self.worker_of(sid), []).append(sid)
        events: list = []
        for wid, sids in by_worker.items():
            worker = self._workers.get(wid)
            if worker is None:
                raise WorkerUnavailable(
                    f"sessions {sids!r} are mid-failover"
                )
            try:
                events.extend(worker.disconnect_sessions(sids))
            except WorkerUnavailable as exc:
                self._note_worker_failure(wid, exc)
                raise
            self._membership.note_ok(wid)
            for sid in sids:
                del self._placement[sid]
        return events

    def push(self, session_id: Hashable, samples) -> int:
        """Route one delivery to the session's worker.  Fails FAST on
        an unreachable worker (``WorkerUnavailable``) — the evidence
        feeds the failure detector and the transport re-delivers from
        ``watermark(sid)`` once failover lands; the control plane never
        blocks a push on a sick peer."""
        wid = self.worker_of(session_id)
        worker = self._workers.get(wid)
        if worker is None:
            # mid-failover: the partition is being recovered; the
            # transport re-delivers from watermark(sid) once it lands
            raise WorkerUnavailable(
                f"worker {wid!r} is failing over"
            )
        try:
            n = worker.push(session_id, samples)
        except WorkerUnavailable as exc:
            self._note_worker_failure(wid, exc)
            raise
        self._membership.note_ok(wid)
        return n

    def push_many(self, session_ids, chunks) -> int:
        """Route one delivery ROUND (``FleetServer.push_many``'s
        signature — the load generators already speak it): pairs in
        delivery order, grouped by owning worker so each worker sees
        ONE batched ``push_many`` call (over the wire: one frame)
        instead of one per session.  Per-worker delivery order is the
        argument order, so windows enqueue exactly as the equivalent
        per-session ``push`` sequence would.  Fails fast like ``push``:
        an unreachable worker raises after earlier groups have landed —
        the transport re-delivers the failed partition from
        ``watermark(sid)`` once failover lands."""
        by_worker: dict = {}
        for sid, samples in zip(session_ids, chunks):
            wid = self.worker_of(sid)
            group = by_worker.setdefault(wid, ([], []))
            group[0].append(sid)
            group[1].append(samples)
        total = 0
        for wid, (ids, payloads) in by_worker.items():
            worker = self._workers.get(wid)
            if worker is None:
                raise WorkerUnavailable(
                    f"worker {wid!r} is failing over"
                )
            try:
                total += worker.push_many(ids, payloads)
            except WorkerUnavailable as exc:
                self._note_worker_failure(wid, exc)
                raise
            self._membership.note_ok(wid)
        return total

    def poll(self, *, force: bool = False) -> list:
        """Poll every responsive worker (the poll doubles as its
        heartbeat), run the failure detector, fail over any declared
        death, and return the fleet's events — survivors' dispatches
        are never blocked by a sick peer: suspected workers are skipped
        until their backoff-paced probe comes due.

        Stage order is the crash-safety argument: queued HAND-OFFS
        first (no events in flight yet — the window the chaos matrix's
        ``mid_migration``/``mid_handoff`` kills land in), then death
        declarations (restore + drain, whose events deliver with this
        poll's return), then the worker polls.  On any crash the
        already-collected events are stashed and delivered by the next
        poll — an acked event is returned exactly once."""
        events = self._pending_events
        self._pending_events = []
        try:
            # warm standbys tail first: the cycle that runs in the same
            # poll that declares a death sees the (now static) journal
            # in full, which is what makes the failover-path transfer
            # deterministically zero for a registered standby
            for standby, _prefer in self._standbys.values():
                standby.cycle()
            while self._handoff_queue:
                dead_wid, restored = self._handoff_queue[0]
                self._complete_failover(dead_wid, restored)
                self._handoff_queue.pop(0)
            if self._fetch_queue:
                # parked shared-nothing failovers: retry the partition
                # fetch (the dead host's ship agent may be back); a
                # still-unreachable agent re-parks without blocking the
                # survivors' polls below.  Entries are popped one at a
                # time so a crash mid-retry loses at most the IN-FLIGHT
                # entry (the controller-crash model; takeover re-derives
                # it from the agents) — never the not-yet-retried rest.
                retry, self._fetch_queue = self._fetch_queue, []
                try:
                    while retry:
                        dead_wid, worker = retry.pop(0)
                        events.extend(
                            self._continue_failover(dead_wid, worker)
                        )
                except BaseException:
                    self._fetch_queue.extend(retry)
                    raise
            for wid in self._membership.expired():
                events.extend(self._begin_failover(wid))
            for wid in list(self._workers):
                w = self._workers[wid]
                if not self._membership.probe_due(wid):
                    continue  # suspected: wait out the probe backoff
                if self._membership.suspected(wid):
                    # the due probe of a suspected worker is the cheap
                    # heartbeat RPC (no fleet state touched) — only a
                    # worker that answers it gets a full poll again
                    try:
                        w.heartbeat()
                    except WorkerUnavailable as exc:
                        self._note_worker_failure(wid, exc)
                        continue
                try:
                    evs = w.poll(force=force)
                except WorkerUnavailable as exc:
                    self._note_worker_failure(wid, exc)
                    continue
                self._membership.note_ok(wid)
                events.extend(evs)
        except BaseException:
            # a crash mid-poll (chaos SimulatedCrash from a worker's
            # journal hook or the migration machinery) must not lose
            # already-returned events — stash them; the next poll (or
            # the takeover controller) delivers them first
            self._pending_events = events
            raise
        return events

    def flush(self) -> list:
        return self.poll(force=True)

    def watermark(self, session_id: Hashable) -> int:
        worker = self._workers.get(self.worker_of(session_id))
        if worker is None:
            raise WorkerUnavailable(
                f"session {session_id!r} is mid-failover"
            )
        return worker.watermark(session_id)

    def swap_model(self, model, *, version: str) -> str:
        """Fleet-wide zero-drop hot swap: broadcast the new model to
        every live worker (each applies it at its own dispatch
        boundary, ``FleetServer.swap_model``).  Idempotent per worker — a
        re-issued broadcast after a mid-swap worker loss skips workers
        already serving ``version``, and a worker that dies mid-
        broadcast is failure-detector evidence, not a broadcast
        failure (the re-issued broadcast lands it post-failover)."""
        for wid in list(self._workers):
            w = self._workers[wid]
            if not w.alive:
                continue
            try:
                w.swap_model(model, version=version)
            except WorkerUnavailable as exc:
                self._note_worker_failure(wid, exc)
        return version

    def observe_drift(self, trigger) -> None:
        """Feed every partition's drift reports into one fleet-global
        RetrainTrigger (``RetrainTrigger.observe_workers``): K sessions
        drifting on a common channel escalate across workers."""
        trigger.observe_workers(self.servers)

    # --------------------------------------------------------- failover

    def _begin_failover(self, dead_wid) -> list:
        """Phase 1 of a declared death: fence the worker (refuse any
        late responses — the in-process stand-in for lease-based
        fencing), remove it from the ring, FETCH its partition
        (``_fetch_partition`` — the dead directory itself on a shared
        disk, a digest-verified shipped copy in the shared-nothing
        deployment), restore and DRAIN it — the recovered pending
        windows score through the restored engine (the restore path; acks
        land durably in the restored journal, so a re-drain after a
        second crash re-emits nothing).  Returns the drained events;
        the hand-offs are queued for the next poll's phase 2."""
        worker = self._workers.pop(dead_wid)
        worker.kill()
        self._router.remove_worker(dead_wid)
        self.failovers += 1
        return self._continue_failover(dead_wid, worker)

    def _continue_failover(self, dead_wid, worker) -> list:
        """Fetch + restore + drain one declared-dead partition.  A
        fetch refusal (``PartitionUnavailable``) parks the pair on the
        fetch queue for the next poll; a fetch that reports the
        partition already consumed (retired marker on either side)
        ends the failover with nothing to do."""
        t0 = time.perf_counter()
        try:
            src = self._fetch_partition(worker)
        except PartitionUnavailable:
            self._fetch_queue.append((dead_wid, worker))
            return []
        if src is None:
            return []  # already consumed by an earlier controller
        # the verified partition is local and whole; the crash window
        # between the landed ship and the drain is its own kill point
        self._chaos("post_ship_pre_drain")
        restored = FleetServer.restore(
            src, self._loader, clock=self._clock
        )
        events = restored.flush()
        self.failover_ms += (time.perf_counter() - t0) * 1e3
        self._handoff_queue.append((dead_wid, restored))
        return events

    def _fetch_partition(self, worker) -> str | None:
        """Locate (or materialize) the dead worker's journal locally
        and return the directory to restore from; None when the
        partition was already consumed (retired).  The shared-disk
        default reads the directory in place; the shared-nothing
        transport (``har_tpu_torch.serve.net.NetCluster``) overrides this
        with the journal-shipping RPC — raising
        ``PartitionUnavailable`` when the ship agent is unreachable."""
        marker = os.path.join(worker.journal_dir, RETIRED_MARKER)
        if os.path.exists(marker):
            return None
        dest = self._standby_partition(worker.worker_id)
        if dest is not None:
            self._standby_origin[worker.worker_id] = worker.journal_dir
            return dest
        return worker.journal_dir

    # ------------------------------------------------- warm standbys

    def register_standby(self, standby, *, name: str = "sb0",
                         prefer=None) -> None:
        """Attach a ``StandbyAgent`` whose tails this controller drives
        from its poll loop and consults first at failover.  ``prefer``
        names the worker co-located with the standby's replicas:
        failover hand-offs of a partition this standby holds are
        steered there ahead of the ring owner (warm placement — the
        adopter next to the already-local bytes)."""
        self._standbys[name] = (standby, prefer)

    def _standby_partition(self, dead_wid) -> str | None:
        """The warm path of a partition fetch: a standby holding the
        dead worker's tail finalizes it — whole-file sha256 on
        already-local bytes plus the missing suffix (zero bytes when
        the tail was caught up).  Any ship failure here falls back to
        the cold path (``None``): a broken standby must never make a
        failover WORSE than the cold ship at failover."""
        from har_tpu_torch.serve.net.ship import ShipError

        for name, (standby, _prefer) in self._standbys.items():
            if not standby.holds(dead_wid):
                continue
            try:
                fin = standby.finalize(dead_wid)
            except ShipError:
                continue
            self.standby_fetches += 1
            self.failover_path_bytes += int(fin.get("bytes", 0))
            return standby.dest(dead_wid)
        return None

    def _warm_adopter(self, dead_wid):
        """The worker failover hand-offs should prefer for sessions of
        ``dead_wid`` — the one registered next to a standby that holds
        its replica; None when no standby claims it."""
        for standby, prefer in self._standbys.values():
            if prefer is not None and standby.holds(dead_wid):
                return prefer
        return None

    @property
    def pending_failovers(self) -> int:
        """Failovers parked on an unreachable partition fetch."""
        return len(self._fetch_queue)

    def _complete_failover(self, dead_wid, restored) -> None:
        """Phase 2: hand every drained session to the survivors, then
        commit the partition as consumed — final accounting into the
        ledger AND the dead directory's ``retired.json`` marker (what a
        takeover controller reads).  Idempotent: sessions the survivors
        already adopted are skipped, hand-off records make the source
        side re-derivable, and the marker is the commit point."""
        t0 = time.perf_counter()
        receivers = []
        # the restored partition wears the ordinary worker surface for
        # the hand-off (export_session/evict_session) — one evict body,
        # not a parallel wrapper that could drift from it
        source = ClusterWorker(dead_wid, restored, restored.journal.root)
        prefer = self._warm_adopter(dead_wid)
        for sid in restored.sessions:
            target_wid = self._hand_off(
                source, sid, dead_wid, prefer=prefer
            )
            if target_wid not in receivers:
                receivers.append(target_wid)
            self._chaos("mid_migration")
        self.failover_ms += (time.perf_counter() - t0) * 1e3
        for wid in receivers:
            self._workers[wid].note_failover_absorbed()
        self._ledger.append(
            {
                "worker_id": dead_wid,
                "accounting": restored.stats.accounting(),
                "scored_by_version": dict(
                    restored.stats.scored_by_version
                ),
            }
        )
        atomic_write(
            os.path.join(restored.journal.root, RETIRED_MARKER),
            json.dumps(self._ledger[-1]),
        )
        # shared-nothing hook: the transport controller also marks the
        # SOURCE copy retired on its home host (best-effort — the local
        # marker above is the commit point for this controller lineage)
        self._commit_retired(dead_wid, self._ledger[-1])
        restored.journal.close()

    def _commit_retired(self, dead_wid, entry: dict) -> None:
        """Transport hook: propagate a consumed partition's retired
        marker back to its source home.  In-process this only matters
        for a standby-sourced failover (the marker above landed in the
        REPLICA dir; a resume/takeover scan reads the original home);
        the wire transport overrides this with the agent's retire
        RPC."""
        origin = self._standby_origin.pop(dead_wid, None)
        if origin is not None and os.path.isdir(origin):
            atomic_write(
                os.path.join(origin, RETIRED_MARKER), json.dumps(entry)
            )

    def _hand_off(self, source, sid, source_wid, target_wid=None,
                  prefer=None):
        """Move one drained session from ``source`` to its ring owner
        (or the explicit ``target_wid`` of a planned move):
        adopt-first (durable on the target), chaos point in the
        dual-ownership window, then the source's journaled eviction.
        ``source`` speaks only ``export_session``/``evict_session`` —
        a live worker (in-process or RPC) or a ``_DrainedSource`` over
        a restored partition, transport-blind either way.  Bounded
        retries per target, then the next live worker — a hand-off
        never spins and never silently drops a session."""
        export = source.export_session(sid)
        if target_wid is not None:
            candidates = [target_wid]
        else:
            primary = self._router.owner(sid)
            candidates = [primary] + [
                wid for wid in self._workers if wid != primary
            ]
            if prefer is not None and prefer in self._workers:
                # warm placement: the adopter co-located with the
                # standby's replica of the source partition goes ahead
                # of the ring owner (the prior-durable-adopt pre-scan
                # below still wins over any preference)
                candidates = [prefer] + [
                    wid for wid in candidates if wid != prefer
                ]
        t0 = time.perf_counter()
        # ownership pre-scan over ALL live workers (the source of a
        # planned move excepted — it owns the session until its
        # eviction), before ANY adopt attempt: a prior (crashed)
        # attempt's durable adopt wins regardless of candidate order —
        # adopting a second live copy would fork the `handoffs`
        # generation ordering the dual-ownership resolution depends on
        target_wid = None
        for wid in self._workers:
            if wid != source_wid and self._workers[wid].owns(sid):
                target_wid = wid
                break
        if target_wid is None:
            for wid in candidates:
                worker = self._workers[wid]
                try:
                    # ClusterWorker.adopt is idempotent (skips the
                    # admit when the session already landed), so a
                    # retry after a flush failure completes the
                    # durability instead of tripping over
                    # "already admitted"
                    retry_call(
                        lambda: worker.adopt(export),
                        retries=self.config.handoff_retries,
                        backoff=self._handoff_backoff,
                        sleep=getattr(self._clock, "advance", None),
                    )
                except WorkerUnavailable as exc:
                    self._note_worker_failure(wid, exc)
                    continue
                except AdmissionError:
                    # target at its max_sessions cap: a capacity
                    # refusal is not a failure-detector signal — move
                    # on to the next live worker (the documented
                    # fallback)
                    continue
                target_wid = wid
                break
        if target_wid is None:
            raise ClusterError(
                f"no live worker could adopt session {sid!r}"
            )
        self._chaos("mid_handoff")
        source.evict_session(sid)
        target = self._workers[target_wid]
        target.note_migration_ms((time.perf_counter() - t0) * 1e3)
        self._placement[sid] = target_wid
        self.migration_log.append(
            {"sid": sid, "from": source_wid, "to": target_wid}
        )
        return target_wid

    # ---------------------------------------- planned rebalance / scale

    def migrate_session(self, session_id: Hashable, target_wid) -> None:
        """Planned live migration (rebalancing): hand the session to
        ``target_wid`` via the same adopt-first journal hand-off
        failover uses.  The caller drains first (``poll(force=True)``
        — its events are then already delivered); a session with live
        windows is refused by ``export_session``'s drain guard.  That
        ordering is the crash-safety argument: at the ``mid_handoff``
        stage boundary no acked event is in flight, so a controller
        crash there loses nothing — the session survives on >= 1
        journal and the takeover resolves ownership by generation."""
        src_wid = self.worker_of(session_id)
        if target_wid not in self._workers:
            raise ClusterError(f"unknown worker {target_wid!r}")
        if src_wid == target_wid:
            return
        source = self._workers[src_wid]
        self._hand_off(
            source, session_id, src_wid, target_wid=target_wid
        )

    def add_worker(
        self, worker_id=None, *, rebalance: bool = False
    ) -> str:
        """Scale up: a fresh journaled worker joins the ring; with
        ``rebalance`` the sessions whose arcs it now owns migrate over
        (drain → hand-off → resume, the same machinery)."""
        if worker_id is None:
            k = len(self._workers) + len(self._ledger)
            while f"w{k}" in self._workers:
                k += 1
            worker_id = f"w{k}"
        first = next(iter(self._workers.values())).server
        self._adopt_worker(
            ClusterWorker(
                worker_id,
                FleetServer(
                    self._model,
                    window=first.window,
                    hop=first.hop,
                    channels=first.channels,
                    smoothing=first.smoothing,
                    class_names=first.class_names,
                    config=first.config,
                    clock=self._clock,
                    fault_hook=(
                        self._fault_hook_for(worker_id)
                        if self._fault_hook_for is not None
                        else None
                    ),
                    journal=os.path.join(self.root, worker_id),
                    journal_config=self._journal_config,
                ),
                os.path.join(self.root, worker_id),
            )
        )
        if rebalance:
            self.rebalance()
        return worker_id

    def rebalance(self) -> int:
        """Migrate every session whose ring owner disagrees with its
        placement (after a scale-up, or drift from prior failovers).
        Returns the number of sessions moved.  Call after a
        ``poll(force=True)`` drain — a session with live windows is
        refused by the hand-off's drain guard (deliberately: draining
        here would strand acked-but-undelivered events in controller
        memory across the ``mid_handoff`` crash window)."""
        moved = 0
        for sid in list(self._placement):
            owner = self._router.owner(sid)
            if owner != self._placement[sid]:
                self.migrate_session(sid, owner)
                moved += 1
        return moved

    def retire_worker(self, worker_id) -> int:
        """Planned scale-down: hand every session of a DRAINED worker
        to the survivors' ring arcs, commit its final accounting to
        the ledger.  Returns the number of sessions moved.  Like
        ``migrate_session``, the caller drains first
        (``poll(force=True)``): a session with live windows is refused
        by the hand-off's drain guard, so no acked-but-undelivered
        event can sit in controller memory across the ``mid_handoff``
        crash window."""
        if worker_id not in self._workers:
            raise ClusterError(f"unknown worker {worker_id!r}")
        if len(self._workers) < 2:
            raise ClusterError("cannot retire the last worker")
        worker = self._workers[worker_id]
        # validate BEFORE mutating ring/membership: an undrained
        # session discovered mid-retire would otherwise strand the
        # worker outside the failure detector with its sessions
        # unreachable forever
        undrained = worker.undrained()
        if undrained:
            raise ClusterError(
                f"worker {worker_id!r} has live windows for sessions "
                f"{undrained[:5]}; drain (poll(force=True)) before "
                "retiring"
            )
        self._workers.pop(worker_id)
        self._router.remove_worker(worker_id)
        self._membership.remove(worker_id)
        moved = 0
        for sid in worker.sessions():
            self._hand_off(worker, sid, worker_id)
            moved += 1
        final = worker.final_accounting()
        self._ledger.append(
            {
                "worker_id": worker_id,
                "accounting": final["accounting"],
                "scored_by_version": final["scored_by_version"],
            }
        )
        atomic_write(
            os.path.join(worker.journal_dir, RETIRED_MARKER),
            json.dumps(self._ledger[-1]),
        )
        worker.close()
        return moved

    # --------------------------------------------------------- restart

    @classmethod
    def resume(
        cls,
        model,
        root: str,
        *,
        config: ClusterConfig | None = None,
        clock: Callable[[], float] | None = None,
        loader: Callable | None = None,
        fault_hook_for: Callable | None = None,
        journal_config: JournalConfig | None = None,
    ) -> "FleetCluster":
        """Restart a whole cluster from its journal directories (the
        controller and every worker died — a node loss).  Retired
        directories contribute their ledger entries; every other
        worker restores through ``FleetServer.restore``; sessions a crashed
        hand-off left on TWO journals resolve to the higher ``handoffs``
        generation (the adopter — adopt-first ordering guarantees the
        generations differ), and the loser's stale copy is evicted."""
        root = os.path.abspath(os.path.expanduser(root))
        the_loader = loader or (lambda version: model)
        workers: list[ClusterWorker] = []
        ledger: list[dict] = []
        for name in sorted(os.listdir(root)):
            jdir = os.path.join(root, name)
            if not os.path.isdir(jdir):
                continue
            marker = os.path.join(jdir, RETIRED_MARKER)
            if os.path.exists(marker):
                with open(marker) as f:
                    ledger.append(json.load(f))
                continue
            try:
                server = FleetServer.restore(
                    jdir,
                    the_loader,
                    clock=clock,
                    fault_hook=(
                        fault_hook_for(name)
                        if fault_hook_for is not None
                        else None
                    ),
                    journal_config=journal_config,
                )
            except JournalError:
                continue  # not a journal directory
            workers.append(ClusterWorker(name, server, jdir))
        cluster = cls(
            model,
            root,
            hop=workers[0].geometry()["hop"] if workers else 20,
            config=config,
            clock=clock,
            loader=loader,
            fault_hook_for=fault_hook_for,
            journal_config=journal_config,
            _workers=workers,
            _ledger=ledger,
        )
        return cluster

    @classmethod
    def takeover(
        cls,
        model,
        root: str,
        workers: list,
        *,
        config: ClusterConfig | None = None,
        clock: Callable[[], float] | None = None,
        loader: Callable | None = None,
        fault_hook_for: Callable | None = None,
        journal_config: JournalConfig | None = None,
    ) -> "FleetCluster":
        """Controller-only restart: the old controller crashed but the
        worker processes survived.  The new controller adopts the live
        ``ClusterWorker``s as they stand, re-derives placement from
        actual ownership (dual ownership from a crashed hand-off
        resolves by the ``handoffs`` generation), reads retired markers
        into the ledger, and COMPLETES any orphaned failover — a
        journal directory that is neither retired nor owned by a live
        worker is a partition whose migration the crash interrupted."""
        root = os.path.abspath(os.path.expanduser(root))
        ledger: list[dict] = []
        for name in sorted(os.listdir(root)):
            marker = os.path.join(root, name, RETIRED_MARKER)
            if os.path.isfile(marker):
                with open(marker) as f:
                    ledger.append(json.load(f))
        cluster = cls(
            model,
            root,
            hop=workers[0].geometry()["hop"] if workers else 20,
            config=config,
            clock=clock,
            loader=loader,
            fault_hook_for=fault_hook_for,
            journal_config=journal_config,
            _workers=workers,
            _ledger=ledger,
        )
        cluster._recover_orphans()
        return cluster

    def _recover_orphans(self) -> None:
        """Finish failovers a dead controller left half-done: restore,
        drain and hand off every journal directory no live worker owns
        and no retired marker has committed.  The drain's events ride
        ``_pending_events`` (acked durable before they queue, so a
        repeat crash re-derives rather than re-emits); the hand-offs
        are idempotent exactly like a first failover's."""
        owned = {w.journal_dir for w in self._workers.values()}
        for name in sorted(os.listdir(self.root)):
            jdir = os.path.join(self.root, name)
            if (
                not os.path.isdir(jdir)
                or jdir in owned
                or os.path.exists(os.path.join(jdir, RETIRED_MARKER))
            ):
                continue
            try:
                restored = FleetServer.restore(
                    jdir, self._loader, clock=self._clock
                )
            except JournalError:
                continue  # not a journal directory
            self.failovers += 1
            self._pending_events.extend(restored.flush())
            self._complete_failover(name, restored)

    def _rebuild_placement(self) -> None:
        """Restart-time ownership scan: resolve dual ownership (crash
        inside a hand-off window), then pin every session to the worker
        that actually holds it."""
        owners: dict = {}
        for wid, w in self._workers.items():
            for sid in w.sessions():
                owners.setdefault(sid, []).append(wid)
        for sid, wids in owners.items():
            if len(wids) > 1:
                # adopt-first ordering: generations strictly order the
                # copies; the highest is the adopted (newest) one
                wids.sort(
                    key=lambda wid: self._workers[wid].generation(sid)
                )
                keeper = wids[-1]
                for wid in wids[:-1]:
                    self._workers[wid].evict_session(sid)
                self._placement[sid] = keeper
            else:
                self._placement[sid] = wids[0]

    # ------------------------------------------------------- reporting

    def accounting(self) -> dict:
        """THE cross-worker conservation law: the element-wise sum of
        every live worker's accounting plus the retired-worker ledger.
        ``balanced`` requires every constituent to balance — a window
        double-counted or lost by a migration breaks a worker-level
        invariant before it could cancel out in the sums."""
        parts = map_fn(
            lambda w: w.accounting(), list(self._workers.values())
        )
        # a drained partition waiting on its phase-2 hand-offs is still
        # part of the global law (its windows are scored/pending THERE
        # until the ledger absorbs it)
        parts.extend(
            restored.stats.accounting()
            for _, restored in self._handoff_queue
        )
        parts.extend(entry["accounting"] for entry in self._ledger)
        total = reduce_sum(parts) if parts else {}
        total["workers"] = len(self._workers)
        total["retired_workers"] = len(self._ledger)
        return total

    def cluster_stats(self) -> dict:
        """Control-plane snapshot: global accounting, failover and
        migration evidence, per-worker session counts — aggregated with
        the same map/reduce primitives the drift escalation uses."""
        live = list(self._workers.values())
        # one control_stats round trip per worker (a transport-backed
        # worker pays one RPC here, not four)
        per_worker = map_fn(lambda w: w.control_stats(), live)
        return {
            "workers": len(live),
            "sessions": len(self._placement),
            "failovers": self.failovers,
            "failover_ms": round(self.failover_ms, 3),
            "failover_path_bytes": self.failover_path_bytes,
            "standbys": len(self._standbys),
            "standby_fetches": self.standby_fetches,
            "migrated_sessions": len(self.migration_log),
            "worker_failovers": reduce_sum(
                [p["worker_failovers"] for p in per_worker]
            ),
            "migrations": reduce_sum(
                [p["migrations"] for p in per_worker]
            ),
            "migration_ms": round(
                reduce_sum([p["migration_ms"] for p in per_worker]), 3
            ),
            "per_worker_sessions": {
                wid: p["sessions"]
                for wid, p in zip(self._workers, per_worker)
            },
            "accounting": self.accounting(),
            "retired": [e["worker_id"] for e in self._ledger],
        }

    def close(self) -> None:
        """Close every worker journal, including a restored partition
        still parked in the hand-off queue (its drain is durable; a
        later ``resume``/``takeover`` completes the migration).  Any
        still-stashed events were acked durable by their workers —
        abandoned here, never double-emitted on a later restore."""
        while self._handoff_queue:
            _, restored = self._handoff_queue.pop(0)
            if restored.journal is not None:
                restored.journal.close()
        for w in self._workers.values():
            w.close()
        for standby, _prefer in self._standbys.values():
            standby.close()
