"""Chaos over the wire: the cluster kill matrix re-run with REAL process
deaths, plus the partition-tolerance matrix the in-process harness
could not express (a shared-memory shim has no slow links).

SHARED-NOTHING throughout: every worker's journal lives in a
private per-host directory the controller never reads, with one
journal-ship agent per host (``net/ship.py``) — so every failover in
every cell exercises the ship RPC, and the matrix gains the ship axis
(``SHIP_KILL_POINTS``: the agent killed mid-send, the controller
killed mid-receive or post-verify).

Two matrices:

``run_net_kill_point`` — every engine stage boundary
(``chaos.KILL_POINTS``) killed inside ONE subprocess worker of a live
3-worker loopback cluster (``--chaos-point`` makes the worker
``os._exit`` there: a genuine SIGKILL, the un-flushed journal suffix
genuinely gone), plus the two controller points
(``chaos.CLUSTER_KILL_POINTS``: the CONTROLLER dies mid-migration, the
worker processes survive, ``NetCluster.takeover`` finishes the job).
The verdict is the same three-part cross-worker contract as the
in-process matrix — zero double-scored, migrated streams BIT-IDENTICAL
to the un-killed IN-PROCESS reference run, global conservation in
every observable snapshot — proving the wire changed nothing.

``run_net_partition`` — the failure modes only a real link has:

  ``slow_link``       one worker's calls exceed the deadline for a
                      while: the client retries (same request id,
                      server-side dedup = exactly-once), the prober
                      spends NO strike (``note_timeout``), and the
                      congested-but-alive worker is NOT failovered;
  ``dropped_probe``   blackholed requests: timeouts re-pace the probe
                      without a strike — again no spurious failover;
  ``duplicate``       every push delivered twice: the server's
                      request-id dedup answers the duplicate from
                      cache, zero double-ingested windows;
  ``split_brain``     a deposed controller crashes mid-hand-off
                      (adopt durable, evict not): dual LIVE ownership,
                      resolved by the session's ``handoffs``
                      generation when the next controller takes over —
                      a single surviving owner, zero windows lost.

Both matrices run on real monotonic time (no FakeClock — that is the
point), with small leases so the suite stays fast.

Port of ``har_tpu/serve/net/chaos.py`` (copied).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

from har_tpu_torch.serve.chaos import (
    CLUSTER_KILL_POINTS,
    GATEWAY_KILL_POINTS,
    KILL_POINTS,
    NET_PARTITION_CASES,
    SHIP_KILL_POINTS,
    _DEFAULT_AT,
    KillPlan,
    SimulatedCrash,
    _build_cluster,
    _cluster_schedule,
    _cluster_verdict,
    _event_fields,
    _recordings,
)
from har_tpu_torch.serve.cluster.controller import ClusterConfig
from har_tpu_torch.serve.cluster.membership import (
    WorkerTimeout,
    WorkerUnavailable,
)
from har_tpu_torch.serve.cluster.router import ConsistentHashRouter
from har_tpu_torch.serve.faults import FakeClock
from har_tpu_torch.serve.loadgen import AnalyticDemoModel
from har_tpu_torch.serve.net.controller import (
    NetCluster,
    launch_agents,
    launch_workers,
)

# failure detection tuned for a loopback suite: a dead process refuses
# instantly, so death lands within ~lease_s of the kill
_NET_CONFIG = dict(
    lease_s=0.4, probe_retries=2, probe_base_ms=20.0, probe_cap_ms=100.0
)

# ship pull granularity for the matrix: small enough that the smoke-
# scale journals span MANY chunks, so the mid_ship_* occurrences land
# genuinely mid-transfer (durable progress exists, transfer unfinished)
_MATRIX_CHUNK_BYTES = 4096


def _net_cluster_config() -> ClusterConfig:
    return ClusterConfig(**_NET_CONFIG)


def _launch_private_fleet(
    root: str,
    priv: str,
    workers: int,
    *,
    chaos_worker=None,
    chaos_point=None,
    chaos_at=1,
    agent_chaos_worker=None,
    agent_chaos_point=None,
    agent_chaos_at=1,
    **worker_kwargs,
):
    """The shared-nothing launch: each worker journals under its own
    private host directory ``<priv>/hK/wK`` (the controller never
    reads it), with one journal-ship agent per host serving it.
    Returns ``(net_workers, agent_handles)``."""
    net_workers = launch_workers(
        root, workers,
        journal_root=priv,
        chaos_worker=chaos_worker,
        chaos_point=chaos_point,
        chaos_at=chaos_at,
        **worker_kwargs,
    )
    roots = {
        w.worker_id: os.path.dirname(w.journal_dir)
        for w in net_workers
    }
    handles = launch_agents(
        roots,
        chaos_agent=agent_chaos_worker,
        chaos_point=agent_chaos_point,
        chaos_at=agent_chaos_at,
    )
    return net_workers, handles


def predicted_owner(session_id, workers: int, replicas: int | None = None):
    """The ring owner of a session BEFORE the cluster exists — the ring
    is deterministic in (worker ids, replicas), so the chaos victim
    (owner of session 0) is computable at worker-spawn time."""
    router = ConsistentHashRouter(
        replicas or ClusterConfig().replicas
    )
    for i in range(int(workers)):
        router.add_worker(f"w{i}")
    return router.owner(session_id)


def _drive_net_cluster(cluster, recordings, cursors, upto, hop, events,
                       on_round=None, max_rounds=20000, pace_s=0.002):
    """Real-time twin of ``chaos._drive_cluster``: hop-aligned
    round-robin delivery against a NetCluster.  A push that fails
    (refused OR timed out) keeps its cursor; a TIMED-OUT push is
    ambiguous (the worker may have executed it), so the cursor re-syncs
    from the owner's durable watermark before re-delivery — the
    documented transport contract, exercised for real here.  Completed
    migrations rewind their session's cursor to the adopted watermark;
    the loop keeps polling until no session is stranded on a dead
    worker."""
    for i in range(len(recordings)):
        try:
            cursors[i] = cluster.watermark(i)
        except WorkerUnavailable:
            pass  # mid-failover: the migration rewind below lands
    seen_migrations = len(cluster.migration_log)
    resync: set = set()
    for _ in range(max_rounds):
        active = False
        for i, rec in enumerate(recordings):
            stop = min(upto, len(rec))
            if i in resync:
                try:
                    cursors[i] = cluster.watermark(i)
                    resync.discard(i)
                except WorkerUnavailable:
                    continue  # still unreachable; keep the flag
            if cursors[i] >= stop:
                continue
            active = True
            take = hop - (cursors[i] % hop) or hop
            chunk = rec[cursors[i] : min(cursors[i] + take, stop)]
            try:
                cluster.push(i, chunk)
            except WorkerTimeout:
                # ambiguous delivery: the worker may hold these rows —
                # re-sync from its watermark before pushing more
                resync.add(i)
                continue
            except WorkerUnavailable:
                continue  # cursor kept; re-delivered post-failover
            cursors[i] += len(chunk)
        events.extend(cluster.poll(force=True))
        if on_round is not None:
            on_round(cluster)
        while seen_migrations < len(cluster.migration_log):
            sid = cluster.migration_log[seen_migrations]["sid"]
            cursors[sid] = cluster.watermark(sid)
            seen_migrations += 1
        if not active:
            # convergence is judged on the DURABLE watermark, not the
            # cursor: a worker can accept a push and die before its
            # records reach disk, and the controller only learns at
            # detection time (over a real wire there is no synchronous
            # `alive` bit).  An unreachable owner means a failover is
            # pending (keep polling — the polls feed the detector);
            # a watermark short of the schedule means the adopted copy
            # needs re-delivery from there — the documented transport
            # contract, exercised for real
            stranded = rewound = False
            for i in range(len(recordings)):
                stop = min(upto, len(recordings[i]))
                try:
                    w = cluster.watermark(i)
                except WorkerUnavailable:
                    stranded = True
                    continue
                if w < stop:
                    cursors[i] = w
                    rewound = True
            if bool(resync) or stranded or rewound:
                pass  # not settled yet
            else:
                break
        time.sleep(pace_s)  # real time IS the clock here
    else:  # pragma: no cover - harness guard
        raise RuntimeError("net cluster drive did not converge")
    events.extend(cluster.flush())
    if on_round is not None:
        on_round(cluster)


def _net_schedule(cluster, recordings, cursors, *, hop, swap_sample,
                  events, on_round=None):
    """The wire twin of ``chaos._cluster_schedule``: deliver to the
    swap point, resize every worker to 48 (the mid-run elastic bump
    the reference schedule applies), broadcast the hot swap, deliver
    the rest.  Idempotent per worker like the in-process schedule — a
    post-takeover resumption re-issues only where nothing landed."""
    _drive_net_cluster(
        cluster, recordings, cursors, swap_sample, hop, events, on_round
    )
    for w in list(cluster._workers.values()):
        if not w.alive:
            continue
        try:
            w.resize(48)
        except WorkerUnavailable:
            pass  # dead mid-broadcast: lands after failover via replay
    cluster.swap_model(None, version="B")
    _drive_net_cluster(
        cluster, recordings, cursors, max(map(len, recordings)), hop,
        events, on_round,
    )


def _safe_accounting(cluster, log: list) -> None:
    """Per-round conservation snapshot; a worker inside its suspicion
    window is unobservable over a real wire (its partition answers
    nobody), so those rounds record no snapshot instead of a fake one."""
    try:
        log.append(cluster.accounting())
    except WorkerUnavailable:
        pass


def run_net_kill_point(
    point: str,
    *,
    at: int | None = None,
    workers: int = 3,
    sessions: int = 12,
    seed: int = 0,
    n_samples: int = 300,
    window: int = 100,
    hop: int = 50,
    flush_every: int = 512,
    snapshot_every: int = 40,
    kill_round: int = 3,
) -> dict:
    """One cell of the wire chaos matrix (see module docstring).

    The reference is an IN-PROCESS un-killed cluster run of the same
    schedule (FakeClock, no fault hooks) — the acceptance bar is that
    the wire run's migrated streams are bit-identical to it.

    SHARED-NOTHING throughout: every worker's journal lives in a
    private per-host directory the controller never reads; failover
    journals arrive via the ship RPC from the host's agent process.
    The ship-axis points (``SHIP_KILL_POINTS``) additionally kill the
    transfer itself: the victim worker is really SIGKILLed mid-run,
    and then either the sending agent dies mid-ship (``mid_ship_send``
    — the harness restarts it, modeling a host daemon restart, and the
    parked failover resumes from the last durable chunk), the
    controller dies between chunks (``mid_ship_recv`` — takeover
    resumes the staged transfer), or the controller dies after the
    verified ship lands (``post_ship_pre_drain`` — takeover restores
    the complete staged copy)."""
    if (
        point not in KILL_POINTS
        and point not in CLUSTER_KILL_POINTS
        and point not in SHIP_KILL_POINTS
    ):
        raise ValueError(f"unknown net kill point {point!r}")
    at = _DEFAULT_AT[point] if at is None else at
    recordings = _recordings(sessions, n_samples, 3, seed)
    models = {"A": AnalyticDemoModel(), "B": AnalyticDemoModel(tau=5.0)}

    def loader(ver):
        return models.get(ver, models["A"])

    swap_sample = (n_samples // hop // 2) * hop

    # ---- reference: the un-killed IN-PROCESS cluster run ------------
    ref_root = tempfile.mkdtemp(prefix="har_netref_")
    try:
        ref_clock = FakeClock()
        ref = _build_cluster(
            ref_root, ref_clock, sessions=sessions, workers=workers,
            window=window, hop=hop, model=models["A"],
            flush_every=flush_every, snapshot_every=snapshot_every,
            loader=loader,
        )
        # the wire workers run without injected dispatch stalls; strip
        # the reference's fault hooks so both runs share one schedule
        for w in ref._workers.values():
            w.server._fault_hook = None
        for i in range(sessions):
            ref.add_session(i)
        ref_events: list = []
        _cluster_schedule(
            ref, recordings, [0] * sessions, hop=hop, clock=ref_clock,
            models=models, swap_sample=swap_sample, events=ref_events,
        )
        ref.close()
    finally:
        shutil.rmtree(ref_root, ignore_errors=True)

    # ---- the wire run -----------------------------------------------
    victim = predicted_owner(0, workers)
    root = tempfile.mkdtemp(prefix="har_netchaos_")
    priv = tempfile.mkdtemp(prefix="har_netpriv_")
    procs: dict = {}
    agent_procs: dict = {}
    try:
        net_workers, handles = _launch_private_fleet(
            root, priv, workers, window=window, hop=hop,
            target_batch=32, max_delay_ms=0.0, retries=1,
            flush_every=flush_every, snapshot_every=snapshot_every,
            chaos_worker=victim if point in KILL_POINTS else None,
            chaos_point=point if point in KILL_POINTS else None,
            chaos_at=at,
            agent_chaos_worker=(
                victim if point == "mid_ship_send" else None
            ),
            agent_chaos_point=(
                point if point == "mid_ship_send" else None
            ),
            agent_chaos_at=at,
        )
        procs.update({w.worker_id: w.process for w in net_workers})
        agent_procs.update(
            {wid: h.process for wid, h in handles.items()}
        )
        cluster = NetCluster(
            models["A"], root, _workers=net_workers,
            config=_net_cluster_config(), loader=loader,
            agents={wid: h.client() for wid, h in handles.items()},
            ship_chunk_bytes=_MATRIX_CHUNK_BYTES,
        )
        for i in range(sessions):
            cluster.add_session(i)
        events: list = []
        cursors = [0] * sessions
        balance_log: list = []
        rounds = {"n": 0}
        restarted = {"agent": False}
        controller_points = CLUSTER_KILL_POINTS + (
            "mid_ship_recv", "post_ship_pre_drain",
        )
        if point in controller_points:
            cluster.chaos = KillPlan(point, at)

        def on_round(c):
            rounds["n"] += 1
            if (
                (point in CLUSTER_KILL_POINTS
                 or point in SHIP_KILL_POINTS)
                and rounds["n"] == kill_round
            ):
                # a REAL worker death starts the failover the chosen
                # point then kills (the controller, or the transfer)
                procs[victim].kill()
            if (
                point == "mid_ship_send"
                and agent_procs[victim].poll() is not None
                and not restarted["agent"]
            ):
                # the sending host's agent died at its chunk boundary
                # (os._exit 137).  Restart it — a host daemon coming
                # back — and re-register: the parked failover retries
                # at the next poll and RESUMES from the last durable
                # chunk, never from scratch.
                restarted["agent"] = True
                fresh = launch_agents(
                    {victim: handles[victim].root}
                )[victim]
                handles[victim] = fresh
                agent_procs[victim] = fresh.process
                c.register_agent(victim, fresh.client())
            _safe_accounting(c, balance_log)

        crashed = False
        pre_crash_rpc = None
        t0 = time.perf_counter()
        try:
            _net_schedule(
                cluster, recordings, cursors, hop=hop,
                swap_sample=swap_sample, events=events,
                on_round=on_round,
            )
        except SimulatedCrash:
            crashed = True
            # the dead controller's transport evidence (bytes it
            # shipped before dying) — the takeover's counters restart
            # at zero, but the matrix judges the WHOLE failover
            pre_crash_rpc = cluster.transport_stats()
        fired = (
            procs[victim].poll() is not None
            if point in KILL_POINTS
            else restarted["agent"]
            if point == "mid_ship_send"
            else crashed
        )
        if not fired:
            cluster.shutdown_workers()
            cluster.close()
            return {
                "ok": False, "point": point,
                "why": f"kill point {point!r} never fired (at={at})",
                "windows_lost": 0, "failover_ms": 0.0,
            }
        if crashed:
            # the controller died mid-migration (or mid-ship); its
            # worker processes did not.  A fresh controller adopts the
            # still-responsive workers, resumes any half-shipped staged
            # transfer, and completes the orphaned failover — the
            # election layer drives exactly this via the lease file
            survivors = [
                w for w in cluster._workers.values() if w.alive
            ]
            cluster = NetCluster.takeover(
                models["A"], root, survivors,
                config=_net_cluster_config(), loader=loader,
                agents={
                    wid: h.client() for wid, h in handles.items()
                },
                ship_chunk_bytes=_MATRIX_CHUNK_BYTES,
            )
            _net_schedule(
                cluster, recordings, cursors, hop=hop,
                swap_sample=swap_sample, events=events,
                on_round=lambda c: _safe_accounting(c, balance_log),
            )
        failover_ms = (time.perf_counter() - t0) * 1e3
        stats = cluster.cluster_stats()
        verdict = _cluster_verdict(
            point, ref_events, events, cluster, balance_log, stats,
            failover_ms,
        )
        verdict["transport"] = "tcp"
        verdict["rpc"] = cluster.transport_stats()
        shipped = verdict["rpc"]["shipped_bytes"]
        resumes = verdict["rpc"]["ship_resumes"]
        chunks = verdict["rpc"]["ship_chunks"]
        if pre_crash_rpc is not None:
            shipped += pre_crash_rpc["shipped_bytes"]
            resumes += pre_crash_rpc["ship_resumes"]
            chunks += pre_crash_rpc["ship_chunks"]
        verdict["shipped_bytes"] = shipped
        verdict["ship_chunks"] = chunks
        verdict["ship_resumes"] = resumes
        if verdict["ok"] and shipped <= 0:
            verdict["ok"] = False
            verdict["why"] = (
                "failover completed without shipping any journal "
                "bytes — the shared-nothing path was bypassed"
            )
        if (
            verdict["ok"]
            and point in ("mid_ship_send", "mid_ship_recv")
            and resumes < 1
        ):
            verdict["ok"] = False
            verdict["why"] = (
                f"{point} fired but no transfer RESUMED from durable "
                "chunks — the ship restarted from scratch"
            )
        cluster.shutdown_workers()
        cluster.close()
        return verdict
    finally:
        # never leak worker/agent processes or rmtree under live
        # writers (clean exits already reaped: kill no-ops there)
        for proc in list(procs.values()) + list(agent_procs.values()):
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(priv, ignore_errors=True)


# ------------------------------------------------------- partitions


def run_net_partition(
    case: str,
    *,
    workers: int = 3,
    sessions: int = 9,
    seed: int = 0,
    n_samples: int = 200,
    window: int = 100,
    hop: int = 50,
) -> dict:
    """One cell of the partition-tolerance matrix (module docstring).
    Every case must end with a single surviving owner per session,
    conservation balanced, and ``windows_lost == 0``."""
    if case not in NET_PARTITION_CASES:
        raise ValueError(f"unknown partition case {case!r}")
    if case == "split_brain":
        return _run_split_brain(
            workers=workers, sessions=sessions, seed=seed,
            n_samples=n_samples, window=window, hop=hop,
        )
    from har_tpu_torch.serve.net.rpc import LinkFaults

    recordings = _recordings(sessions, n_samples, 3, seed)
    model = AnalyticDemoModel()
    victim = predicted_owner(0, workers)
    root = tempfile.mkdtemp(prefix="har_netpart_")
    priv = tempfile.mkdtemp(prefix="har_netpartpriv_")
    procs: list = []
    try:
        # private per-worker journal dirs here too: the partition
        # matrix must prove its zero-failover verdicts without any
        # shared-disk escape hatch (no agents needed — no partition
        # case restores a journal)
        net_workers = launch_workers(
            root, workers, window=window, hop=hop,
            target_batch=32, max_delay_ms=0.0,
            deadline_s=0.3, probe_deadline_s=0.2,
            journal_root=priv,
        )
        procs.extend(w.process for w in net_workers)
        cluster = NetCluster(
            model, root, _workers=net_workers,
            config=_net_cluster_config(),
            loader=lambda ver: model,
        )
        for i in range(sessions):
            cluster.add_session(i)
        # the link degrades MID-RUN (after admission): the impairment
        # must hit a working cluster, not its setup
        faults = None
        if case == "slow_link":
            # the victim's next 3 calls blow the deadline (the peer
            # still executes them: the retry-dedup path)
            faults = LinkFaults("delay", method="", times=3)
        elif case == "dropped_probe":
            faults = LinkFaults("drop", method="", times=3)
        elif case == "duplicate":
            faults = LinkFaults("dup", method="push", times=10**9)
        for w in net_workers:
            if w.worker_id == victim:
                w._client.faults = faults
        events: list = []
        cursors = [0] * sessions
        balance_log: list = []
        _drive_net_cluster(
            cluster, recordings, cursors, n_samples, hop, events,
            on_round=lambda c: _safe_accounting(c, balance_log),
        )
        why = _partition_verdict(
            cluster, events, balance_log, sessions, n_samples, window,
            hop, expect_failovers=0,
        )
        out = {
            "ok": why is None,
            "case": case,
            "why": why,
            "failovers": cluster.failovers,
            "rpc": cluster.transport_stats(),
            "delivered": len(events),
            "accounting": cluster.accounting(),
        }
        cluster.shutdown_workers()
        cluster.close()
        return out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(priv, ignore_errors=True)


def _partition_verdict(cluster, events, balance_log, sessions,
                       n_samples, window, hop, *, expect_failovers):
    """Shared checks: exactly-once delivery, complete delivery (the
    deterministic per-session window count), single live owner per
    session, conservation balanced in every observed snapshot."""
    keys = [(e.session_id, e.event.t_index) for e in events]
    if len(keys) != len(set(keys)):
        return "an event was delivered twice"
    expected = sessions * ((n_samples - window) // hop + 1)
    lost = expected - len(keys)
    if lost:
        return f"{lost} window(s) lost ({len(keys)}/{expected})"
    owners: dict = {}
    for sid in range(sessions):
        holding = [
            wid
            for wid, w in cluster._workers.items()
            if w.owns(sid)
        ]
        if len(holding) != 1:
            return (
                f"session {sid} owned by {holding!r} — not exactly one "
                "surviving owner"
            )
        owners[sid] = holding[0]
    acct = cluster.accounting()
    if not acct["balanced"] or acct["pending"] != 0:
        return f"conservation violated at the end: {acct}"
    for i, snap in enumerate(balance_log):
        if not snap["balanced"]:
            return f"conservation violated at snapshot {i}: {snap}"
    if cluster.failovers != expect_failovers:
        return (
            f"{cluster.failovers} failover(s) — expected "
            f"{expect_failovers} (a partition is not a death)"
        )
    return None


def _run_split_brain(*, workers, sessions, seed, n_samples, window,
                     hop) -> dict:
    """Split brain: controller A (the deposed leader) crashes inside a
    planned hand-off — the adopt is durable on the target, the evict
    never ran on the source — leaving the session LIVE ON TWO WORKERS.
    Controller B takes over and must resolve to a single owner by the
    ``handoffs`` generation (the adopted copy wins), then finish the
    run with zero windows lost."""
    recordings = _recordings(sessions, n_samples, 3, seed)
    model = AnalyticDemoModel()
    root = tempfile.mkdtemp(prefix="har_netsplit_")
    priv = tempfile.mkdtemp(prefix="har_netsplitpriv_")
    procs: list = []
    try:
        net_workers = launch_workers(
            root, workers, window=window, hop=hop,
            target_batch=32, max_delay_ms=0.0,
            journal_root=priv,
        )
        procs.extend(w.process for w in net_workers)
        cluster = NetCluster(
            model, root, _workers=net_workers,
            config=_net_cluster_config(),
            loader=lambda ver: model,
        )
        for i in range(sessions):
            cluster.add_session(i)
        events: list = []
        cursors = [0] * sessions
        half = (n_samples // hop // 2) * hop
        _drive_net_cluster(
            cluster, recordings, cursors, half, hop, events
        )
        # controller A: planned migration of session 0, killed at the
        # dual-ownership boundary (adopt durable, evict pending)
        src = cluster.worker_of(0)
        target = next(
            wid for wid in cluster._workers if wid != src
        )
        plan = KillPlan("mid_handoff", 1)
        cluster.chaos = plan
        crashed = False
        try:
            cluster.migrate_session(0, target)
        except SimulatedCrash:
            crashed = True
        if not crashed:
            cluster.shutdown_workers()
            cluster.close()
            return {
                "ok": False, "case": "split_brain",
                "why": "mid_handoff never fired",
            }
        dual = [
            wid
            for wid, w in cluster._workers.items()
            if w.owns(0)
        ]
        # controller B: the next lease generation — fresh clients to
        # the same workers; placement re-derived from actual ownership
        survivors = [w for w in cluster._workers.values() if w.alive]
        cluster2 = NetCluster.takeover(
            model, root, survivors,
            config=_net_cluster_config(),
            loader=lambda ver: model,
        )
        resolved_owner = cluster2.worker_of(0)
        balance_log: list = []
        _drive_net_cluster(
            cluster2, recordings, cursors, n_samples, hop, events,
            on_round=lambda c: _safe_accounting(c, balance_log),
        )
        why = _partition_verdict(
            cluster2, events, balance_log, sessions, n_samples,
            window, hop, expect_failovers=0,
        )
        if why is None and len(dual) != 2:
            why = (
                f"mid_handoff crash left session 0 on {dual!r}, "
                "not two workers — the split never happened"
            )
        if why is None and resolved_owner != target:
            why = (
                f"generation resolution kept {resolved_owner!r}, not "
                f"the adopter {target!r} (higher handoffs generation)"
            )
        out = {
            "ok": why is None,
            "case": "split_brain",
            "why": why,
            "dual_owners": dual,
            "resolved_owner": resolved_owner,
            "delivered": len(events),
            "accounting": cluster2.accounting(),
        }
        cluster2.shutdown_workers()
        cluster2.close()
        cluster.close()
        return out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(priv, ignore_errors=True)


# ------------------------------------------------- gateway HA matrix


def run_gateway_kill_point(
    point: str,
    *,
    at: int | None = None,
    workers: int = 2,
    sessions: int = 6,
    seed: int = 0,
    n_samples: int = 600,
    window: int = 100,
    hop: int = 50,
    # the gateway forwards synchronously, so its serve loop cannot
    # renew while a worker call is in flight: the lease must outlast
    # the longest forward stall (first-dispatch warmup on a cold
    # worker is ~0.5s) or the standby steals it mid-round — benign for
    # data (worker watermarks are the truth) but it would turn the
    # matrix's "kill" cells into accidental pre-kill flips
    lease_s: float = 1.0,
    handoff_round: int | None = None,
) -> dict:
    """One cell of the gateway-pair failover matrix: kill the ACTIVE
    gateway of an elected pair at one of its stage boundaries
    (``chaos.GATEWAY_KILL_POINTS``) while a reconnecting HA client is
    mid-delivery, or — with the pseudo-point ``"drain"`` — restart it
    GRACEFULLY instead (``shutdown {"drain": true}``: in-flight frames
    finish, refusals carry ``{"moved": ...}``, the lease is released
    early).  The acceptance bar is identical for both, which is the
    drain-indistinguishability pin: the standby takes the lease, the
    client resumes from the workers' watermarks, zero windows lost,
    and the scored stream BIT-IDENTICAL to an un-killed IN-PROCESS
    reference run of the same schedule.

    The gateway owns no session state (workers journal, the lease
    directory elects), so the kill never touches a journal — what this
    matrix proves is that the FRONT DOOR moving costs nothing: edge
    dedup-by-watermark absorbs the client's replayed frames and the
    fenced lease generation rejects any late ack from the deposed
    leader."""
    from har_tpu_torch.serve.net.client import HAGatewayClient
    from har_tpu_torch.serve.net.gateway import launch_gateway_pair
    from har_tpu_torch.serve.net.ingest import IngestConfig
    from har_tpu_torch.serve.net.rpc import RpcClient, RpcError
    from har_tpu_torch.utils.backoff import BackoffPolicy

    drain = point == "drain"
    if not drain and point not in GATEWAY_KILL_POINTS:
        raise ValueError(f"unknown gateway kill point {point!r}")
    at = (_DEFAULT_AT.get(point, 1) if at is None else at)
    rounds = n_samples // hop
    if handoff_round is None:
        handoff_round = rounds // 3
    # the handoff cells need an explicit drain request to reach the
    # kill point (or to trigger the graceful restart)
    handoff = drain or point == "mid_lease_handoff"
    recordings = _recordings(sessions, n_samples, 3, seed)
    model = AnalyticDemoModel()

    def loader(ver):
        return model

    # ---- reference: the un-killed IN-PROCESS cluster run ------------
    ref_root = tempfile.mkdtemp(prefix="har_gwref_")
    try:
        ref_clock = FakeClock()
        ref = _build_cluster(
            ref_root, ref_clock, sessions=sessions, workers=workers,
            window=window, hop=hop, model=model,
            flush_every=512, snapshot_every=40, loader=loader,
        )
        for w in ref._workers.values():
            w.server._fault_hook = None
        for i in range(sessions):
            ref.add_session(i)
        ref_events: list = []
        for r in range(rounds):
            for i in range(sessions):
                ref.push(i, recordings[i][r * hop:(r + 1) * hop])
            ref_events.extend(ref.poll(force=True))
            ref_clock.advance(0.01)
        ref_events.extend(ref.flush())
        ref.close()
    finally:
        shutil.rmtree(ref_root, ignore_errors=True)

    # ---- the wire run: worker fleet + elected gateway pair ----------
    root = tempfile.mkdtemp(prefix="har_gwchaos_")
    procs: list = []
    client = None
    try:
        net_workers = launch_workers(
            root, workers, window=window, hop=hop, target_batch=32,
            max_delay_ms=0.0, retries=1, flush_every=512,
            snapshot_every=40,
        )
        procs.extend(w.process for w in net_workers)
        pair = launch_gateway_pair(
            root, net_workers, deadline_s=2.0,
            config=IngestConfig(), lease_s=lease_s,
            chaos_point=None if drain else point,
            chaos_at=at,
        )
        procs.extend(p for p, _, _ in pair)
        (proc_a, host_a, port_a), (_, host_b, port_b) = pair
        client = HAGatewayClient(
            [f"{host_a}:{port_a}", f"{host_b}:{port_b}"],
            deadline_s=2.0, retries=1, seed=seed,
            reconnect=BackoffPolicy(
                base_ms=20.0, cap_ms=250.0, factor=2.0, jitter=0.25
            ),
        )
        for i in range(sessions):
            client.add_session(i)
        events: list = []
        for r in range(rounds):
            if handoff and r == handoff_round:
                # address gateway A DIRECTLY, not through the HA
                # client: a deadline-retried drain that followed the
                # lease would drain the NEW leader too and leave the
                # pair dry
                probe = RpcClient(
                    host_a, port_a, deadline_s=1.0, retries=0
                )
                try:
                    probe.call("shutdown", {"drain": True})
                except RpcError:
                    pass  # mid_lease_handoff kills A inside the call
                finally:
                    probe.close()
            for i in range(sessions):
                client.push(i, recordings[i][r * hop:(r + 1) * hop])
            events.extend(client.poll(force=True))
        events.extend(client.flush())
        acct = client.accounting()
        gw_stats = client.gateway_stats()

        # ---- fired check -------------------------------------------
        deadline = time.monotonic() + 5.0
        while proc_a.poll() is None and time.monotonic() < deadline:
            time.sleep(0.02)
        rc_a = proc_a.poll()
        why = None
        if drain:
            if rc_a != 0:
                why = (
                    f"drain: gateway A exited {rc_a!r}, wanted a clean "
                    "0 after the grace window"
                )
        elif rc_a is None:
            why = f"{point}: the chaos plan never fired (A still alive)"

        # ---- verdict: the same bar as every other matrix ------------
        def _per_sid(evts):
            out: dict = {}
            for fe in evts:
                out.setdefault(fe.session_id, []).append(
                    _event_fields(fe)
                )
            return out

        ref_by = _per_sid(ref_events)
        got_by = _per_sid(events)
        keys = [(fe.session_id, fe.event.t_index) for fe in events]
        if why is None and len(keys) != len(set(keys)):
            why = (
                "duplicate (session, t_index) events — the replayed "
                "frame was double-ingested across the lease flip"
            )
        windows_lost = len(ref_events) - len(events)
        if why is None and windows_lost != 0:
            why = f"{windows_lost} windows lost across the lease flip"
        if why is None and got_by != ref_by:
            why = (
                "scored stream not bit-identical to the un-killed "
                "in-process reference"
            )
        if why is None and not acct.get("balanced", False):
            why = f"conservation violated after failover: {acct!r}"
        if why is None and int(acct.get("lost_in_crash", 0)) != 0:
            why = (
                f"{acct['lost_in_crash']} windows declared lost — the "
                "gateway kill must not cost journal suffix"
            )
        if why is None and client.gen < 2:
            why = (
                "client never saw a fenced generation bump "
                f"(gen={client.gen}) — did the lease actually move?"
            )
        if why is None and client.failover_episodes < 1:
            why = "client recorded no failover episode"
        out = {
            "ok": why is None,
            "point": point,
            "why": why,
            "drain": drain,
            "windows_lost": windows_lost,
            "delivered": len(events),
            "failover_ms": float(client.last_failover_ms or 0.0),
            "reconnects": client.reconnects,
            "moved_receipts": client.moved_receipts,
            "stale_acks_rejected": client.stale_acks_rejected,
            "resumed_sessions": len(client.resumed),
            "deduped_samples": client.deduped_samples,
            "gateways": 2,
            "gateway_exit": rc_a,
            "lease_gen": client.gen,
            "standby_lease_wins": int(gw_stats.get("lease_wins", 0)),
            "accounting": acct,
        }
        client.shutdown()
        return out
    finally:
        if client is not None:
            client.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(root, ignore_errors=True)
