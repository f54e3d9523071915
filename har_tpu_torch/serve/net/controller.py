"""``NetCluster`` — the FleetCluster control plane over real sockets.

The controller logic is INHERITED, not rewritten: ``FleetCluster``
already speaks only the worker surface, so running over the wire is
"construct it with ``NetWorker``s".  What this subclass adds is the
transport's bookkeeping:

  - ``net_stats`` — one ``FleetStats`` receiving the controller-side
    transport counters (``rpc_sent`` / ``rpc_retries`` /
    ``rpc_bytes_tx/rx`` + the ``rpc_rtt`` histogram, and the
    journal-ship counters ``shipped_bytes`` / ``ship_chunks`` /
    ``ship_resumes``) from every worker's RPC client and the ship
    clients;
  - ``observe_drift`` over the wire: per-session ``DriftReport``s
    pulled from every live worker (the ``drift_reports`` RPC) into the
    one fleet-global RetrainTrigger;
  - worker-process lifecycle helpers (``shutdown_workers``).

FAILOVER is shared-nothing when ``agents`` is given: the dead worker's
journal ships over the RPC transport (``har_tpu_torch.serve.net.ship``)
from its host's ship agent into this controller's private staging
directory (``<root>/_shipped/<wid>``), is digest-verified, and only
then restored — the controller never reads another host's filesystem.
Without agents the inherited shared-disk path still works (the
loopback single-box deployment).
Either way the per-session hand-offs ride the ``adopt`` RPC.  Death
needs REFUSED connections — ``WorkerTimeout`` never strikes — so a
live-but-slow worker is never restored out from under itself (the
fencing argument of the JAX package's docs/multihost.md).

``launch_workers`` spawns ``serve-worker`` OS subprocesses
(``python -m har_tpu_torch.cli serve-worker``) on loopback ephemeral
ports and wraps them in ``NetWorker``s; ``launch_agents`` does the same
for the per-host journal-ship agents (``serve-agent``).  The ready
handshake is one JSON line on the child's stdout; a worker prints it
once its scoring stack is imported and warm.

Port of ``har_tpu/serve/net/controller.py`` (copied).  Every launcher
of this package starts its children through ``_child_env`` and
``_nice``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from har_tpu_torch.serve.cluster.controller import (
    RETIRED_MARKER,
    ClusterError,
    FleetCluster,
    PartitionUnavailable,
)
from har_tpu_torch.serve.cluster.membership import WorkerUnavailable
from har_tpu_torch.serve.journal import SHIP_DONE, JournalError
from har_tpu_torch.serve.net import ship as shiplib
from har_tpu_torch.serve.net.client import NetWorker
from har_tpu_torch.serve.net.ship import (
    DEFAULT_CHUNK_BYTES,
    ShipClient,
    ShipError,
    ShipUnavailable,
)
from har_tpu_torch.serve.stats import FleetStats

# controller-private staging area for shipped partitions, under the
# CONTROLLER's root (controller replicas share it — the same disk the
# election lease file already lives on), never on a worker host
SHIPPED_DIR = "_shipped"
# controller-private home for warm-standby tails (one subdirectory per
# followed worker, har_tpu_torch.serve.replica.StandbyAgent): same disk as
# the staging area, but these fill CONTINUOUSLY while the workers are
# alive — at failover the finalized tail is the restore source and the
# ship path above becomes the fallback
REPLICA_DIR = "_replica"


class NetCluster(FleetCluster):
    """FleetCluster over NetWorkers.  Construct with
    ``_workers=[NetWorker, ...]`` (``launch_workers`` builds them);
    the positional in-process construction path is refused."""

    def __init__(
        self,
        model,
        root,
        *args,
        agents: dict | None = None,
        ship_chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        **kwargs,
    ):
        if kwargs.get("_workers") is None:
            raise ClusterError(
                "NetCluster needs _workers=[NetWorker, ...] — spawn "
                "them with har_tpu_torch.serve.net.launch_workers (or "
                "`serve-worker`)"
            )
        # ship plumbing first: the base constructor may already adopt
        # workers, and every seam below reads these
        self.net_stats = FleetStats()
        self._agents: dict = dict(agents or {})
        self._ship_chunk_bytes = int(ship_chunk_bytes)
        # wall time inside fetch_journal + per-transfer evidence: the
        # ship_ms observable
        self.ship_ms = 0.0
        self.ship_transfers: list[dict] = []
        # partitions whose ship FAILED for a source-side reason (digest
        # never verifies, agent refuses the dir): parked like an
        # unreachable agent but NOT retried every poll — re-shipping a
        # provably corrupt source is wasted work until something
        # changes; register_agent() is the operator's "the source is
        # fixed/replaced" signal that lifts the quarantine
        self._ship_quarantine: dict = {}
        for client in self._agents.values():
            client.bind_stats(self.net_stats)
        super().__init__(model, root, *args, **kwargs)
        for w in self._workers.values():
            w.bind_stats(self.net_stats)

    def _adopt_worker(self, worker) -> None:
        super()._adopt_worker(worker)
        # workers attached after construction (takeover, scale-up)
        # join the shared transport counters too
        stats = getattr(self, "net_stats", None)
        if stats is not None:
            worker.bind_stats(stats)

    # ----------------------------------- shared-nothing journal ship

    def register_agent(self, worker_id, client: ShipClient) -> None:
        """(Re)bind a worker host's ship agent — the harness calls this
        after restarting a crashed agent (a host daemon coming back);
        parked failovers retry against it at the next poll, and a
        source-side quarantine (a ship that kept failing its digests)
        is lifted: a re-registered agent means the source changed."""
        old = self._agents.get(worker_id)
        if old is not None and old is not client:
            old.close()
        client.bind_stats(self.net_stats)
        self._agents[worker_id] = client
        self._ship_quarantine.pop(worker_id, None)

    def _staged_dir(self, wid) -> str:
        return os.path.join(self.root, SHIPPED_DIR, str(wid))

    def _fetch_partition(self, worker) -> str | None:
        """The journal-shipping RPC replacing the shared-disk read: pull
        the dead worker's segments + newest snapshot from its host's
        ship agent into the controller-private staging directory,
        digest-verified and resumable (har_tpu_torch.serve.net.ship).  An
        unreachable agent raises ``PartitionUnavailable`` — the base
        control plane parks the failover and retries each poll.
        Without a registered agent the inherited shared-disk path
        applies (single-box deployment; the bench baseline)."""
        agent = self._agents.get(worker.worker_id)
        if agent is None:
            return super()._fetch_partition(worker)
        wid = worker.worker_id
        dest = self._staged_dir(wid)
        if os.path.exists(os.path.join(dest, RETIRED_MARKER)):
            return None
        # warm path first: a standby that tailed this worker holds
        # (verified-on-finalize) local bytes — zero-transfer failover.
        # Consulted even for a quarantined partition: the quarantine
        # indicts the SOURCE's ship, not the standby's already-landed
        # digest-checked copy (a finalize failure falls through to the
        # quarantine refusal below).
        warm = self._standby_partition(wid)
        if warm is not None:
            return warm
        if wid in self._ship_quarantine:
            # a prior ship failed for a SOURCE reason (digest never
            # verifies, agent refuses the dir) — don't re-pull a
            # provably bad source every poll; register_agent lifts this
            raise PartitionUnavailable(
                f"partition {wid!r} quarantined: "
                f"{self._ship_quarantine[wid]}"
            )
        try:
            if agent.retired(wid):
                return None
            self._ship(agent, wid, dest)
        except ShipUnavailable as exc:
            raise PartitionUnavailable(str(exc)) from exc
        except ShipError as exc:
            # the source itself is bad (torn beyond its digests, a
            # lying peer): refuse LOUDLY, quarantine the partition, and
            # park the failover — one corrupt partition must degrade
            # one partition, never crash-loop the whole control plane
            self._ship_quarantine[wid] = str(exc)
            import warnings

            warnings.warn(
                f"journal ship for dead worker {wid!r} REFUSED: {exc} "
                "— partition parked (its sessions stay down); fix or "
                "replace the source and register_agent() to retry",
                RuntimeWarning,
                stacklevel=2,
            )
            raise PartitionUnavailable(str(exc)) from exc
        return dest

    def _ship(self, agent: ShipClient, wid, dest: str) -> dict:
        t0 = time.perf_counter()
        out = shiplib.fetch_journal(
            agent, str(wid), dest,
            chunk_bytes=self._ship_chunk_bytes,
            chaos=self._chaos,
            stats=self.net_stats,
        )
        self.ship_ms += (time.perf_counter() - t0) * 1e3
        self.ship_transfers.append({"wid": wid, **out})
        return out

    def _commit_retired(self, dead_wid, entry: dict) -> None:
        """Propagate the consumed partition's retired marker back to
        its home host (best-effort: the staged copy's local marker is
        the commit point for this controller lineage; the source-side
        marker is what a FRESH controller with only agent addresses
        learns from)."""
        agent = self._agents.get(dead_wid)
        if agent is None:
            return
        try:
            agent.retire(str(dead_wid), entry)
        except ShipError:
            # ShipError covers ShipUnavailable too: a wiped/replaced
            # host refusing the marker must not crash the poll that
            # just completed the failover — the local marker rules,
            # and a later retire (or orphan discovery) re-lands it
            pass

    # -------------------------------------------- drift over the wire

    def observe_drift(self, trigger) -> None:
        """Fleet-GLOBAL drift escalation over the wire: pull every live
        worker's per-session ``DriftReport``s (the ``drift_reports``
        RPC, float64-exact codec) into the ONE aggregator, so K
        sessions drifting on a common channel fire the retrain trigger
        no matter how the router spread them across worker processes.
        Episode identity (``(generation, onset)``) and the stale-report
        guard live in the aggregator, so re-pulling the same stored
        report — or re-delivering it after a retried RPC — is a no-op
        by construction.  A worker that cannot answer contributes no
        evidence this round and feeds the failure detector instead."""
        for wid in list(self._workers):
            w = self._workers[wid]
            if not w.alive:
                continue
            try:
                reports = w.drift_reports()
            except WorkerUnavailable as exc:
                self._note_worker_failure(wid, exc)
                continue
            self._membership.note_ok(wid)
            for sid, report in reports:
                trigger.observe(sid, report)

    # -------------------------------------- in-process-only surfaces

    def add_worker(self, worker_id=None, *, rebalance: bool = False):
        raise ClusterError(
            "NetCluster cannot build a worker in-process; spawn one "
            "with `serve-worker` / launch_workers and attach it "
            "via attach_worker()"
        )

    @classmethod
    def resume(cls, *args, **kwargs):
        raise ClusterError(
            "whole-node resume restores in-process workers; over the "
            "wire, restart the worker processes (serve-worker "
            "--resume) and NetCluster.takeover the survivors"
        )

    @classmethod
    def takeover(
        cls,
        model,
        root: str,
        workers: list,
        *,
        agents: dict | None = None,
        config=None,
        clock=None,
        loader=None,
        fault_hook_for=None,
        journal_config=None,
        ship_chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    ) -> "NetCluster":
        """Controller-only restart over the wire: adopt the surviving
        worker processes, read retired markers from BOTH marker homes
        (``<root>/<wid>`` for the shared-disk deployment,
        ``<root>/_shipped/<wid>`` for shipped partitions), and complete
        any orphaned failover — including one a dead controller left
        MID-SHIP (the staged directory resumes from its last durable
        chunk via the recorded agent)."""
        root = os.path.abspath(os.path.expanduser(root))
        ledger: list[dict] = []
        seen: set = set()
        for base in (
            root,
            os.path.join(root, SHIPPED_DIR),
            # a failover completed FROM a warm standby tail writes its
            # marker into the replica home — the third marker home
            os.path.join(root, REPLICA_DIR),
        ):
            if not os.path.isdir(base):
                continue
            for name in sorted(os.listdir(base)):
                marker = os.path.join(base, name, RETIRED_MARKER)
                if not os.path.isfile(marker):
                    continue
                with open(marker) as f:
                    entry = json.load(f)
                if entry.get("worker_id") in seen:
                    continue  # marked on both sides: one ledger entry
                seen.add(entry.get("worker_id"))
                ledger.append(entry)
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
            agents=agents,
            ship_chunk_bytes=ship_chunk_bytes,
        )
        cluster._recover_orphans()
        return cluster

    def _recover_orphans(self) -> None:
        """Finish failovers a dead controller left half-done, the
        shared-nothing way: a STAGED directory under ``_shipped/`` that
        is not retired is a partition whose migration the crash
        interrupted — resume the ship if its digests never finished
        verifying (``fetch_journal`` picks up from the last durable
        chunk), then restore, drain and hand off exactly like a first
        failover.  Agent-listed journal dirs owned by no live worker
        and no ledger entry are failovers that never even started —
        pulled the same way.  Without agents the inherited shared-disk
        scan applies."""
        if not self._agents:
            super()._recover_orphans()
            return
        owned = set(self._workers)
        ship_root = os.path.join(self.root, SHIPPED_DIR)
        staged = (
            sorted(
                n
                for n in os.listdir(ship_root)
                if os.path.isdir(os.path.join(ship_root, n))
            )
            if os.path.isdir(ship_root)
            else []
        )
        candidates = list(staged)
        for wid in self._agents:
            if wid not in candidates:
                candidates.append(wid)
        retired_wids = {e.get("worker_id") for e in self._ledger}
        for wid in candidates:
            if wid in owned or wid in retired_wids:
                continue
            dest = self._staged_dir(wid)
            if os.path.exists(os.path.join(dest, RETIRED_MARKER)):
                continue
            agent = self._agents.get(wid)
            try:
                if agent is not None and agent.retired(wid):
                    continue
            except ShipError:
                pass  # judge from local state; the ship below retries
            if not os.path.exists(os.path.join(dest, SHIP_DONE)):
                if agent is None:
                    continue  # unfetchable now; a later takeover retries
                try:
                    self._ship(agent, wid, dest)
                except ShipUnavailable:
                    continue  # agent down: park for a later takeover
                except ShipError as exc:
                    # a corrupt source must not kill the takeover —
                    # quarantine this partition, adopt everything else
                    self._ship_quarantine[wid] = str(exc)
                    import warnings

                    warnings.warn(
                        f"orphaned partition {wid!r} ship REFUSED: "
                        f"{exc} — quarantined; fix the source and "
                        "register_agent() to retry",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                    continue
            try:
                from har_tpu_torch.serve.engine import FleetServer

                restored = FleetServer.restore(
                    dest, self._loader, clock=self._clock
                )
            except JournalError:
                continue  # not (yet) a restorable copy
            self.failovers += 1
            self._pending_events.extend(restored.flush())
            self._complete_failover(wid, restored)

    def attach_worker(self, worker: NetWorker, *, rebalance: bool = False):
        """Scale up with an already-running worker process; with
        ``rebalance`` the sessions its ring arcs now own migrate over
        (the inherited drain → hand-off → resume rails)."""
        self._adopt_worker(worker)
        if rebalance:
            self.rebalance()
        return worker.worker_id

    # ------------------------------------------------------ reporting

    def transport_stats(self) -> dict:
        """Controller-side RPC counters: calls, retries, bytes, rtt,
        and the journal-ship evidence (bytes/chunks/resumes + wall
        time inside fetch_journal)."""
        s = self.net_stats
        return {
            "rpc_sent": s.rpc_sent,
            "rpc_retries": s.rpc_retries,
            "rpc_bytes_tx": s.rpc_bytes_tx,
            "rpc_bytes_rx": s.rpc_bytes_rx,
            "rpc_rtt_p50_ms": s.rpc_rtt.percentile(50),
            "rpc_rtt_p99_ms": s.rpc_rtt.percentile(99),
            "shipped_bytes": s.shipped_bytes,
            "ship_chunks": s.ship_chunks,
            "ship_resumes": s.ship_resumes,
            "ship_ms": round(self.ship_ms, 3),
            # warm-standby evidence: bytes moved ON the failover path
            # (0 for a caught-up tail) and how many fetches the warm
            # path answered instead of a ship
            "failover_path_bytes": self.failover_path_bytes,
            "standby_fetches": self.standby_fetches,
            "standbys": len(self._standbys),
        }

    # ------------------------------------------------------ lifecycle

    def close(self) -> None:
        super().close()
        for client in self._agents.values():
            client.close()

    def shutdown_workers(self, timeout_s: float = 5.0) -> None:
        """Ask every live worker process to exit cleanly and reap the
        subprocess handles this controller launched."""
        for w in self._workers.values():
            if w.alive:
                w.shutdown()
        deadline = time.monotonic() + timeout_s
        for w in self._workers.values():
            proc = w.process
            if proc is None:
                continue
            try:
                proc.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _child_env() -> dict:
    """The children's environment: this process's, with this package
    importable from where this file lives, whatever the caller's
    working directory."""
    here = os.path.dirname(os.path.abspath(__file__))
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    path = os.environ.get("PYTHONPATH")
    return {
        **os.environ,
        "PYTHONPATH": pkg_parent + (os.pathsep + path if path else ""),
    }


def _nice() -> list:
    """The prefix of every child's command line: none, so a child runs
    at this process's priority."""
    return []


def launch_workers(
    root: str,
    n: int,
    *,
    model: str = "demo",
    window: int = 200,
    hop: int = 200,
    channels: int = 3,
    smoothing: str = "ema",
    max_sessions: int = 4096,
    target_batch: int = 32,
    max_delay_ms: float = 0.0,
    retries: int = 1,
    flush_every: int = 512,
    snapshot_every: int = 40,
    deadline_s: float = 2.0,
    probe_deadline_s: float = 0.25,
    rpc_retries: int = 2,
    max_idle_s: float = 120.0,
    chaos_worker: str | None = None,
    chaos_point: str | None = None,
    chaos_at: int = 1,
    stats: FleetStats | None = None,
    ready_timeout_s: float = 30.0,
    journal_root: str | None = None,
) -> list[NetWorker]:
    """Spawn ``n`` ``serve-worker`` subprocesses on loopback ephemeral
    ports and return their ``NetWorker`` proxies.

    Journal layout: by default each worker journals under ``root/wK``
    (the shared-disk deployment — the controller can restore the
    directory in place).  ``journal_root`` moves every worker's journal
    to ``<journal_root>/hK/wK`` instead: one PRIVATE per-worker "host"
    directory the controller never reads — the shared-nothing layout
    the journal-shipping failover requires, with ``<journal_root>/hK``
    the root a per-host ship agent (``launch_agents``) serves.

    ``chaos_worker`` names the one worker started with
    ``--chaos-point`` (the wire chaos matrix's victim).  Each child's
    stderr is captured to ``<journal_dir>/worker.stderr.log``; a child
    that exits or stays silent past ``ready_timeout_s`` raises
    ``ClusterError`` with its id and stderr tail, after every child is
    killed."""
    os.makedirs(root, exist_ok=True)
    child_env = _child_env()
    workers: list[NetWorker] = []
    procs: list[tuple[str, str, subprocess.Popen]] = []
    try:
        for i in range(int(n)):
            wid = f"w{i}"
            if journal_root is None:
                jdir = os.path.join(root, wid)
            else:
                jdir = os.path.join(journal_root, f"h{i}", wid)
            os.makedirs(jdir, exist_ok=True)
            cmd = _nice() + [
                sys.executable, "-m", "har_tpu_torch.cli", "serve-worker",
                "--worker-id", wid,
                "--journal", jdir,
                "--model", model,
                "--window", str(window),
                "--hop", str(hop),
                "--channels", str(channels),
                "--smoothing", smoothing,
                "--max-sessions", str(max_sessions),
                "--target-batch", str(target_batch),
                "--max-delay-ms", str(max_delay_ms),
                "--retries", str(retries),
                "--flush-every", str(flush_every),
                "--snapshot-every", str(snapshot_every),
                "--max-idle-s", str(max_idle_s),
            ]
            if chaos_point is not None and wid == chaos_worker:
                cmd += [
                    "--chaos-point", chaos_point,
                    "--chaos-at", str(chaos_at),
                ]
            err = open(os.path.join(jdir, "worker.stderr.log"), "wb")
            try:
                proc = subprocess.Popen(
                    cmd,
                    stdout=subprocess.PIPE,
                    stderr=err,
                    text=True,
                    env=child_env,
                )
            finally:
                err.close()
            procs.append((wid, jdir, proc))
        for wid, jdir, proc in procs:
            ready = _read_ready_line(proc, wid, jdir, ready_timeout_s)
            workers.append(
                NetWorker(
                    wid,
                    ready["host"],
                    ready["port"],
                    jdir,
                    deadline_s=deadline_s,
                    probe_deadline_s=probe_deadline_s,
                    retries=rpc_retries,
                    stats=stats,
                    process=proc,
                )
            )
        return workers
    except BaseException:
        for _, _, proc in procs:
            try:
                proc.kill()
            except OSError:
                pass
        raise


def _read_ready_line(
    proc, wid, jdir, timeout_s: float,
    log_name: str = "worker.stderr.log",
) -> dict:
    """One JSON handshake line from the child's stdout; a child that
    dies or stalls before it is a launch failure with its stderr tail
    attached — never a hang."""
    import selectors

    deadline = time.monotonic() + timeout_s
    line = ""
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        while time.monotonic() < deadline:
            if sel.select(0.1):
                line = proc.stdout.readline()
                break
            if proc.poll() is not None:
                break
    finally:
        sel.close()
    if not line:
        tail = ""
        try:
            with open(os.path.join(jdir, log_name), "rb") as f:
                tail = f.read()[-800:].decode(errors="replace")
        except OSError:
            pass
        raise ClusterError(
            f"worker {wid!r} never printed its ready line "
            f"(rc={proc.poll()}); stderr tail: {tail}"
        )
    try:
        return json.loads(line)
    except ValueError:
        raise ClusterError(
            f"worker {wid!r} printed a garbled ready line: {line!r}"
        )


class AgentHandle:
    """One launched journal-ship-agent subprocess and its address.
    ``client()`` mints a FRESH ``ShipClient`` — every controller
    mandate (first controller, each takeover) builds its own
    connections and binds them to its own ``net_stats``."""

    def __init__(self, worker_id, root, host, port, process, *,
                 deadline_s: float = 5.0, retries: int = 2):
        self.worker_id = worker_id
        self.root = root
        self.host = host
        self.port = int(port)
        self.process = process
        self.deadline_s = float(deadline_s)
        self.retries = int(retries)

    def client(self, stats=None) -> ShipClient:
        return ShipClient(
            self.host, self.port,
            deadline_s=self.deadline_s, retries=self.retries,
            stats=stats,
        )


def launch_agents(
    roots: dict,
    *,
    chaos_agent=None,
    chaos_point: str | None = None,
    chaos_at: int = 1,
    deadline_s: float = 5.0,
    retries: int = 2,
    max_idle_s: float = 120.0,
    ready_timeout_s: float = 30.0,
) -> dict:
    """Spawn one journal-ship agent per worker host (``roots`` maps
    ``worker_id -> host directory`` — the directory CONTAINING that
    worker's journal dir, i.e. the ``hK`` the private
    ``launch_workers(journal_root=...)`` layout creates) and return
    ``{worker_id: AgentHandle}``.  ``chaos_agent`` names the one agent
    started with ``--chaos-point`` (``mid_ship_send`` — a real sender-
    host death mid-transfer).  Stderr lands in
    ``<host_root>/agent.stderr.log``."""
    child_env = _child_env()
    handles: dict = {}
    procs: list = []
    try:
        for wid, host_root in roots.items():
            os.makedirs(host_root, exist_ok=True)
            cmd = _nice() + [
                sys.executable, "-m", "har_tpu_torch.cli", "serve-agent",
                "--root", host_root,
                "--max-idle-s", str(max_idle_s),
            ]
            if chaos_point is not None and wid == chaos_agent:
                cmd += [
                    "--chaos-point", chaos_point,
                    "--chaos-at", str(chaos_at),
                ]
            err = open(
                os.path.join(host_root, "agent.stderr.log"), "wb"
            )
            try:
                proc = subprocess.Popen(
                    cmd,
                    stdout=subprocess.PIPE,
                    stderr=err,
                    text=True,
                    env=child_env,
                )
            finally:
                err.close()
            procs.append((wid, host_root, proc))
        for wid, host_root, proc in procs:
            ready = _read_ready_line(
                proc, f"agent:{wid}", host_root, ready_timeout_s,
                log_name="agent.stderr.log",
            )
            handles[wid] = AgentHandle(
                wid, host_root, ready["host"], ready["port"], proc,
                deadline_s=deadline_s, retries=retries,
            )
        return handles
    except BaseException:
        for _, _, proc in procs:
            try:
                proc.kill()
            except OSError:
                pass
        raise
