"""``NetCluster`` — the FleetCluster control plane over real sockets.

The controller logic is INHERITED, not rewritten: ``FleetCluster``
already speaks only the worker surface, so running over the wire is
"construct it with ``NetWorker``s".  What this subclass adds is the
transport's bookkeeping:

  - ``net_stats`` — one ``FleetStats`` receiving the controller-side
    transport counters (``rpc_sent`` / ``rpc_retries`` /
    ``rpc_bytes_tx/rx`` + the ``rpc_rtt`` histogram) from every
    worker's RPC client;
  - ``observe_drift`` over the wire: per-session ``DriftReport``s
    pulled from every live worker (the ``drift_reports`` RPC) into the
    one fleet-global RetrainTrigger;
  - worker-process lifecycle helpers (``shutdown_workers``).

FAILOVER reads the dead worker's journal from the shared disk (the
loopback single-box deployment); the per-session hand-offs ride the
``adopt`` RPC.  Death needs REFUSED connections — ``WorkerTimeout``
never strikes — so a live-but-slow worker is never restored out from
under itself.

``launch_workers`` spawns ``serve-worker`` OS subprocesses
(``python -m har_tpu_torch.serve.net.worker``) on loopback ephemeral
ports and wraps them in ``NetWorker``s.  The ready handshake is one
JSON line on the child's stdout, printed once the worker's scoring
stack is imported and warm.

Port of ``har_tpu/serve/net/controller.py`` over the shared disk.  The
JAX package's shared-nothing failover (journal-ship agents:
``agents=``, ``register_agent``, ``launch_agents``) waits for ROADMAP.md
Queue 1 item 15 and raises NotImplementedError.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from har_tpu_torch.serve.cluster.controller import ClusterError, FleetCluster
from har_tpu_torch.serve.cluster.membership import WorkerUnavailable
from har_tpu_torch.serve.net.client import NetWorker
from har_tpu_torch.serve.stats import FleetStats

_SHIP_WAITS = (
    "the journal-ship agents of a shared-nothing NetCluster are not "
    "ported yet: ROADMAP.md Queue 1 item 15"
)


class NetCluster(FleetCluster):
    """FleetCluster over NetWorkers.  Construct with
    ``_workers=[NetWorker, ...]`` (``launch_workers`` builds them);
    the positional in-process construction path is refused."""

    def __init__(self, model, root, *args, agents: dict | None = None,
                 **kwargs):
        if agents:
            raise NotImplementedError(f"NetCluster(agents=...): {_SHIP_WAITS}")
        if kwargs.get("_workers") is None:
            raise ClusterError(
                "NetCluster needs _workers=[NetWorker, ...] — spawn "
                "them with har_tpu_torch.serve.net.launch_workers (or "
                "`serve-worker`)"
            )
        # the transport counters first: the base constructor already
        # adopts workers, and _adopt_worker binds them
        self.net_stats = FleetStats()
        super().__init__(model, root, *args, **kwargs)

    def _adopt_worker(self, worker) -> None:
        super()._adopt_worker(worker)
        # workers attached after construction (takeover, scale-up)
        # join the shared transport counters too
        stats = getattr(self, "net_stats", None)
        if stats is not None:
            worker.bind_stats(stats)

    def register_agent(self, worker_id, client) -> None:
        """The JAX package's (re)binding of a worker host's ship agent."""
        raise NotImplementedError(f"NetCluster.register_agent: {_SHIP_WAITS}")

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
        """Controller-side RPC counters: calls, retries, bytes, rtt.
        The JAX package's journal-ship and warm-standby keys stay, at
        0: this controller reads the shared disk (item 15)."""
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
            "ship_ms": 0.0,
            "failover_path_bytes": 0,
            "standby_fetches": 0,
            "standbys": 0,
        }

    # ------------------------------------------------------ lifecycle

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
    env: dict | None = None,
    nice: int = 0,
) -> list[NetWorker]:
    """Spawn ``n`` ``serve-worker`` subprocesses on loopback ephemeral
    ports and return their ``NetWorker`` proxies.

    Each worker journals under ``root/wK`` (the shared-disk deployment
    — the controller can restore the directory in place).
    ``chaos_worker`` names the one worker started with
    ``--chaos-point``.  ``env`` adds variables to the children's
    environment, and ``nice`` lowers their scheduling priority by that
    increment (each child starts under ``nice -n``, before it imports
    anything).  Each child's stderr is captured to
    ``<journal_dir>/worker.stderr.log``; a child that exits or stays
    silent past ``ready_timeout_s`` raises ``ClusterError`` with its
    id and stderr tail, after every child is killed."""
    os.makedirs(root, exist_ok=True)
    # the children import this package from where this file lives,
    # whatever the caller's working directory
    here = os.path.dirname(os.path.abspath(__file__))
    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    path = os.environ.get("PYTHONPATH")
    child_env = {
        **os.environ,
        "PYTHONPATH": pkg_parent + (os.pathsep + path if path else ""),
        **(env or {}),
    }
    workers: list[NetWorker] = []
    procs: list[tuple[str, str, subprocess.Popen]] = []
    try:
        for i in range(int(n)):
            wid = f"w{i}"
            jdir = os.path.join(root, wid)
            os.makedirs(jdir, exist_ok=True)
            cmd = (["nice", "-n", str(nice)] if nice else []) + [
                sys.executable, "-m", "har_tpu_torch.serve.net.worker",
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


def launch_agents(roots: dict, **kwargs) -> dict:
    """The JAX package's per-host journal-ship agents."""
    raise NotImplementedError(f"launch_agents: {_SHIP_WAITS}")
