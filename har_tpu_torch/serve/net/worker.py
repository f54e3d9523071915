"""``serve-worker`` — one FleetServer as an OS process on a socket.

The worker is the SAME crash-safe engine the in-process cluster runs
(an unmodified ``FleetServer`` + journal); this module only puts a
real process boundary around it: a loopback TCP listener serving the
``ClusterWorker`` surface as RPCs, a REAL monotonic clock (no FakeClock
— deadlines and lease math run on actual time), and a real exit path
(``--chaos-point`` installs a kill plan that ``os._exit``s at the
chosen journal stage boundary — a genuine SIGKILL: the un-flushed
journal suffix is genuinely lost, not simulated lost).

Startup handshake: the worker imports its whole scoring stack (torch,
the engine, the dispatch plane, the pool's models) and scores one
warm-up window through each pool model BEFORE it binds; then it prints
ONE JSON line ``{"worker_id", "host", "port", "pid"}`` to stdout and
flushes — the launcher reads it to learn the ephemeral port.  A worker
that has announced itself answers its first RPC without an import on
the way, so a controller's deadlines never race the worker's start.  ``--max-idle-s`` exits
the process when no RPC arrives for that long, so an orphaned worker
(its controller test died) cannot outlive the suite.

The model comes from a named POOL (``--model demo``), not a pickle over
the wire: ``swap_model`` RPCs carry only the version string and the
worker resolves it locally — the same stance the journal takes (models
are runtime resources, records carry versions).

Port of ``har_tpu/serve/net/worker.py``; ``python -m
har_tpu_torch.serve.net.worker`` and ``python -m har_tpu_torch.cli
serve-worker`` run ``main``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from har_tpu_torch.serve.net import wire
from har_tpu_torch.serve.net.rpc import RpcServer

# the named model pools a worker can serve.  "demo" matches the chaos
# harness's swap schedule: version A is the analytic demo model,
# version B its tau=5.0 variant — the same pair every in-process
# matrix run scores with, so wire runs stay bit-comparable.
_MODEL_POOLS = ("demo",)


def model_pool(spec: str) -> dict:
    if spec not in _MODEL_POOLS:
        raise ValueError(
            f"unknown model pool {spec!r}; choose from {_MODEL_POOLS}"
        )
    from har_tpu_torch.serve.loadgen import AnalyticDemoModel

    return {"A": AnalyticDemoModel(), "B": AnalyticDemoModel(tau=5.0)}


class _HardKillPlan:
    """Journal chaos hook for a subprocess worker: at the ``at``-th hit
    of ``point``, ``os._exit`` — the kernel reclaims the process with
    the journal buffer un-flushed, exactly what a SIGKILL leaves."""

    def __init__(self, point: str, at: int):
        self.point = point
        self.at = int(at)
        self.hits = 0

    def __call__(self, point: str) -> None:
        if point != self.point:
            return
        self.hits += 1
        if self.hits == self.at:
            os._exit(137)


class WorkerHost:
    """One FleetServer behind an RpcServer.

    The handler table DELEGATES to a local ``ClusterWorker`` wrapped
    around the engine — the same object the in-process control plane
    drives — so the wire worker cannot drift from the in-process
    contract: every handler is codec + one shim call, and the shim is
    the single place the surface's semantics (evict's flush ordering,
    the undrained definition, adopt idempotence) live.
    """

    def __init__(
        self,
        worker_id: str,
        server,
        *,
        journal_dir: str | None = None,
        models: dict | None = None,
        host="127.0.0.1",
        port=0,
    ):
        from har_tpu_torch.serve.cluster.worker import ClusterWorker

        self.worker_id = worker_id
        self.server = server
        self.shim = ClusterWorker(
            worker_id, server, journal_dir or ""
        )
        # version -> model, what swap RPCs resolve against (models are
        # runtime resources; only version strings cross the wire)
        self._models = dict(models or {})
        self._shutdown = False
        self.rpc = RpcServer(
            self._handlers(), host=host, port=port, stats=server.stats
        )

    # ------------------------------------------------------- handlers

    def _handlers(self) -> dict:
        s = self.server
        shim = self.shim

        def ok(meta=None, payload=b""):
            return dict(meta or {}), payload

        def heartbeat(meta, payload):
            shim.heartbeat()
            return ok()

        def push(meta, payload):
            n = shim.push(meta["sid"], wire.decode_samples(meta, payload))
            return ok({"r": int(n)})

        def push_many(meta, payload):
            # one frame per delivery round: the chunk-batch codec's
            # sample arrays are zero-copy views over the received
            # payload; the engine stages them straight into its
            # reserved StagingArena slots in delivery order
            items = wire.decode_chunk_batch(meta, payload)
            n = shim.push_many(
                [sid for sid, _ in items], [c for _, c in items]
            )
            return ok({"r": int(n)})

        def poll(meta, payload):
            events = shim.poll(force=bool(meta.get("force")))
            return wire.encode_events(events)

        def add_session(meta, payload):
            from har_tpu_torch.serve.journal import monitor_from_state

            shim.add_session(
                meta["sid"],
                monitor=monitor_from_state(meta.get("mon")),
            )
            return ok()

        def disconnect(meta, payload):
            events = shim.disconnect_sessions(meta["sids"])
            return wire.encode_events(events)

        def adopt(meta, payload):
            shim.adopt(wire.decode_export(meta, payload))
            return ok()

        def export(meta, payload):
            return wire.encode_export(shim.export_session(meta["sid"]))

        def evict(meta, payload):
            shim.evict_session(meta["sid"])
            return ok()

        def owns(meta, payload):
            return ok({"r": shim.owns(meta["sid"])})

        def watermark(meta, payload):
            return ok({"r": int(shim.watermark(meta["sid"]))})

        def swap(meta, payload):
            version = meta["ver"]
            if shim.model_version() != version:
                model = self._models.get(version)
                if model is None:
                    raise ValueError(
                        f"version {version!r} not in this worker's "
                        f"model pool {sorted(self._models)}"
                    )
                shim.swap_model(model, version=version)
            return ok({"r": shim.model_version()})

        def model_version(meta, payload):
            return ok({"r": shim.model_version()})

        def resize(meta, payload):
            # not part of the ClusterWorker surface (the elastic
            # controller drives resize through FleetServer directly)
            if s.config.target_batch != int(meta["tb"]):
                s.resize(target_batch=int(meta["tb"]))
            return ok({"r": int(s.config.target_batch)})

        def geometry(meta, payload):
            return ok(shim.geometry())

        def accounting(meta, payload):
            return ok({"r": shim.accounting()})

        def final_accounting(meta, payload):
            return ok(shim.final_accounting())

        def control_stats(meta, payload):
            return ok(shim.control_stats())

        def sessions(meta, payload):
            return ok({"r": list(shim.sessions())})

        def generation(meta, payload):
            return ok({"r": shim.generation(meta["sid"])})

        def undrained(meta, payload):
            return ok({"r": shim.undrained()})

        def drift_reports(meta, payload):
            return wire.encode_drift_reports(shim.drift_reports())

        def note_failover_absorbed(meta, payload):
            shim.note_failover_absorbed()
            return ok()

        def note_migration_ms(meta, payload):
            shim.note_migration_ms(float(meta["ms"]))
            return ok()

        def stats_snapshot(meta, payload):
            return ok({"r": s.stats_snapshot()})

        def shutdown(meta, payload):
            self._shutdown = True
            return ok()

        return {
            "heartbeat": heartbeat,
            "push": push,
            "push_many": push_many,
            "poll": poll,
            "add_session": add_session,
            "disconnect": disconnect,
            "adopt": adopt,
            "export": export,
            "evict": evict,
            "owns": owns,
            "watermark": watermark,
            "swap": swap,
            "model_version": model_version,
            "resize": resize,
            "geometry": geometry,
            "accounting": accounting,
            "final_accounting": final_accounting,
            "control_stats": control_stats,
            "sessions": sessions,
            "generation": generation,
            "undrained": undrained,
            "drift_reports": drift_reports,
            "note_failover_absorbed": note_failover_absorbed,
            "note_migration_ms": note_migration_ms,
            "stats_snapshot": stats_snapshot,
            "shutdown": shutdown,
        }

    # ----------------------------------------------------------- loop

    def serve_forever(self, *, max_idle_s: float = 0.0) -> int:
        try:
            while not self._shutdown:
                self.rpc.step(0.05)
                if (
                    max_idle_s
                    and time.monotonic() - self.rpc.last_activity
                    > max_idle_s
                ):
                    return 2  # orphaned: controller went away
            return 0
        finally:
            self.close()

    def close(self) -> None:
        self.rpc.close()
        if self.server.journal is not None:
            try:
                self.server.journal.close()
            except OSError:
                pass


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="serve-worker",
        description=(
            "one FleetServer worker process on a loopback socket "
            "(har_tpu_torch.serve.net) — launched by `serve --workers N "
            "--net`; imports and warms its scoring stack, prints one "
            "JSON ready line {worker_id, host, port, pid} and serves "
            "the cluster RPC surface until shutdown or idle timeout"
        ),
    )
    ap.add_argument("--worker-id", required=True)
    ap.add_argument("--journal", required=True,
                    help="this worker's journal directory (the failover "
                         "currency: the controller restores it on death)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 = ephemeral; the ready line reports it")
    ap.add_argument("--model", default="demo", choices=list(_MODEL_POOLS))
    ap.add_argument("--window", type=int, default=200)
    ap.add_argument("--hop", type=int, default=200)
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--smoothing", default="ema",
                    choices=["ema", "vote", "none"])
    ap.add_argument("--max-sessions", type=int, default=4096)
    ap.add_argument("--target-batch", type=int, default=32)
    ap.add_argument("--max-delay-ms", type=float, default=0.0)
    ap.add_argument("--retries", type=int, default=1)
    ap.add_argument("--flush-every", type=int, default=512)
    ap.add_argument("--snapshot-every", type=int, default=40)
    ap.add_argument("--resume", action="store_true",
                    help="restore the fleet from --journal instead of "
                         "attaching fresh (worker process restart)")
    ap.add_argument("--max-idle-s", type=float, default=120.0,
                    help="exit when no RPC arrives for this long "
                         "(orphan protection); 0 disables")
    ap.add_argument("--chaos-point", default=None,
                    help="TESTING: os._exit(137) at the Nth hit of this "
                         "journal stage boundary — a REAL process kill "
                         "at a chosen kill point")
    ap.add_argument("--chaos-at", type=int, default=1)
    return ap


def _warm_up(models: dict, *, window: int, channels: int,
             smoothing: str) -> None:
    """Score one window through each pool model on a throwaway,
    journal-less engine: the scoring stack is imported and has run once
    before the ready line goes out."""
    import numpy as np

    from har_tpu_torch.serve.engine import FleetConfig, FleetServer

    for version, model in models.items():
        probe = FleetServer(
            model, window=window, hop=window, channels=channels,
            smoothing=smoothing,
            config=FleetConfig(max_sessions=1, max_delay_ms=0.0),
        )
        probe.add_session(0)
        probe.push(0, np.zeros((window, channels), np.float32))
        if len(probe.flush()) != 1:
            raise RuntimeError(
                f"warm-up of model {version!r} scored no window"
            )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from har_tpu_torch.serve.engine import FleetConfig, FleetServer
    from har_tpu_torch.serve.journal import JournalConfig

    models = model_pool(args.model)
    _warm_up(models, window=args.window, channels=args.channels,
             smoothing=args.smoothing)
    journal_config = JournalConfig(
        flush_every=args.flush_every, snapshot_every=args.snapshot_every
    )
    if args.resume:
        server = FleetServer.restore(
            args.journal,
            lambda ver: models.get(ver, models["A"]),
            journal_config=journal_config,
        )
    else:
        server = FleetServer(
            models["A"],
            window=args.window,
            hop=args.hop,
            channels=args.channels,
            smoothing=args.smoothing,
            config=FleetConfig(
                max_sessions=args.max_sessions,
                target_batch=args.target_batch,
                max_delay_ms=args.max_delay_ms,
                retries=args.retries,
            ),
            model_version="A",
            journal=args.journal,
            journal_config=journal_config,
        )
    if args.chaos_point:
        server.journal.chaos = _HardKillPlan(
            args.chaos_point, args.chaos_at
        )
    host = WorkerHost(
        args.worker_id, server, journal_dir=args.journal,
        models=models, host=args.host, port=args.port,
    )
    print(
        json.dumps(
            {
                "worker_id": args.worker_id,
                "host": host.rpc.host,
                "port": host.rpc.port,
                "pid": os.getpid(),
            }
        ),
        flush=True,
    )
    return host.serve_forever(max_idle_s=args.max_idle_s)


if __name__ == "__main__":  # pragma: no cover - subprocess entrypoint
    sys.exit(main())
