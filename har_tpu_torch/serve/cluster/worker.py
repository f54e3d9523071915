"""One cluster worker: an unmodified FleetServer + its journal,
behind a process-boundary shim.

The worker wrapper is deliberately thin — the whole point of the
cluster design is that a worker is the SAME crash-safe engine the
single-process fleet runs (``FleetServer`` + ``FleetJournal``), so
every per-worker guarantee (conservation law, ack boundary, chaos
matrix) carries over verbatim.  What the wrapper adds is the failure
surface a real process boundary has: once a worker is killed, every
call raises ``WorkerUnavailable`` instead of touching dead state —
which is exactly the evidence the membership layer's failure detector
consumes.

``kill()`` is the in-process SIGKILL model, same stance as the chaos
harness: process memory is gone (the wrapper refuses all further
calls) and the journal drops its un-flushed buffer
(``FleetJournal.kill``) — what is on disk afterwards is exactly what a
real kill would have left.

Port of ``har_tpu/serve/cluster/worker.py`` (copied).
"""

from __future__ import annotations

from typing import Hashable

from har_tpu_torch.serve.cluster.membership import WorkerUnavailable


class ClusterWorker:
    """A FleetServer bound to a worker id and a journal directory."""

    def __init__(self, worker_id, server, journal_dir: str):
        self.worker_id = worker_id
        self.server = server
        self.journal_dir = journal_dir
        self.alive = True

    def _guard(self) -> None:
        if not self.alive:
            raise WorkerUnavailable(
                f"worker {self.worker_id!r} is not responding"
            )

    # ----------------------------------------------------- the "RPCs"

    def heartbeat(self) -> bool:
        """The membership probe: cheap, no fleet state touched."""
        self._guard()
        return True

    def push(self, session_id: Hashable, samples) -> int:
        self._guard()
        return self.server.push(session_id, samples)

    def push_many(self, session_ids, chunks) -> int:
        """Batched multi-session delivery in delivery order —
        semantically a sequence of ``push`` calls
        (``FleetServer.push_many``'s contract), one call instead of N.
        Over the wire this is what collapses a round's N push RPCs
        into one frame."""
        self._guard()
        return self.server.push_many(session_ids, chunks)

    def poll(self, *, force: bool = False) -> list:
        self._guard()
        return self.server.poll(force=force)

    def add_session(self, session_id: Hashable, *, monitor=None) -> None:
        self._guard()
        self.server.add_session(session_id, monitor=monitor)

    def disconnect_session(self, session_id: Hashable) -> list:
        """Graceful churn disconnect: partial-window flush + settle +
        journaled eviction (``FleetServer.disconnect_session``); the
        settle's events are returned to the caller."""
        self._guard()
        return self.server.disconnect_session(session_id)

    def disconnect_sessions(self, session_ids) -> list:
        """Batched graceful disconnect — one settle for the whole
        cohort leaving this worker (``FleetServer.disconnect_sessions``)."""
        self._guard()
        return self.server.disconnect_sessions(session_ids)

    def adopt(self, export: dict) -> None:
        """Adopt a migrated session and make the adopt record durable
        before returning — the target-side half of the hand-off
        protocol's adopt-first ordering.  Idempotent: a retry after a
        failed flush skips the admit and completes the durability."""
        self._guard()
        if export["sid"] not in self.server._sessions:
            self.server.adopt_session(export)
        if self.server.journal is not None:
            self.server.journal.flush()

    def owns(self, session_id: Hashable) -> bool:
        return self.alive and session_id in self.server._sessions

    def watermark(self, session_id: Hashable) -> int:
        self._guard()
        return self.server.watermark(session_id)

    # ------------------------------------------- control-plane surface
    # (the controller speaks ONLY this surface — never
    # ``worker.server.<attr>`` — so the transport-backed twin
    # (har_tpu_torch.serve.net.NetWorker) can implement the same methods as
    # RPCs and the controller stays transport-blind.)

    def export_session(self, session_id: Hashable) -> dict:
        self._guard()
        return self.server.export_session(session_id)

    def evict_session(self, session_id: Hashable) -> None:
        """Source half of a hand-off: journaled eviction + flush (the
        record must be durable before the controller moves on)."""
        self._guard()
        self.server.handoff_session(session_id)
        if self.server.journal is not None:
            self.server.journal.flush()

    def sessions(self) -> tuple:
        return tuple(self.server.sessions)

    def session_count(self) -> int:
        return len(self.server._sessions)

    def generation(self, session_id: Hashable) -> int:
        """The session's ``handoffs`` generation — the dual-ownership
        tie-break a takeover controller sorts by."""
        return int(self.server._sessions[session_id].handoffs)

    def undrained(self) -> list:
        """Sessions with live (queued or in-flight) windows — what a
        planned retire must refuse on."""
        return [
            sid
            for sid in self.server.sessions
            if self.server._sessions[sid].n_live
        ]

    def model_version(self) -> str:
        self._guard()
        return self.server.model_version

    def swap_model(self, model, *, version: str) -> None:
        self._guard()
        if self.server.model_version != version:
            self.server.swap_model(model, version=version)

    def geometry(self) -> dict:
        s = self.server
        return {
            "window": s.window,
            "hop": s.hop,
            "channels": s.channels,
            "smoothing": s.smoothing,
            "target_batch": int(s.config.target_batch),
            "pipeline_depth": int(s.config.pipeline_depth),
        }

    def accounting(self) -> dict:
        return self.server.stats.accounting()

    def final_accounting(self) -> dict:
        """The ledger entry a planned retire commits."""
        return {
            "accounting": self.server.stats.accounting(),
            "scored_by_version": dict(self.server.stats.scored_by_version),
        }

    def control_stats(self) -> dict:
        s = self.server.stats
        return {
            "worker_failovers": s.worker_failovers,
            "migrations": s.migrations,
            "migration_ms": s.migration_ms,
            "sessions": len(self.server._sessions),
        }

    def drift_reports(self) -> list:
        """Every monitored session's latest ``DriftReport`` as
        ``[(sid, report)]`` (monitor-less sessions skipped) — the
        evidence the fleet-global retrain trigger aggregates.  Part of
        the worker surface so the transport twin can ship it
        (``NetWorker.drift_reports`` rides the float64-exact wire
        codec) and ``NetCluster.observe_drift`` stops being refused."""
        self._guard()
        out = []
        for sid in self.server.sessions:
            report = self.server.drift_report(sid)
            if report is not None:
                out.append((sid, report))
        return out

    def note_failover_absorbed(self) -> None:
        self._guard()
        self.server.stats.worker_failovers += 1

    def note_migration_ms(self, ms: float) -> None:
        self._guard()
        self.server.stats.migration_ms += float(ms)

    # ----------------------------------------------------- lifecycle

    def kill(self) -> None:
        """SIGKILL model: refuse all further calls, drop the journal's
        un-flushed buffer.  Idempotent."""
        self.alive = False
        if self.server.journal is not None:
            self.server.journal.kill()

    def close(self) -> None:
        if self.alive and self.server.journal is not None:
            self.server.journal.close()
        self.alive = False
