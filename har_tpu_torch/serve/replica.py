"""Warm standby replicas: the tailed journal replayed continuously
through the one recovery code path.

``har_tpu_torch.serve.net.tail`` keeps a byte-faithful, durably-resumable
copy of each live worker's journal on the standby's disk; this module
keeps that copy WARM — a live in-memory ``FleetServer`` rebuilt from
the tailed snapshot and advanced record-by-record through
``har_tpu_torch.serve.recover.apply_record`` as the suffix lands.  The
replica is a streaming validator and a lag gauge, not a second serving
plane: it never attaches a journal, never retires a window to a
client, and failover still restores through the unchanged
``FleetServer.restore`` path — what the standby changes is that the
bytes that path reads are already local and already verified, so the
failover transfer is ~0 and ``ship_ms`` leaves the failover path.

The pieces:

  ``WarmReplica``   one source's replica: rebuilds from the tailed
        snapshot whenever the manifest base rotates (the re-manifest
        boundary), otherwise advances incrementally from per-segment
        byte cursors via ``read_segment_from`` — the same CRC framing
        decides record completeness on the tail as on the worker's own
        disk, so a half-landed chunk can never half-apply;

  ``StandbyAgent``  the per-host loop: one ``cycle()`` tails every
        followed source (``tail_once``), advances every replica, and
        publishes per-source ``replication_lag_records`` /
        ``replication_lag_bytes`` gauges on its ``FleetStats``
        (ephemeral — lag is recomputed by the next cycle, never
        snapshot state).  An unreachable source parks and retries next
        cycle; it never fails the loop;

  ``StandbyHost``   the ``serve-agent --follow`` wrapper: a plain
        ship agent over the standby's staged root (so a downstream can
        ship FROM the standby) interleaved with standby cycles, plus a
        ``standby_status`` RPC exposing the replication section.

A torn-tail note that makes the incremental replay safe: the replica
reads ``.part`` bytes past the durable ship-log offset.  Those bytes
are real source-journal bytes (append-only source, idempotent-by-offset
pull) — a crash-and-resume re-pulls byte-identical content — and the
record CRC framing stops at any half-landed record, so early applies
are applies of records the source durably holds.
"""

from __future__ import annotations

import os
import time
from typing import Callable

from har_tpu_torch.serve.journal import (
    SHIP_LOG,
    JournalError,
    read_segment_from,
)
from har_tpu_torch.serve.net.ship import (
    DEFAULT_CHUNK_BYTES,
    ShipError,
    ShipUnavailable,
    replay_ship_log,
)
from har_tpu_torch.serve.net.tail import (
    LocalShipSource,
    _segment_index,
    finalize_tail,
    manifest_base,
    tail_once,
)
from har_tpu_torch.serve.recover import apply_record, restore_server
from har_tpu_torch.serve.stats import FleetStats

__all__ = [
    "WarmReplica",
    "StandbyAgent",
    "StandbyHost",
    "LocalShipSource",
]


class WarmReplica:
    """One tailed journal directory kept live in memory.  ``advance()``
    is idempotent and cheap when nothing landed; a manifest-base
    rotation (the source snapshotted) triggers a full rebuild from the
    new snapshot — O(state), paid once per ``snapshot_every`` — and
    everything else is an incremental ``apply_record`` walk from
    per-segment byte cursors."""

    def __init__(self, dest: str, loader, *, clock=None):
        self.dest = dest
        self._loader = loader
        self._clock = clock
        self.server = None
        self.base = -1
        self.applied_records = 0
        self.rebuilds = 0
        self.lag_records = 0
        self._cursors: dict[str, int] = {}
        self._model_version = None

    # ------------------------------------------------------- internals

    def _segment_path(self, rel: str) -> str | None:
        """A tailed segment lives as a verified final or a growing
        ``.part`` — same bytes either way, the cursor carries over."""
        final = os.path.join(self.dest, rel)
        if os.path.exists(final):
            return final
        if os.path.exists(final + ".part"):
            return final + ".part"
        return None

    def _rebuild(self, base: int, names) -> None:
        """Re-found the replica on the newest tailed snapshot.  The
        restore replays every VERIFIED final segment (``load_journal``
        never sees a ``.part`` — the suffix ``.log.part`` fails its
        index parse), so cursors start at file-size for finals and at
        zero for the active tail."""
        server = restore_server(
            self.dest,
            self._loader,
            clock=self._clock,
            reattach=False,
            inflight_ship_ok=True,
        )
        self.server = server
        self.base = base
        self.rebuilds += 1
        self._model_version = server.model_version
        self._cursors = {}
        for rel in names:
            if _segment_index(rel) is None:
                continue
            final = os.path.join(self.dest, rel)
            self._cursors[rel] = (
                os.path.getsize(final) if os.path.exists(final) else 0
            )

    # ------------------------------------------------------------- api

    def advance(self) -> dict:
        """Fold everything newly staged into the live replica.
        Returns ``{ready, applied, lag_records, base, rebuilds}``;
        ``ready`` is False until the tail has landed a complete
        verified snapshot (a replica cannot be founded on bytes that
        have not passed their digest)."""
        out = {"ready": False, "applied": 0, "lag_records": 0,
               "base": self.base, "rebuilds": self.rebuilds}
        prog = replay_ship_log(self.dest)
        if prog.manifest is None:
            return out
        names = [e["f"] for e in prog.manifest]
        base = manifest_base(names)
        if self.server is None or base != self.base:
            try:
                self._rebuild(base, names)
            except JournalError:
                # the new snapshot has not fully landed yet: stay on
                # the old founding (or none) and catch up next cycle
                return out
            out["rebuilds"] = self.rebuilds
            out["base"] = self.base
        applied = 0
        segments = sorted(
            (rel for rel in names if _segment_index(rel) is not None),
            key=_segment_index,
        )
        server = self.server
        server._replaying = True
        try:
            for rel in segments:
                path = self._segment_path(rel)
                if path is None:
                    continue
                records, cursor = read_segment_from(
                    path, self._cursors.get(rel, 0)
                )
                for meta, payload in records:
                    apply_record(server, meta, payload)
                self._cursors[rel] = cursor
                applied += len(records)
        finally:
            server._replaying = False
        if applied and server.model_version != self._model_version:
            # a swap record crossed the tail: re-resolve the model the
            # same way restore_server does after its replay
            if callable(self._loader):
                server.model = self._loader(server.model_version)
            self._model_version = server.model_version
        self.applied_records += applied
        self.lag_records = applied
        out.update(ready=True, applied=applied, lag_records=applied,
                   base=self.base)
        return out


class StandbyAgent:
    """Tail-follow a set of live workers into ``<root>/<wid>`` staging
    directories and keep a warm replica of each.  One ``cycle()`` is
    one pass over every source; the controller drives it from its poll
    loop (in-process) or ``StandbyHost`` drives it on a cadence
    (``serve-agent --follow``)."""

    def __init__(
        self,
        root: str,
        sources: dict,
        *,
        loader=None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        chaos: Callable[[str], None] | None = None,
        clock=None,
        stats: FleetStats | None = None,
    ):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.sources = dict(sources)
        self.stats = stats if stats is not None else FleetStats()
        self.replicas: dict[str, WarmReplica] = {}
        self.parked: dict[str, str] = {}
        self.cycles = 0
        self._loader = loader
        self._chunk_bytes = int(chunk_bytes)
        self._chaos = chaos
        self._clock = clock

    def dest(self, wid) -> str:
        return os.path.join(self.root, str(wid))

    def holds(self, wid) -> bool:
        """True when a tail for ``wid`` has durable progress — the
        signal controller placement uses to prefer this standby's
        bytes over a cold ship."""
        return str(wid) in {str(k) for k in self.sources} and (
            os.path.exists(os.path.join(self.dest(wid), SHIP_LOG))
        )

    def cycle(self) -> dict:
        """One tail + advance pass over every followed source.
        Publishes the per-source lag gauges; an unreachable or
        not-yet-snapshotted source parks (recorded in ``parked``) and
        is retried next cycle."""
        self.cycles += 1
        out = {"sources": {}, "lag_records": 0, "lag_bytes": 0}
        for wid, client in self.sources.items():
            dest = self.dest(wid)
            try:
                tailed = tail_once(
                    client, str(wid), dest,
                    chunk_bytes=self._chunk_bytes,
                    chaos=self._chaos, stats=self.stats,
                )
            except (ShipUnavailable, ShipError) as exc:
                self.parked[str(wid)] = str(exc)
                continue
            self.parked.pop(str(wid), None)
            replica = self.replicas.get(str(wid))
            if replica is None:
                replica = WarmReplica(
                    dest, self._loader, clock=self._clock
                )
                self.replicas[str(wid)] = replica
            adv = replica.advance()
            lag_bytes = max(
                0, tailed["manifest_bytes"] - tailed["staged_bytes"]
            )
            self.stats.replication_lag_records[str(wid)] = adv[
                "lag_records"
            ]
            self.stats.replication_lag_bytes[str(wid)] = lag_bytes
            out["sources"][str(wid)] = {
                "tail": tailed, "replica": adv, "lag_bytes": lag_bytes,
            }
            out["lag_records"] += adv["lag_records"]
            out["lag_bytes"] += lag_bytes
        return out

    def finalize(self, wid) -> dict:
        """Failover completion for one (now dead) source: pull the
        missing suffix — zero bytes when the tail was caught up —
        verify every whole-file digest, land ``ship_done``.  Returns
        the transfer accounting; ``out["bytes"]`` IS the
        failover-path transfer."""
        client = self.sources[wid if wid in self.sources else str(wid)]
        return finalize_tail(
            client, str(wid), self.dest(wid),
            chunk_bytes=self._chunk_bytes, chaos=self._chaos,
            stats=self.stats,
        )

    def status(self) -> dict:
        """The standby's observable state; the ``replication`` section
        is the satellite contract the status RPC exposes."""
        replication = {}
        for wid in self.sources:
            wid = str(wid)
            replica = self.replicas.get(wid)
            replication[wid] = {
                "lag_records": self.stats.replication_lag_records.get(
                    wid, 0
                ),
                "lag_bytes": self.stats.replication_lag_bytes.get(
                    wid, 0
                ),
                "base": replica.base if replica else -1,
                "applied_records": (
                    replica.applied_records if replica else 0
                ),
                "rebuilds": replica.rebuilds if replica else 0,
                "ready": bool(replica and replica.server is not None),
                "parked": self.parked.get(wid),
            }
        return {
            "root": self.root,
            "cycles": self.cycles,
            "sources": sorted(str(w) for w in self.sources),
            "replication": replication,
        }

    def close(self) -> None:
        for client in self.sources.values():
            close = getattr(client, "close", None)
            if close is not None:
                close()


class StandbyHost:
    """The ``serve-agent --follow`` process body: a plain ship
    agent over the standby's staged root (the tailed copies are
    themselves shippable — a failover can pull FROM the standby over
    the same protocol) interleaved with standby cycles on a cadence,
    plus a ``standby_status`` RPC returning ``StandbyAgent.status()``.
    Follow mode is NOT engine-free: warming a replica replays records
    through the fleet engine, so this import lives behind the
    ``--follow`` flag in the agent CLI."""

    def __init__(
        self,
        root: str,
        follows: dict,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        cycle_s: float = 0.5,
        loader=None,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    ):
        from har_tpu_torch.serve.net.ship import ShipAgent, ShipClient

        self.agent = ShipAgent(root, host=host, port=port)
        sources = {
            wid: ShipClient(h, p) for wid, (h, p) in follows.items()
        }
        self.standby = StandbyAgent(
            root, sources, loader=loader, chunk_bytes=chunk_bytes
        )
        self.cycle_s = float(cycle_s)
        handlers = self.agent.rpc.handlers  # registered pre-serve

        def standby_status(meta, payload):
            return self.standby.status(), b""

        handlers["standby_status"] = standby_status

    def serve_forever(self, *, max_idle_s: float = 0.0) -> int:
        """RPC steps interleaved with standby cycles.  A cycling
        standby is ACTIVE — idle-orphan reaping only counts RPC
        silence, mirroring the plain agent."""
        agent = self.agent
        next_cycle = 0.0
        try:
            while not agent._shutdown:
                agent.rpc.step(min(0.05, self.cycle_s))
                now = time.monotonic()
                if now >= next_cycle:
                    self.standby.cycle()
                    next_cycle = now + self.cycle_s
                if (
                    max_idle_s
                    and now - agent.rpc.last_activity > max_idle_s
                ):
                    return 2
            return 0
        finally:
            self.close()

    def close(self) -> None:
        self.standby.close()
        self.agent.close()
