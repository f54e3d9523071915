"""Edge admission for the ingest gateway — shed from the header.

The gateway sits between untrusted client connections and the fleet's
workers.  Its admission control runs BEFORE a frame's payload is
assembled or decoded (``FrameBuffer.peek_header`` /
``FrameBuffer.skip_frame``): the batched push frame's header already
carries everything a shed decision needs —

  - ``s``     the session count in the frame (chunk-batch codec);
  - the declared payload byte length (the frame's own length field);
  - ``wm``    the client's sample watermark — how far its stream has
              advanced; a frame whose watermark lags the newest one
              seen on the connection is STALE traffic (a catch-up
              replay of data whose scoring window has passed);
  - ``tn``    the client/tenant identity.  When the gateway is
              configured with a tenant table, a frame whose tenant is
              missing or unknown is a PROTOCOL VIOLATION, not a shed:
              the connection hangs up with no receipt and no ledger
              trace (``TenantViolation`` — the same fate as a CRC
              mismatch; an unauthenticated sender learns nothing).

A refused frame costs the edge exactly one header parse: no payload
bytes object, no numpy array, no arena reservation, no worker RPC.
The refusal is DECLARED — the client gets a ``{"shed": reason}``
response addressed to its request id and keeps its delivery cursors,
so every sample it sent is either refused-with-a-receipt at the edge
or lands in the fleet's window accounting.  Zero undeclared drops is
the test-pinned contract.

The shed LADDER mirrors the engine's own (pressure escalates, recovery
de-escalates) and is walked PER TENANT: each tenant's thresholds are
its weighted fair share of the gateway's backlog budget
(``weight / sum(weights)`` of ``soft_backlog`` / ``hard_backlog``), and
the ladder judges the tenant's OWN backlog contribution against them —

  level 0  (tenant backlog < its soft share)   admit everything within
           the static bounds (frame sessions / bytes / max staleness);
  level 1  (tenant backlog >= its soft share)  additionally refuse ANY
           frame whose watermark lags the tenant's newest — under
           pressure, stale catch-up traffic is the first to go;
  level 2  (tenant backlog >= its hard share)  refuse every push frame
           from that tenant until its backlog drains.

Weighted fairness falls out of the shares: a storming tenant crosses
ITS OWN hard share while a quiet protected tenant (the paper's
monitored-patient cohort, weighted high) stays at level 0 — the storm
is shed before the quiet tenant ever sees backpressure, and the sum of
all shares caps the total backlog at exactly the old global bound.
With no tenant table (single-tenant mode) every frame lands on one
default slice whose share is 1.0 — bit-identical to the pre-tenant
ladder.

The ledger (``snapshot()``) carries a per-tenant slice beside the
globals; the slices sum to the global counters in every snapshot, so
the edge conservation law holds per tenant and in total.

Engine-free by design: this module imports nothing from the serving
engine (``wire`` is the frame codec, itself engine-free), so the
gateway's admission path stays importable (and testable) without a
model behind it.

Port of ``har_tpu/serve/net/ingest.py`` (stdlib, copied): the same
decisions and ledger as the JAX package's on the same headers.
"""

from __future__ import annotations

import dataclasses
import math

from har_tpu_torch.serve.net.wire import FrameError

# the slice unidentified traffic lands on when no tenant table is
# configured (single-tenant mode): one tenant, share 1.0, so the
# per-tenant ladder degenerates to the global one bit-identically
DEFAULT_TENANT = "default"


class TenantViolation(FrameError):
    """Missing/unknown tenant id on a data frame while a tenant table
    is configured: a protocol violation, not a shed — the server hangs
    up the connection with no receipt and no ledger trace (FrameError's
    fate in the RpcServer), exactly like a CRC mismatch."""


@dataclasses.dataclass(frozen=True)
class IngestConfig:
    """Edge-admission bounds.  Defaults are sized for the loopback
    smoke fleets; a production gateway tunes them to its workers'
    ``max_queue_windows``."""

    # backlog ladder thresholds, in outstanding (enqueued-but-not-yet-
    # returned) windows across the fleet the gateway fronts; each
    # tenant's ladder runs on its weighted share of these
    soft_backlog: int = 4096
    hard_backlog: int = 16384
    # static per-frame bounds, enforceable at any ladder level
    max_frame_sessions: int = 4096
    # a SOFT byte ceiling below wire.MAX_FRAME_BYTES: past the wire
    # ceiling the connection dies (protocol violation); past this one
    # the frame is shed with a receipt (a well-formed but oversized
    # burst)
    max_frame_bytes: int = 8 << 20
    # how many samples a frame's watermark may lag the connection's
    # newest before it is stale (level 0; level 1 tightens this to 0)
    max_watermark_lag: int = 4096
    # the tenant table: ((tenant_id, weight), ...).  Empty = identity
    # not enforced, everything accounted on the default slice.  A
    # higher weight is a larger fair share of the backlog budget — the
    # protected monitored-patient cohort rides a high weight
    tenants: tuple = ()


def _fresh_slice() -> dict:
    return {
        "backlog": 0,
        "latest_wm": 0,
        "admitted_frames": 0,
        "admitted_sessions": 0,
        "admitted_bytes": 0,
        "shed_frames": 0,
        "shed_sessions": 0,
        "shed_bytes": 0,
        "shed_by_reason": {},
    }


class EdgeAdmission:
    """The gateway's per-tenant shed ladder + its accounting.

    ``admit(meta, payload_len)`` returns ``None`` to admit or a shed
    reason string (raising ``TenantViolation`` for unidentified frames
    when a tenant table is configured); it reads ONLY the frame header.
    The backlog each ladder rides is the gateway's own estimate —
    ``note_enqueued`` on every admitted round's enqueued windows,
    ``note_retired`` on every event returned, both tenant-attributed —
    resynced to the fleet's true pending count whenever the gateway
    reads ``accounting()`` (engine-side declared sheds shrink the real
    backlog without passing through the gateway).

    ``stats`` (optionally a ``FleetStats``) receives the per-tenant
    accept/shed counters (``note_tenant_accept`` / ``note_tenant_shed``)
    so the fleet's persisted observability carries the edge's identity
    axis too.
    """

    def __init__(self, config: IngestConfig | None = None, *, stats=None):
        self.config = config or IngestConfig()
        self.stats = stats
        self.tenants = {
            str(t): float(w) for t, w in (self.config.tenants or ())
        }
        total = sum(self.tenants.values())
        self._share = {
            t: (w / total if total > 0 else 1.0)
            for t, w in self.tenants.items()
        }
        self.backlog = 0
        self.latest_wm = 0
        self.admitted_frames = 0
        self.admitted_sessions = 0
        self.admitted_bytes = 0
        self.shed_frames = 0
        self.shed_sessions = 0
        self.shed_bytes = 0
        self.shed_by_reason: dict[str, int] = {}
        self._per_tenant: dict[str, dict] = {}

    # -------------------------------------------------------- identity

    def resolve_tenant(self, meta: dict) -> str:
        """The frame's tenant id, validated against the table.  Without
        a table, identity is not enforced (missing id lands on the
        default slice); with one, an absent or unknown id raises
        ``TenantViolation`` — the RpcServer hangs the connection up
        with no receipt."""
        tid = meta.get("tn")
        if not self.tenants:
            return DEFAULT_TENANT if tid is None else str(tid)
        if tid is None or str(tid) not in self.tenants:
            raise TenantViolation(f"unknown tenant {tid!r}")
        return str(tid)

    def _slice(self, tenant: str) -> dict:
        s = self._per_tenant.get(tenant)
        if s is None:
            s = self._per_tenant[tenant] = _fresh_slice()
        return s

    def _thresholds(self, tenant: str) -> tuple[int, int]:
        """(soft, hard) for this tenant: its weighted fair share of the
        global budget, never below one window (a zero-share ladder
        would refuse a tenant's very first frame)."""
        share = self._share.get(tenant, 1.0)
        cfg = self.config
        return (
            max(1, math.ceil(cfg.soft_backlog * share)),
            max(1, math.ceil(cfg.hard_backlog * share)),
        )

    # ------------------------------------------------------- pressure

    @property
    def level(self) -> int:
        if self.backlog >= self.config.hard_backlog:
            return 2
        if self.backlog >= self.config.soft_backlog:
            return 1
        return 0

    def tenant_level(self, tenant: str) -> int:
        soft, hard = self._thresholds(tenant)
        backlog = self._slice(tenant)["backlog"]
        if backlog >= hard:
            return 2
        if backlog >= soft:
            return 1
        return 0

    def note_enqueued(self, n_windows: int, tenant: str | None = None) -> None:
        n = int(n_windows)
        self.backlog += n
        self._slice(tenant or DEFAULT_TENANT)["backlog"] += n

    def note_retired(self, n_events: int, tenant: str | None = None) -> None:
        n = int(n_events)
        self.backlog = max(0, self.backlog - n)
        ts = self._slice(tenant or DEFAULT_TENANT)
        ts["backlog"] = max(0, ts["backlog"] - n)

    def resync_backlog(self, pending: int) -> None:
        """Pin the estimate to the fleet's true pending count (from
        ``accounting()``): engine-side declared sheds retire windows
        the gateway never sees come back as events.  The per-tenant
        backlog estimates rescale proportionally — the fleet's pending
        count carries no tenant attribution, so the gateway's own
        attribution ratio is the best available prior."""
        pending = max(0, int(pending))
        total = sum(s["backlog"] for s in self._per_tenant.values())
        if total > 0:
            scaled = 0
            largest = max(
                self._per_tenant.values(), key=lambda s: s["backlog"]
            )
            for s in self._per_tenant.values():
                s["backlog"] = (s["backlog"] * pending) // total
                scaled += s["backlog"]
            largest["backlog"] += pending - scaled
        self.backlog = pending

    # ------------------------------------------------------ admission

    def admit(self, meta: dict, payload_len: int) -> str | None:
        """Header-only admission for one batched push frame, judged on
        the frame's TENANT ladder.  The checks run cheapest-first; the
        FIRST breached bound names the shed (one declared reason per
        refused frame)."""
        cfg = self.config
        tenant = self.resolve_tenant(meta)
        ts = self._slice(tenant)
        sessions = int(meta.get("s", 0))
        wm = int(meta.get("wm", ts["latest_wm"]))
        tlevel = self.tenant_level(tenant)
        reason = None
        if sessions > cfg.max_frame_sessions:
            reason = "frame_sessions"
        elif payload_len > cfg.max_frame_bytes:
            reason = "frame_bytes"
        elif tlevel >= 2:
            reason = "hard_backlog"
        else:
            lag = ts["latest_wm"] - wm
            allowed = 0 if tlevel >= 1 else cfg.max_watermark_lag
            if lag > allowed:
                reason = "stale" if tlevel == 0 else "soft_backlog"
        if reason is not None:
            self.shed_frames += 1
            self.shed_sessions += sessions
            self.shed_bytes += int(payload_len)
            self.shed_by_reason[reason] = (
                self.shed_by_reason.get(reason, 0) + 1
            )
            ts["shed_frames"] += 1
            ts["shed_sessions"] += sessions
            ts["shed_bytes"] += int(payload_len)
            ts["shed_by_reason"][reason] = (
                ts["shed_by_reason"].get(reason, 0) + 1
            )
            if self.stats is not None:
                self.stats.note_tenant_shed(tenant)
            return reason
        ts["latest_wm"] = max(ts["latest_wm"], wm)
        self.latest_wm = max(self.latest_wm, wm)
        self.admitted_frames += 1
        self.admitted_sessions += sessions
        self.admitted_bytes += int(payload_len)
        ts["admitted_frames"] += 1
        ts["admitted_sessions"] += sessions
        ts["admitted_bytes"] += int(payload_len)
        if self.stats is not None:
            self.stats.note_tenant_accept(tenant)
        return None

    # ------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """The edge ledger: globals plus a per-tenant slice.  The
        slices' admitted_* / shed_* counters sum to the globals in
        every snapshot — the conservation law holds per tenant and in
        total (test-pinned)."""
        return {
            "level": self.level,
            "backlog": self.backlog,
            "admitted_frames": self.admitted_frames,
            "admitted_sessions": self.admitted_sessions,
            "admitted_bytes": self.admitted_bytes,
            "shed_frames": self.shed_frames,
            "shed_sessions": self.shed_sessions,
            "shed_bytes": self.shed_bytes,
            "shed_by_reason": dict(self.shed_by_reason),
            "tenants": {
                t: {
                    **{
                        k: (dict(v) if isinstance(v, dict) else v)
                        for k, v in s.items()
                    },
                    "level": self.tenant_level(t),
                }
                for t, s in self._per_tenant.items()
            },
        }
