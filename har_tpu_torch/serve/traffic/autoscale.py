"""Load-adaptive capacity control: a hysteresis/cooldown policy loop
that resizes the fleet online from the signals FleetStats already
exports.

The engine's capacity knobs — ``target_batch``, ``pipeline_depth``, the
dispatch mesh, the cluster's worker count — would otherwise stay frozen
at startup.  This controller closes the loop: it reads the queue
backlog, the dispatch
fill fraction, the dispatch p99 and the shed-rate delta from
``FleetStats``, applies HYSTERESIS (consecutive-evidence streaks, so
one bursty poll never thrashes the mesh) and a COOLDOWN (a resize is a
recompile ladder and a re-shard — they must amortize), and walks a
fixed capacity ladder:

    scale UP    target_batch ×2 ... max → pipeline_depth +1 ... max →
                next mesh rung (``mesh_ladder`` × ``mesh_for``) →
                [cluster] add_worker(rebalance=True)
    scale DOWN  the exact reverse

Every engine-level action lands through ``FleetServer.resize`` — the
dispatch-boundary, zero-drop, journaled resize path, so autoscaling
inherits the whole durability story (a ``mid_resize`` crash recovers
and the controller re-issues).  Cluster-level actions reuse the
cluster's drain → hand-off machinery verbatim: the controller drains the cluster
(the drained events are returned to the drive loop — never swallowed),
then ``add_worker(rebalance=True)`` / ``retire_worker``.

The controller never blocks the hot path: ``step()`` is host-side
arithmetic over counters, called from the serving loop's poll hook
(``drive_trace(on_round=controller.on_round)`` or ``drive_fleet
(on_poll=...)``), and the one thing it does per decision is stage a
resize the next dispatch boundary applies.

Port of ``har_tpu/serve/traffic/autoscale.py`` (copied): ``mesh_for``
builds a ``parallel.mesh.ServingMesh`` for a rung, and ``cluster=``
scales a ``har_tpu_torch.serve.cluster.FleetCluster``'s workers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Thresholds, hysteresis and bounds for a CapacityController.

    Signals (read per step):
      - queue backlog (``stats.queue_depth``, the live gauge —
        ``drive_trace`` fires its on_round hook BEFORE the poll for
        exactly this reason: the poll would drain the backlog the
        controller needs to see): backlog >= ``queue_high`` ×
        target_batch is scale-UP evidence;
      - dispatch fill (``stats.utilization``): fill <= ``util_low``
        with a small backlog is scale-DOWN evidence — as is a fully
        IDLE step (nothing scored since the last one: the fill gauge
        only updates when a batch launches, so a load collapse would
        otherwise freeze it at the last batch's fill and pin capacity
        at the ceiling);
      - dispatch p99 (``stats.dispatch.percentile(99)``) above
        ``p99_high_ms`` is scale-UP evidence;
      - shed delta (``stats.dropped_total`` increased since the last
        step) is scale-UP evidence — the ladder is already paying.

    ``up_after`` / ``down_after`` consecutive evidence steps are needed
    before acting (down is deliberately slower — capacity should be
    shed reluctantly), and ``cooldown_s`` must pass between actions.
    """

    min_target_batch: int = 16
    max_target_batch: int = 256
    min_depth: int = 1
    # the dispatch plane's ticket ring runs depth >= 3: a
    # third in-flight ticket keeps the device busy across a slow host
    # round, so the default ladder now walks one rung past classic
    # double-buffering before it reaches for the mesh
    max_depth: int = 3
    mesh_ladder: tuple = (1,)
    queue_high: float = 1.5
    util_low: float = 0.5
    p99_high_ms: float = float("inf")
    up_after: int = 2
    down_after: int = 4
    cooldown_s: float = 0.5
    # cluster axis (0 = worker scaling off)
    sessions_per_worker_high: int = 0
    sessions_per_worker_low: int = 0
    min_workers: int = 1
    max_workers: int = 8

    def __post_init__(self):
        if self.min_target_batch < 1 or (
            self.max_target_batch < self.min_target_batch
        ):
            raise ValueError("target_batch bounds invalid")
        if self.min_depth < 1 or self.max_depth < self.min_depth:
            raise ValueError("depth bounds invalid")
        if not self.mesh_ladder or list(self.mesh_ladder) != sorted(
            set(int(d) for d in self.mesh_ladder)
        ):
            raise ValueError(
                "mesh_ladder must be ascending unique device counts"
            )
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError("hysteresis streaks must be >= 1")


class CapacityController:
    """The policy loop.  ``server`` mode resizes one FleetServer's
    ``target_batch`` / ``pipeline_depth`` / mesh; give it a ``cluster``
    instead (a FleetCluster) and it scales the worker count, reading
    the same signals aggregated across workers.

    ``mesh_for(devices) -> mesh | None`` builds the mesh for a ladder
    rung (``None`` for rung 1 — back to single-device); required only
    when ``mesh_ladder`` goes past one device.  ``clock`` is the
    injected seconds source the cooldown reads (FakeClock in tests).
    """

    def __init__(
        self,
        server=None,
        *,
        cluster=None,
        config: AutoscaleConfig | None = None,
        mesh_for: Callable | None = None,
        clock: Callable[[], float] | None = None,
    ):
        if (server is None) == (cluster is None):
            raise ValueError(
                "pass exactly one of server= (engine scaling) or "
                "cluster= (worker scaling)"
            )
        self.server = server
        self.cluster = cluster
        self.config = config or AutoscaleConfig()
        self._mesh_for = mesh_for
        self._clock = clock or time.monotonic
        if max(self.config.mesh_ladder) > 1 and mesh_for is None:
            raise ValueError(
                "mesh_ladder goes past one device; pass mesh_for="
            )
        self._mesh_rung = 0  # index into mesh_ladder
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t: float | None = None
        # delta watermarks start at the server's CURRENT totals: a
        # controller attached to a recovered or long-running fleet must
        # not read its whole drop history as one fresh shed burst
        self._last_dropped = (
            0 if server is None else server.stats.dropped_total
        )
        self._last_scored = 0 if server is None else server.stats.scored
        self.actions: list[dict] = []
        self.worker_adds = 0
        self.worker_retires = 0
        # events produced by the controller's own cluster drains — the
        # drive loop folds these into the run's event stream (on_round
        # returns them), so a pre-retire drain never swallows events
        self._drained_events: list = []

    # ------------------------------------------------------- plumbing

    def on_round(self, target, round_index) -> list:
        """The ``drive_trace(on_round=...)`` adapter: one policy step,
        returning any events the step's own drains produced."""
        self.step()
        return self.take_events()

    def take_events(self) -> list:
        out = self._drained_events
        self._drained_events = []
        return out

    def status(self) -> dict:
        return {
            "mode": "cluster" if self.cluster is not None else "engine",
            "actions": len(self.actions),
            "worker_adds": self.worker_adds,
            "worker_retires": self.worker_retires,
            "last_action": self.actions[-1] if self.actions else None,
        }

    # -------------------------------------------------------- signals

    def _signals(self) -> dict:
        if self.cluster is not None:
            servers = [w.server for w in self.cluster._workers.values()]
            n_sessions = sum(len(s.sessions) for s in servers)
            return {
                "workers": len(servers),
                "sessions": n_sessions,
                "per_worker": n_sessions / max(1, len(servers)),
            }
        stats = self.server.stats
        p99 = stats.dispatch.percentile(99)
        dropped = stats.dropped_total
        shed_delta = dropped - self._last_dropped
        self._last_dropped = dropped
        scored_delta = stats.scored - self._last_scored
        self._last_scored = stats.scored
        return {
            "queue_depth": stats.queue_depth,
            "utilization": stats.utilization,
            # nothing scored since the last step: the engine sat fully
            # idle — the utilization gauge is STALE then (it only
            # updates when a batch launches, so a load collapse leaves
            # it frozen at the last batch's fill), and idleness itself
            # is the strongest under-utilization evidence there is
            "idle": scored_delta == 0,
            "p99_ms": p99,
            "shed_delta": shed_delta,
        }

    # -------------------------------------------------------- the loop

    def step(self, now: float | None = None) -> dict | None:
        """One policy step: gather evidence, advance the hysteresis
        streaks, act when a streak crosses its threshold and the
        cooldown has passed.  Returns the action dict, or None."""
        cfg = self.config
        now = self._clock() if now is None else now
        sig = self._signals()
        if self.cluster is not None:
            up = bool(
                cfg.sessions_per_worker_high
                and sig["per_worker"] >= cfg.sessions_per_worker_high
                and sig["workers"] < cfg.max_workers
            )
            down = bool(
                not up
                and cfg.sessions_per_worker_low
                and sig["per_worker"] <= cfg.sessions_per_worker_low
                and sig["workers"] > cfg.min_workers
            )
        else:
            scfg = self.server.config
            up = bool(
                sig["queue_depth"] >= cfg.queue_high * scfg.target_batch
                or (
                    sig["p99_ms"] is not None
                    and sig["p99_ms"] > cfg.p99_high_ms
                )
                or sig["shed_delta"] > 0
            )
            down = bool(
                not up
                and (sig["utilization"] <= cfg.util_low or sig["idle"])
                and sig["queue_depth"] < scfg.target_batch
            )
        self._up_streak = self._up_streak + 1 if up else 0
        self._down_streak = self._down_streak + 1 if down else 0
        if (
            self._last_action_t is not None
            and now - self._last_action_t < cfg.cooldown_s
        ):
            return None
        action = None
        if self._up_streak >= cfg.up_after:
            action = self._scale(+1)
        elif self._down_streak >= cfg.down_after:
            action = self._scale(-1)
        if action is not None:
            action["signals"] = sig
            self._up_streak = 0
            self._down_streak = 0
            self._last_action_t = now
            self.actions.append(action)
        return action

    def _scale(self, direction: int) -> dict | None:
        if self.cluster is not None:
            return self._scale_cluster(direction)
        return self._scale_engine(direction)

    def _scale_engine(self, direction: int) -> dict | None:
        """Walk the capacity ladder one rung: target_batch first (the
        cheap knob — same scorer, one more batch shape at most),
        then pipeline depth, then the mesh.  Scale-down walks the
        exact reverse, so the configuration retraces its own path."""
        cfg = self.config
        scfg = self.server.config
        if direction > 0:
            if scfg.target_batch < cfg.max_target_batch:
                tb = min(scfg.target_batch * 2, cfg.max_target_batch)
                self.server.resize(target_batch=tb)
                return {"action": "up", "knob": "target_batch", "to": tb}
            if scfg.pipeline_depth < cfg.max_depth:
                depth = scfg.pipeline_depth + 1
                self.server.resize(pipeline_depth=depth)
                return {
                    "action": "up", "knob": "pipeline_depth", "to": depth
                }
            if self._mesh_rung < len(cfg.mesh_ladder) - 1:
                self._mesh_rung += 1
                devices = int(cfg.mesh_ladder[self._mesh_rung])
                self.server.resize(
                    mesh=(
                        None if devices <= 1 else self._mesh_for(devices)
                    )
                )
                return {"action": "up", "knob": "mesh", "to": devices}
            return None  # at the ceiling
        if self._mesh_rung > 0:
            self._mesh_rung -= 1
            devices = int(cfg.mesh_ladder[self._mesh_rung])
            self.server.resize(
                mesh=(None if devices <= 1 else self._mesh_for(devices))
            )
            return {"action": "down", "knob": "mesh", "to": devices}
        if self.server.config.pipeline_depth > cfg.min_depth:
            depth = self.server.config.pipeline_depth - 1
            self.server.resize(pipeline_depth=depth)
            return {
                "action": "down", "knob": "pipeline_depth", "to": depth
            }
        if self.server.config.target_batch > cfg.min_target_batch:
            tb = max(
                self.server.config.target_batch // 2,
                cfg.min_target_batch,
            )
            self.server.resize(target_batch=tb)
            return {"action": "down", "knob": "target_batch", "to": tb}
        return None  # at the floor

    def _scale_cluster(self, direction: int) -> dict | None:
        """Worker-count rung: drain first (the hand-off machinery
        refuses live windows BY DESIGN — draining here also means no
        acked-but-undelivered event can sit in controller memory across
        the mid_handoff crash window), keep the drained events for the
        drive loop, then add or retire."""
        cluster = self.cluster
        if direction > 0:
            self._drained_events.extend(cluster.flush())
            wid = cluster.add_worker(rebalance=True)
            self.worker_adds += 1
            return {"action": "up", "knob": "workers", "added": wid}
        # retire the least-loaded worker: its sessions move anyway, so
        # move the fewest
        loads = [
            (len(w.server.sessions), wid)
            for wid, w in cluster._workers.items()
        ]
        loads.sort()
        victim = loads[0][1]
        self._drained_events.extend(cluster.flush())
        moved = cluster.retire_worker(victim)
        self.worker_retires += 1
        return {
            "action": "down",
            "knob": "workers",
            "retired": victim,
            "moved": moved,
        }
