"""Adaptation-loop smoke — the release gate's closed-loop check.

``adapt_smoke()`` runs the WHOLE lifecycle in a couple of seconds on the
CPU mesh, deterministically (FakeClock, seeded streams, training-free
models): a fleet with per-session drift monitors serves in-distribution
traffic, half the fleet's streams then shift (the re-mounted-sensor
scenario at population scale), the trigger escalates, a stub retrainer
produces a candidate, the candidate shadow-scores mirrored live batches,
gates pass, the engine hot-swaps at a dispatch boundary, and probation
closes clean — with ZERO dropped windows and the accounting invariant
(including per-version attribution) intact end to end.

The JAX package's release gate stamps this verdict into its test log;
the port's copy runs the same loop on the host analytic model, so the
two packages' verdicts are equal.
"""

from __future__ import annotations

import numpy as np

from har_tpu_torch.adapt.shadow import ShadowConfig
from har_tpu_torch.adapt.swap import AdaptationConfig, AdaptationEngine
from har_tpu_torch.adapt.trigger import TriggerConfig
from har_tpu_torch.adapt.registry import ModelRegistry
from har_tpu_torch.monitoring import DriftMonitor
from har_tpu_torch.serve import (
    AnalyticDemoModel,
    FakeClock,
    FleetConfig,
    FleetServer,
    synthetic_sessions,
)


def adapt_smoke(
    sessions: int = 12,
    *,
    drift_fraction: float = 0.5,
    rounds: int = 12,
    seed: int = 0,
    registry_root: str | None = None,
) -> dict:
    """One JSON-ready verdict for the drift→retrain→shadow→swap loop.

    ``registry_root=None`` keeps the registry in a temp dir that is
    removed afterwards (the gate wants the verdict, not the artifacts).
    """
    import shutil
    import tempfile

    clock = FakeClock()
    model = AnalyticDemoModel()
    recordings, _ = synthetic_sessions(
        sessions, windows_per_session=rounds, seed=seed
    )
    # population reference stats from the clean pool; the drifted half
    # then re-mounts: +25 offset on every axis, way past z=3
    pool = np.concatenate(recordings)
    ref_mean, ref_std = pool.mean(axis=0), pool.std(axis=0)
    n_drift = int(sessions * drift_fraction)
    server = FleetServer(
        model,
        window=200,
        hop=200,
        smoothing="ema",
        config=FleetConfig(max_sessions=sessions, max_delay_ms=0.0),
        clock=clock,
    )
    for i in range(sessions):
        server.add_session(
            i,
            monitor=DriftMonitor(
                ref_mean, ref_std, halflife=100.0, patience=2
            ),
        )
    tmp = None
    if registry_root is None:
        tmp = registry_root = tempfile.mkdtemp(prefix="har_adapt_smoke_")
    try:
        registry = ModelRegistry(registry_root, clock=clock)
        retrains = {"n": 0}

        def retrainer(job):
            # stub retrain: deterministic same-family refit — numerics
            # identical to the incumbent, so shadow agreement is exact
            # and the smoke's swap is provably decision-neutral
            retrains["n"] += 1
            assert job.replay is not None and len(job.replay) > 0
            return AnalyticDemoModel()

        engine = AdaptationEngine(
            server,
            registry,
            retrainer,
            config=AdaptationConfig(probation_dispatches=2),
            trigger_config=TriggerConfig(
                min_sessions=max(2, n_drift // 2),
                window_s=1e9,
                cooldown_s=1e9,
                recovery_patience=2,
            ),
            shadow_config=ShadowConfig(sample_every=1, min_windows=8),
            clock=clock,
        )

        # round-robin delivery: one 200-sample window per session per
        # round; the drifted half shifts from round 2 on
        cursors = [0] * sessions
        for rnd in range(rounds):
            for i in range(sessions):
                rec = recordings[i]
                chunk = rec[cursors[i] : cursors[i] + 200]
                cursors[i] += 200
                if not len(chunk):
                    continue
                if i < n_drift and rnd >= 2:
                    chunk = chunk + 25.0
                server.push(i, chunk)
            server.poll(force=True)
            engine.step()
            clock.advance(1.0)
        server.flush()
        engine.step()

        snap = server.stats_snapshot()
        acct = snap["accounting"]
        status = engine.status()
        shadow_agreement = None
        for entry in engine.log:
            if entry["event"] == "swapped":
                shadow_agreement = entry["shadow"]["agreement"]
        ok = bool(
            status["swaps"] >= 1
            and status["rollbacks"] == 0
            and retrains["n"] >= 1
            and acct["dropped"] == 0
            and acct["pending"] == 0
            and acct["balanced"]
            and shadow_agreement is not None
            and shadow_agreement >= 0.98
        )
        return {
            "ok": ok,
            "sessions": sessions,
            "drifted_sessions": n_drift,
            "windows": acct["enqueued"],
            "dropped": acct["dropped"],
            "accounting_balanced": bool(
                acct["balanced"] and acct["pending"] == 0
            ),
            "retrains": retrains["n"],
            "swaps": status["swaps"],
            "rollbacks": status["rollbacks"],
            "shadow_agreement": shadow_agreement,
            "serving_version": status["serving_version"],
            "state": status["state"],
            "scored_by_version": snap["scored_by_version"],
        }
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    import json

    print(json.dumps(adapt_smoke()))
