"""Fleet equivalence + SLO smoke — the release gate's serving check.

``fleet_slo_smoke()`` runs in a few seconds on the CPU mesh and proves
the two properties the fleet engine ships on:

  1. equivalence — every fleet-multiplexed session's events are
     bit-identical (latency fields excepted) to an independent
     ``StreamingClassifier`` replaying the same delivery chunks;
  2. SLO — at nominal load, zero dropped windows and the accounting
     invariant (enqueued == scored + dropped) holds.

``scripts/release_gate.py`` runs it after a green suite and stamps
``{sessions, p99_ms, dropped}`` into ``artifacts/test_gate.json`` — the
serving counterpart of the published test counts: generated from a run,
never typed.

Port of ``har_tpu/serve/slo.py``.  Its meshes are single-controller
``parallel.mesh.ServingMesh``es: distinct visible cards on CUDA, or the
CPU repeated where a caller passes such a mesh (``mesh=``), as the JAX
package's dry-run mesh splits the host.
"""

from __future__ import annotations

import numpy as np

from har_tpu_torch.serve.engine import FleetConfig, FleetServer
from har_tpu_torch.serve.loadgen import (
    AnalyticDemoModel,
    drive_fleet,
    synthetic_sessions,
)
from har_tpu_torch.serving import StreamingClassifier


def events_equal(fleet_event, independent_event) -> bool:
    """Bit-identical on every decision field; latency fields excluded —
    they measure the engines, not the decisions."""
    a, b = fleet_event, independent_event
    return (
        a.t_index == b.t_index
        and a.label == b.label
        and a.raw_label == b.raw_label
        and a.drift == b.drift
        and np.array_equal(a.probability, b.probability)
    )


def fleet_slo_smoke(
    sessions: int = 128,
    *,
    windows_per_session: int = 2,
    hop: int = 200,
    smoothing: str = "ema",
    seed: int = 0,
) -> dict:
    """One JSON-ready verdict: {sessions, p99_ms, dropped, equivalent,
    windows_per_sec, ...}.  Uses the training-free AnalyticDemoModel so
    the gate spends its seconds on the scheduler, not on a model fit."""
    model = AnalyticDemoModel()
    server = FleetServer(
        model, window=200, hop=hop, smoothing=smoothing,
        config=FleetConfig(max_sessions=max(sessions, 1)),
    )
    recordings, _ = synthetic_sessions(
        sessions, windows_per_session=windows_per_session, seed=seed
    )
    for i in range(sessions):
        server.add_session(i)
    log: list = []
    events, report = drive_fleet(
        server, recordings, seed=seed, delivery_log=log
    )

    # replay the exact delivered chunks through independent classifiers
    per_session_events: dict[int, list] = {i: [] for i in range(sessions)}
    for ev in events:
        per_session_events[ev.session_id].append(ev.event)
    equivalent = True
    independent = {
        i: StreamingClassifier(
            model, window=200, hop=hop, smoothing=smoothing
        )
        for i in range(sessions)
    }
    ref_events: dict[int, list] = {i: [] for i in range(sessions)}
    for i, payload in log:
        ref_events[i].extend(independent[i].push(payload))
    for i in range(sessions):
        got, want = per_session_events[i], ref_events[i]
        if len(got) != len(want) or not all(
            events_equal(g, w) for g, w in zip(got, want)
        ):
            equivalent = False
            break

    snap = server.stats_snapshot()
    p99 = snap["stages"]["event_ms"].get("p99_ms")
    return {
        "sessions": sessions,
        "windows": snap["accounting"]["enqueued"],
        "p99_ms": p99,
        "p50_ms": snap["stages"]["event_ms"].get("p50_ms"),
        "dropped": snap["accounting"]["dropped"],
        "equivalent": equivalent,
        "accounting_balanced": (
            snap["accounting"]["balanced"]
            and snap["accounting"]["pending"] == 0
        ),
        "windows_per_sec": (
            round(snap["accounting"]["scored"] / report.duration_s, 1)
            if report.duration_s
            else None
        ),
        "ok": bool(
            equivalent
            and snap["accounting"]["dropped"] == 0
            and snap["accounting"]["pending"] == 0
        ),
    }


def fleet_pipeline_smoke(
    sessions: int = 64,
    *,
    windows_per_session: int = 2,
    target_batch: int = 32,
    pipeline_depth: int = 3,
    tunnel_rtt_ms: float = 5.0,
    fused: bool = True,
    seed: int = 0,
    max_devices: int = 8,
    device: str = "cuda",
    model=None,
    window: int = 200,
    fake_clock: bool = False,
    mesh=None,
) -> dict:
    """The pipelined-dispatch check: the SAME load run once synchronous
    (depth 1, single device, unfused — the reference) and once through
    the full hot path (depth-3 ticket ring, batch-sharded over ``mesh``
    — by default over up to ``max_devices`` distinct visible cards when
    ``device`` is CUDA and there are several — FUSED device program),
    with the decision streams compared per session.

    Verdict contract:
      - every session's (t_index, label, raw_label, drift) sequence is
        IDENTICAL across the two runs, and the decision CONFIDENCE
        (probability[label]) matches to 1e-6.  Smoothing is "none"
        (passthrough — fused-eligible) PRECISELY so this check has
        teeth: the unfused event carries the model's true probability
        at the label while the fused event carries the device's
        fetched top-prob, so a fused program returning wrong
        confidences fails the check (under vote smoothing both sides
        would be label-derived and the comparison vacuous).  Off-label
        probabilities are the documented compact surrogate — full-
        vector equality is the unfused tier's contract, not this
        one's;
      - zero dropped windows and a balanced conservation law in both;
      - the pipelined run actually pipelined (overlap_pct measured)
        and actually fused (every dispatch through the fused program,
        fetch bytes saved > 0).

    Uses ``JitDemoModel`` on ``device`` (training-free) with a small
    emulated link RTT so the overlap is observable where the device
    finishes in microseconds, unless ``model`` names another
    device-backed model (on its own device, scoring ``window``-sample
    windows) to serve.  ``fake_clock`` runs each leg on its own
    ``FakeClock``, so both score the same batches: on a card a GEMM may
    round a row differently in batches of different sizes, which the
    1e-6 confidence check would read as a fault of the fused program.
    """
    import torch

    from har_tpu_torch.parallel.mesh import create_serving_mesh, serving_devices
    from har_tpu_torch.serve.faults import FakeClock
    from har_tpu_torch.serve.loadgen import JitDemoModel

    if mesh is None and torch.device(device).type == "cuda":
        n_dev = min(int(max_devices), torch.cuda.device_count())
        if n_dev > 1:
            mesh = create_serving_mesh(dp=n_dev, tp=1,
                                       devices=serving_devices(n_dev, device))
    if model is None:
        model = JitDemoModel(window=window, tunnel_rtt_ms=tunnel_rtt_ms,
                             device=device)
    recordings, _ = synthetic_sessions(
        sessions, windows_per_session=windows_per_session, seed=seed,
        window=window,
    )

    def one_run(depth, run_mesh, run_fused):
        server = FleetServer(
            model, window=window, hop=window, smoothing="none",
            config=FleetConfig(
                max_sessions=sessions,
                target_batch=target_batch,
                pipeline_depth=depth,
                fused=run_fused,
            ),
            clock=FakeClock() if fake_clock else None,
            mesh=run_mesh,
        )
        for i in range(sessions):
            server.add_session(i)
        events, report = drive_fleet(server, recordings, seed=seed)
        by_sid: dict[int, list] = {i: [] for i in range(sessions)}
        for ev in events:
            by_sid[ev.session_id].append(ev.event)
        return server, report, by_sid

    s1, r1, ref = one_run(1, None, False)
    s2, r2, got = one_run(pipeline_depth, mesh, fused)

    equivalent = True
    for i in range(sessions):
        a, b = ref[i], got[i]
        if len(a) != len(b) or not all(
            x.t_index == y.t_index
            and x.label == y.label
            and x.raw_label == y.raw_label
            and x.drift == y.drift
            and abs(
                x.probability[x.label] - y.probability[y.label]
            ) <= 1e-6
            for x, y in zip(a, b)
        ):
            equivalent = False
            break

    snap1, snap2 = s1.stats_snapshot(), s2.stats_snapshot()
    clean = all(
        s["accounting"]["dropped"] == 0
        and s["accounting"]["pending"] == 0
        and s["accounting"]["balanced"]
        for s in (snap1, snap2)
    )
    overlap = snap2["overlap_pct"]
    fused_ok = (not fused) or (
        snap2["fused_dispatches"] == snap2["dispatches"] > 0
        and snap2["fetch_bytes_saved"] > 0
    )
    scored = snap2["accounting"]["scored"]
    wps1 = (
        round(snap1["accounting"]["scored"] / r1.duration_s, 1)
        if r1.duration_s
        else None
    )
    wps2 = (
        round(scored / r2.duration_s, 1) if r2.duration_s else None
    )
    return {
        "sessions": sessions,
        "devices": snap2["devices"],
        "pipeline_depth": pipeline_depth,
        "depth": pipeline_depth,
        "fused": bool(fused),
        "fused_dispatches": snap2["fused_dispatches"],
        "fetch_bytes_per_window": (
            round(snap2["fetch_bytes"] / scored, 1) if scored else None
        ),
        "fetch_bytes_saved": snap2["fetch_bytes_saved"],
        "overlap_pct": overlap,
        "inflight_depth": snap2["inflight_depth"],
        "p99_ms": snap2["stages"]["event_ms"].get("p99_ms"),
        "dropped": snap2["accounting"]["dropped"],
        "dispatch_backend": snap2["dispatch_backend"],
        "dispatches_depth1": snap1["dispatches"],
        "dispatches": snap2["dispatches"],
        "windows_per_sec_depth1": wps1,
        "windows_per_sec": wps2,
        "equivalent": equivalent,
        "ok": bool(
            equivalent and clean and fused_ok
            and (overlap is not None if not fake_clock
                 # no time passes on a FakeClock: the evidence of the
                 # ring is several tickets in flight at once instead
                 else max(map(int, snap2["inflight_depth"]), default=0) > 1)
        ),
    }


def model_parallel_smoke(
    sessions: int = 48,
    *,
    windows_per_session: int = 2,
    target_batch: int = 16,
    pipeline_depth: int = 2,
    dp: int = 2,
    tp: int = 4,
    seed: int = 11,
    device: str = "cuda",
    mesh=None,
    model=None,
    window: int = 200,
    atol: float = 1e-6,
) -> dict:
    """The model-parallel check: the SAME load run once on a single
    device and once on the 2D ``dp × tp`` (batch × model) mesh through a
    ``ModelParallelScorer`` — weights placed ONCE via the partition-rule
    table, then served behind the ordinary ticket ring.

    Verdict contract:
      - every session's (t_index, label, raw_label, drift) sequence is
        identical across the two runs and the probability vectors match
        to ``atol`` (1e-6: the re-tiled partial sums; this is the unfused
        tier, so the FULL vector is compared, not the label surrogate);
      - the mesh run really is model-parallel: scorer kind
        ``model_parallel``, ``model_axis_shards == tp``, and
        ``params_bytes()["per_device"]`` STRICTLY below the
        single-device scorer's total — the one property that makes a
        bigger-than-one-device model servable at all;
      - zero dropped windows and balanced accounting in both runs.

    ``mesh`` defaults to ``dp × tp`` devices of ``device``
    (``parallel.mesh.serving_devices``: distinct cards on CUDA, the CPU
    repeated); too few cards gives ``ok: False`` and the shortfall.
    ``model`` (default ``JitDemoModel`` on the mesh's first device)
    serves ``window``-sample windows.
    """
    from har_tpu_torch.parallel.mesh import create_serving_mesh, serving_devices
    from har_tpu_torch.serve.dispatch import ModelParallelScorer
    from har_tpu_torch.serve.loadgen import JitDemoModel

    if mesh is None:
        try:
            devices = serving_devices(dp * tp, device)
        except ValueError as exc:
            return {"ok": False, "error": f"a {dp}x{tp} mesh {exc}"}
        mesh = create_serving_mesh(dp=dp, tp=tp, devices=devices)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp, tp = shape.get("dp", 1), shape.get("tp", 1)
    if model is None:
        model = JitDemoModel(window=window, device=mesh.devices.flat[0])
    recordings, _ = synthetic_sessions(
        sessions, windows_per_session=windows_per_session, seed=seed,
        window=window,
    )

    def one_run(run_mesh):
        server = FleetServer(
            model, window=window, hop=window, smoothing="ema",
            config=FleetConfig(
                max_sessions=sessions,
                target_batch=target_batch,
                pipeline_depth=pipeline_depth if run_mesh else 1,
            ),
            mesh=run_mesh,
        )
        for i in range(sessions):
            server.add_session(i)
        events, report = drive_fleet(server, recordings, seed=seed)
        by_sid: dict[int, list] = {i: [] for i in range(sessions)}
        for ev in events:
            by_sid[ev.session_id].append(ev.event)
        return server, report, by_sid

    s1, r1, ref = one_run(None)
    s2, r2, got = one_run(mesh)

    equivalent = True
    max_abs = 0.0
    for i in range(sessions):
        a, b = ref[i], got[i]
        if len(a) != len(b) or not all(
            x.t_index == y.t_index
            and x.label == y.label
            and x.raw_label == y.raw_label
            and x.drift == y.drift
            for x, y in zip(a, b)
        ):
            equivalent = False
            break
        for x, y in zip(a, b):
            max_abs = max(max_abs, float(np.abs(x.probability - y.probability).max()))
    equivalent = equivalent and max_abs <= atol

    snap1, snap2 = s1.stats_snapshot(), s2.stats_snapshot()
    clean = all(
        s["accounting"]["dropped"] == 0
        and s["accounting"]["pending"] == 0
        and s["accounting"]["balanced"]
        for s in (snap1, snap2)
    )
    placed = isinstance(s2.scorer, ModelParallelScorer)
    shards = s2.scorer.model_axis_shards
    single_bytes = s1.scorer.params_bytes()
    placed_bytes = s2.scorer.params_bytes()
    fits = placed_bytes["per_device"] < single_bytes["total"]
    scored = snap2["accounting"]["scored"]
    return {
        "sessions": sessions,
        "mesh": f"{dp}x{tp}",
        "model_axis_shards": shards,
        "batch_shards": s2.scorer.devices,
        "params_bytes_single": single_bytes["total"],
        "params_bytes_per_device": placed_bytes["per_device"],
        "p99_ms": snap2["stages"]["event_ms"].get("p99_ms"),
        "dropped": snap2["accounting"]["dropped"],
        "dispatches_single": snap1["dispatches"],
        "dispatches": snap2["dispatches"],
        "max_abs_prob_diff": max_abs,
        "windows_per_sec": (
            round(scored / r2.duration_s, 1) if r2.duration_s else None
        ),
        "equivalent": equivalent,
        "ok": bool(
            equivalent
            and clean
            and placed
            and shards == tp
            and fits
        ),
    }


def host_plane_smoke(
    sessions: int = 256, *, check_sessions: int = 64, seed: int = 5
) -> dict:
    """The release gate's host-plane check (the SoA session estate and
    the SoA pending queue): three halves, one verdict —

      1. equivalence: the BATCHED ingest path (``push_many`` over the
         session arena, mid-chunk boundaries included) must produce
         per-session event streams bit-identical to the sequential
         ``push`` path at N=64 — phase-staggered 20 Hz chunks, so
         windows complete mid-chunk (the production shape);
      2. pending-queue identity under pressure: the SAME comparison
         with TIGHT queue bounds, so the shed-stalest walk, the
         per-session bound and the FIFO pop all fire constantly — the
         batched and sequential cadences must shed the SAME windows
         and emit bit-identical surviving streams (the per-object
         queue's semantics, re-proven against the slot-indexed
         ``PendingArena`` every gate run), with the conservation law
         balanced and every drop attributed;
      3. capacity: one small ``host_plane_benchmark`` point stamps
         ``{sessions, host_ms_per_poll, p99_ms}`` — plus the
         footprint gauges (``arena_bytes``/``staging_bytes``/
         ``pending_bytes``) and ``pending_soa: true`` — into the gate
         log: the regression trace the sessions-per-worker ceiling
         curve (artifacts/host_plane_scaling.json) is read against.
    """
    import numpy as np

    from har_tpu_torch.serve.loadgen import (
        HostPlaneStubModel,
        host_plane_benchmark,
        host_plane_rounds,
    )

    model = HostPlaneStubModel()
    window, hop, n = 100, 20, int(check_sessions)
    rng = np.random.default_rng((seed, 0xFACE))
    recs = [
        rng.normal(size=(window + hop * 12, 3)).astype(np.float32)
        for _ in range(n)
    ]
    # THE shared phase-staggered schedule (one builder with the
    # benchmark, so this check exercises the measured cadence)
    rounds = host_plane_rounds(
        recs, hop, rng.integers(0, hop, size=n)
    )

    def one_run(batched: bool, config: FleetConfig, poll_every: int = 1):
        server = FleetServer(
            model, window=window, hop=hop, smoothing="ema",
            config=config,
        )
        for i in range(n):
            server.add_session(i)
        by_sid: dict[int, list] = {i: [] for i in range(n)}
        for r, (ids, chunks) in enumerate(rounds):
            if batched:
                server.push_many(ids, chunks)
            else:
                for sid, part in zip(ids, chunks):
                    server.push(sid, part)
            if (r + 1) % poll_every == 0:
                for fe in server.poll(force=True):
                    by_sid[fe.session_id].append(fe.event)
        for fe in server.flush():
            by_sid[fe.session_id].append(fe.event)
        return server, by_sid

    def streams_equal(seq, bat):
        return all(
            len(seq[i]) == len(bat[i])
            and all(events_equal(a, b) for a, b in zip(seq[i], bat[i]))
            for i in range(n)
        ) and any(len(seq[i]) for i in range(n))

    nominal = FleetConfig(max_sessions=n)
    _, seq = one_run(False, nominal)
    server, bat = one_run(True, nominal)
    equivalent = streams_equal(seq, bat)
    acct = server.stats.accounting()

    # pending-queue identity under pressure: tight bounds make every
    # queue mechanism fire (per-session shed, global shed-stalest,
    # non-full batches); both cadences must agree window for window
    # polls every 5th round so the backlog builds past both bounds
    pressure = FleetConfig(
        max_sessions=n, target_batch=16,
        max_pending_per_session=3, max_queue_windows=48,
    )
    ps, pseq = one_run(False, pressure, poll_every=5)
    pb, pbat = one_run(True, pressure, poll_every=5)
    pending_equivalent = streams_equal(pseq, pbat)
    p_acct = pb.stats.accounting()
    pending_ok = bool(
        pending_equivalent
        and pb.stats.dropped_total > 0  # pressure actually fired
        and pb.stats.dropped == ps.stats.dropped  # same sheds, by reason
        and p_acct["balanced"]
        and p_acct["pending"] == 0
    )

    row = host_plane_benchmark([int(sessions)], n_runs=2)[0]
    return {
        "sessions": int(sessions),
        "host_ms_per_poll": row["host_ms_per_poll_median"],
        "p99_ms": row["event_p99_ms_median"],
        "windows_per_sec": row["windows_per_sec_median"],
        "batched_equivalent": equivalent,
        "pending_soa": True,
        "pending_equivalent": pending_equivalent,
        "pressure_dropped": pb.stats.dropped_total,
        "arena_bytes": row["arena_bytes"],
        "staging_bytes": row["staging_bytes"],
        "pending_bytes": row["pending_bytes"],
        "ok": bool(
            equivalent
            and pending_ok
            and acct["balanced"]
            and acct["pending"] == 0
            and row["accounting_balanced"]
        ),
    }


if __name__ == "__main__":
    import json

    print(json.dumps(fleet_slo_smoke()))
