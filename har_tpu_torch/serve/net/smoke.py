"""The wire checks: failover, journal shipping, replication, the
ingest front door and the gateway pair, over real subprocesses.

``wire_failover_smoke``: three REAL subprocess workers on loopback
TCP, one SIGKILLed mid-dispatch (an actual ``Process.kill`` — not a
shim), and the protocol must do the whole job on real clocks: refused
connections strike the prober, the lease expires, the partition
restores from its journal and migrates to the survivors over the
adopt RPC.  The verdict demands exactly-once delivery of every window
the un-killed schedule would have produced (``windows_lost == 0`` —
the expected count is deterministic), global conservation, and one
failover; the verdict carries ``{workers, transport, failover_ms,
windows_lost}``.

``wire_ingest_smoke``: the front-door pin — the SAME elastic traffic
trace driven twice, once against an in-process journaled FleetCluster
and once through real sockets (subprocess workers + the ingest
gateway's batched push frames), must produce bit-identical per-session
event streams at equal shed declarations, with conservation balanced
end-to-end and the group-committed ``acks`` records measured against
their per-event equivalent straight from the workers' journal
segments.

The four bench lanes of ``har_tpu_torch.bench`` measure the same runs
per fleet size: ``wire_failover_benchmark`` (failover wall time and the
controller-side ``rpc_rtt`` p50/p99), ``journal_ship_benchmark`` (the
shipped, shared-dir and replicated arms of one kill),
``wire_ingest_benchmark`` (windows/s over sockets against in-process,
and the ack path's journal bytes per window) and
``gateway_ha_benchmark`` (the active gateway's failover time).

Port of ``har_tpu/serve/net/smoke.py`` (copied).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from har_tpu_torch.serve.cluster.membership import WorkerUnavailable
from har_tpu_torch.serve.net.chaos import (
    _MATRIX_CHUNK_BYTES,
    _drive_net_cluster,
    _launch_private_fleet,
    _net_cluster_config,
    _safe_accounting,
    predicted_owner,
)
from har_tpu_torch.serve.net.controller import NetCluster, launch_workers


def _run_wire_failover(
    sessions: int, workers: int, seed: int, n_samples: int,
    window: int = 100, hop: int = 50, private: bool = False,
    replicated: bool = False,
) -> dict:
    """One measured wire-failover run: drive, kill the victim process
    once windows are flowing, let the protocol finish, verdict.

    ``private=True`` is the SHARED-NOTHING variant: every worker's
    journal lives in its own per-host directory the controller never
    reads, and the dead partition arrives via the journal-shipping RPC
    from the host's agent (``har_tpu_torch.serve.net.ship``) — the
    ``journal_ship_smoke`` configuration.  ``False`` keeps the
    single-box shared-disk restore.

    ``replicated=True`` (implies private) registers a warm standby
    that tail-follows every worker's agent from the controller's poll
    loop (``har_tpu_torch.serve.replica``): the kill must then fail over
    from the standby's already-verified local bytes — the verdict
    additionally demands ``failover_path_bytes == 0`` (zero journal
    bytes moved AFTER the death) and at least one standby-sourced
    fetch."""
    from har_tpu_torch.serve.chaos import _recordings
    from har_tpu_torch.serve.loadgen import AnalyticDemoModel

    private = private or replicated
    model = AnalyticDemoModel()
    victim = predicted_owner(0, workers)
    root = tempfile.mkdtemp(prefix="har_wire_smoke_")
    priv = tempfile.mkdtemp(prefix="har_wire_priv_")
    procs: dict = {}
    agent_procs: dict = {}
    try:
        if private:
            net_workers, handles = _launch_private_fleet(
                root, priv, workers, window=window, hop=hop,
                target_batch=32, max_delay_ms=0.0,
            )
            agent_procs = {
                wid: h.process for wid, h in handles.items()
            }
            agents = {
                wid: h.client() for wid, h in handles.items()
            }
        else:
            net_workers = launch_workers(
                root, workers, window=window, hop=hop,
                target_batch=32, max_delay_ms=0.0,
            )
            agents = None
        procs = {w.worker_id: w.process for w in net_workers}
        cluster = NetCluster(
            model, root, _workers=net_workers,
            config=_net_cluster_config(),
            loader=lambda ver: model,
            agents=agents,
            ship_chunk_bytes=_MATRIX_CHUNK_BYTES,
        )
        for i in range(sessions):
            cluster.add_session(i)
        if replicated:
            from har_tpu_torch.serve.net.controller import REPLICA_DIR
            from har_tpu_torch.serve.replica import StandbyAgent

            # in-controller standby over the agents' ship RPCs; its
            # transfer counters land on the cluster's net_stats so the
            # steady-state tail traffic is measured alongside the rest
            cluster.register_standby(
                StandbyAgent(
                    os.path.join(root, REPLICA_DIR),
                    {wid: h.client() for wid, h in handles.items()},
                    loader=lambda ver: model,
                    chunk_bytes=_MATRIX_CHUNK_BYTES,
                    stats=cluster.net_stats,
                )
            )
        recordings = _recordings(sessions, n_samples, 3, seed)
        events: list = []
        balance_log: list = []
        killed = {"t": None}
        lag = {"last": 0, "at_kill": None}

        def on_round(c):
            if replicated:
                lag["last"] = sum(
                    c.net_stats.replication_lag_records.values()
                )
            if killed["t"] is None:
                try:
                    scored = c.accounting()["scored"]
                except WorkerUnavailable:
                    return
                if scored > 0:
                    procs[victim].kill()  # a real SIGKILL
                    killed["t"] = time.perf_counter()
                    lag["at_kill"] = lag["last"]
                return
            _safe_accounting(c, balance_log)

        _drive_net_cluster(
            cluster, recordings, [0] * sessions, n_samples, hop,
            events, on_round,
        )
        wall_failover_ms = (
            None
            if killed["t"] is None
            else (time.perf_counter() - killed["t"]) * 1e3
        )
        stats = cluster.cluster_stats()
        acct = stats["accounting"]
        keys = {(e.session_id, e.event.t_index) for e in events}
        expected = sessions * ((n_samples - window) // hop + 1)
        why = None
        if killed["t"] is None:
            why = "the victim was never killed (no windows scored?)"
        elif len(keys) != len(events):
            why = "an event was delivered twice across the kill"
        elif len(keys) != expected:
            why = f"{expected - len(keys)} window(s) lost"
        elif not acct["balanced"] or acct["pending"] != 0:
            why = f"conservation violated: {acct}"
        elif stats["failovers"] != 1:
            why = f"failovers == {stats['failovers']}, expected 1"
        elif any(not s["balanced"] for s in balance_log):
            why = "conservation violated in a per-round snapshot"
        rpc = cluster.transport_stats()
        if why is None and private and rpc["shipped_bytes"] <= 0:
            why = (
                "failover completed without shipping any journal "
                "bytes — the shared-nothing path was bypassed"
            )
        if why is None and replicated:
            if rpc["standby_fetches"] < 1:
                why = (
                    "failover never sourced the partition from the "
                    "warm standby"
                )
            elif rpc["failover_path_bytes"] != 0:
                why = (
                    f"warm failover moved {rpc['failover_path_bytes']} "
                    "journal byte(s) after the death; a caught-up "
                    "standby must transfer zero"
                )
        out = {
            "ok": why is None,
            "why": why,
            "sessions": int(sessions),
            # the LAUNCHED fleet size; the post-failover census rides
            # alongside
            "workers": int(workers),
            "surviving_workers": stats["workers"],
            "transport": "tcp",
            "failovers": stats["failovers"],
            "migrated_sessions": max(
                stats["migrated_sessions"], stats["migrations"]
            ),
            # restore + drain + hand-offs (the control plane's own
            # work), and the wall time from the SIGKILL to the drive
            # settling — detection latency included
            "failover_ms": round(stats["failover_ms"], 3),
            "detect_to_settle_ms": (
                None
                if wall_failover_ms is None
                else round(wall_failover_ms, 1)
            ),
            "windows_lost": max(expected - len(keys), 0),
            "private_dirs": bool(private),
            "replicated": bool(replicated),
            "ship_ms": rpc["ship_ms"],
            "failover_path_bytes": rpc["failover_path_bytes"],
            "standby_fetches": rpc["standby_fetches"],
            "standbys": rpc["standbys"],
            "steady_lag_records": int(lag["last"]),
            "lag_records_at_kill": (
                None if lag["at_kill"] is None else int(lag["at_kill"])
            ),
            "rpc": rpc,
        }
        cluster.shutdown_workers()
        cluster.close()
        return out
    finally:
        # a failed run must not leak worker/agent processes, and the
        # rmtree must never delete the root under live writers (clean
        # exits already reaped: kill is a no-op on an exited process)
        for proc in list(procs.values()) + list(agent_procs.values()):
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(priv, ignore_errors=True)


def wire_failover_smoke(
    sessions: int = 18, workers: int = 3, seed: int = 0
) -> dict:
    """One wire failover run reshaped into the JAX package's gate-log
    stamp."""
    out = _run_wire_failover(sessions, workers, seed, n_samples=300)
    return {
        "ok": out["ok"],
        "why": out["why"],
        "sessions": out["sessions"],
        "workers": out["workers"],
        "transport": out["transport"],
        "failover_ms": out["failover_ms"],
        "windows_lost": out["windows_lost"],
        "rpc_rtt_p50_ms": out["rpc"]["rpc_rtt_p50_ms"],
        "rpc_retries": out["rpc"]["rpc_retries"],
    }


def journal_ship_smoke(
    sessions: int = 18, workers: int = 3, seed: int = 0
) -> dict:
    """Gate verdict for SHARED-NOTHING failover (the journal-shipping
    tentpole): three subprocess workers with PRIVATE journal
    directories (one per-host dir each, a ship agent beside it — the
    controller never reads a worker's filesystem), one worker
    SIGKILLed mid-dispatch, and the dead partition must arrive over
    the ship RPC — chunked, digest-verified, restored from the staged
    copy — before its sessions migrate to the survivors.  The stamp
    carries ``{shipped_bytes, chunks, resumes, windows_lost}``."""
    out = _run_wire_failover(
        sessions, workers, seed, n_samples=300, private=True,
    )
    return {
        "ok": out["ok"],
        "why": out["why"],
        "sessions": out["sessions"],
        "workers": out["workers"],
        "transport": out["transport"],
        "private_dirs": out["private_dirs"],
        "shipped_bytes": out["rpc"]["shipped_bytes"],
        "chunks": out["rpc"]["ship_chunks"],
        "resumes": out["rpc"]["ship_resumes"],
        "ship_ms": out["rpc"]["ship_ms"],
        "failover_ms": out["failover_ms"],
        "windows_lost": out["windows_lost"],
    }


def replication_smoke(
    sessions: int = 18, workers: int = 3, seed: int = 0
) -> dict:
    """Gate verdict for CONTINUOUS REPLICATION (the warm-standby
    tentpole): the journal-ship fleet with one standby tail-following
    every worker's agent, one worker SIGKILLed mid-dispatch — and the
    failover must come from the standby's already-local, already-
    verified bytes: ``failover_path_bytes == 0`` (the ship leaves the
    failover path entirely), with the same exactly-once + conservation
    verdict as every other wire smoke.  The stamp carries ``{standbys,
    lag_records_at_kill, failover_path_bytes, failover_ms,
    windows_lost}``."""
    out = _run_wire_failover(
        sessions, workers, seed, n_samples=300, replicated=True,
    )
    return {
        "ok": out["ok"],
        "why": out["why"],
        "sessions": out["sessions"],
        "workers": out["workers"],
        "transport": out["transport"],
        "standbys": out["standbys"],
        "standby_fetches": out["standby_fetches"],
        "lag_records_at_kill": out["lag_records_at_kill"],
        "failover_path_bytes": out["failover_path_bytes"],
        "failover_ms": out["failover_ms"],
        "windows_lost": out["windows_lost"],
    }


def journal_ship_benchmark(
    session_counts,
    n_runs: int = 3,
    *,
    workers: int = 3,
    seed: int = 0,
    n_samples: int = 300,
) -> list[dict]:
    """``har_tpu_torch.bench``'s ``journal_ship`` lane rows: per fleet size, the
    shared-nothing failover measured twice — the SHIPPED run (private
    dirs + agents: ``ship_ms`` inside fetch_journal, plus the whole
    failover wall time) against the SHARED-DIR baseline (the same
    kill, the dead directory restored in place) — so the cost of
    crossing the process boundary with the recovery currency is a
    measured delta, not an assumption.  ``contract_ok`` pins the
    exactly-once + complete-delivery + conservation verdict on every
    measured run of ALL modes.

    The REPLICATED arm rides in the same lane: the identical kill
    with a warm standby tailing every worker, where the failover path
    moves zero journal bytes (``replicated_failover_path_bytes``) —
    its ``replicated_failover_ms_median`` against ``failover_ms_median``
    is the headline number continuous replication buys."""
    rows = []
    for n_sessions in session_counts:
        ship_ms, failover_ms, base_ms, repl_ms = [], [], [], []
        shipped_bytes, chunks, ok = 0, 0, True
        repl_path_bytes, repl_lag = 0, 0
        for r in range(int(n_runs)):
            shipped = _run_wire_failover(
                int(n_sessions), workers, seed + r, n_samples,
                private=True,
            )
            base = _run_wire_failover(
                int(n_sessions), workers, seed + r, n_samples,
                private=False,
            )
            repl = _run_wire_failover(
                int(n_sessions), workers, seed + r, n_samples,
                replicated=True,
            )
            ok = ok and shipped["ok"] and base["ok"] and repl["ok"]
            ship_ms.append(shipped["rpc"]["ship_ms"])
            failover_ms.append(shipped["failover_ms"])
            base_ms.append(base["failover_ms"])
            repl_ms.append(repl["failover_ms"])
            shipped_bytes = shipped["rpc"]["shipped_bytes"]
            chunks = shipped["rpc"]["ship_chunks"]
            repl_path_bytes = repl["failover_path_bytes"]
            repl_lag = repl["steady_lag_records"]
        rows.append(
            {
                "n_sessions": int(n_sessions),
                "workers": int(workers),
                "transport": "tcp",
                "ship_ms_median": round(float(np.median(ship_ms)), 3),
                "ship_ms_std": round(float(np.std(ship_ms)), 3),
                "failover_ms_median": round(
                    float(np.median(failover_ms)), 3
                ),
                "baseline_failover_ms_median": round(
                    float(np.median(base_ms)), 3
                ),
                "replicated_failover_ms_median": round(
                    float(np.median(repl_ms)), 3
                ),
                "replicated_failover_path_bytes": int(repl_path_bytes),
                "replicated_steady_lag_records": int(repl_lag),
                "shipped_bytes": int(shipped_bytes),
                "chunks": int(chunks),
                "contract_ok": ok,
            }
        )
    return rows


def wire_failover_benchmark(
    session_counts,
    n_runs: int = 3,
    *,
    workers: int = 3,
    seed: int = 0,
    n_samples: int = 300,
) -> list[dict]:
    """``har_tpu_torch.bench``'s ``wire_failover`` lane rows: per fleet size, median
    failover wall time over the REAL transport plus the rpc_rtt
    distribution, ``contract_ok`` pinning the conservation + complete-
    delivery verdict on every measured run."""
    rows = []
    for n_sessions in session_counts:
        times, rtt50, rtt99, migrated, ok = [], [], [], 0, True
        for r in range(int(n_runs)):
            out = _run_wire_failover(
                int(n_sessions), workers, seed + r, n_samples
            )
            ok = ok and out["ok"]
            times.append(out["failover_ms"])
            if out["rpc"]["rpc_rtt_p50_ms"] is not None:
                rtt50.append(out["rpc"]["rpc_rtt_p50_ms"])
                rtt99.append(out["rpc"]["rpc_rtt_p99_ms"])
            migrated = out["migrated_sessions"]
        rows.append(
            {
                "n_sessions": int(n_sessions),
                "workers": int(workers),
                "transport": "tcp",
                "migrated_sessions": int(migrated),
                "failover_ms_median": round(float(np.median(times)), 3),
                "failover_ms_std": round(float(np.std(times)), 3),
                "rpc_rtt_p50_ms": (
                    round(float(np.median(rtt50)), 4) if rtt50 else None
                ),
                "rpc_rtt_p99_ms": (
                    round(float(np.median(rtt99)), 4) if rtt99 else None
                ),
                "contract_ok": ok,
            }
        )
    return rows


# ------------------------------------------------- wire-rate ingest


def _ack_journal_stats(journal_dirs) -> dict:
    """Measure the ack path's journal cost straight from the workers'
    segments: the actual bytes of the group-committed ``acks`` records
    vs the bytes the SAME entries would have cost as per-event ``ack``
    records — each entry reconstructed (sid, a per-session running
    window counter as its t_index, version, shed, its own float64 probs
    row) and re-encoded through the journal's own framing
    (``encode_record``), so the coalescing ratio is a measurement of
    both layouts under one encoder, not a model."""
    from har_tpu_torch.serve.journal import encode_record, read_segment

    acks_records = entries = legacy_ack_records = 0
    coalesced_bytes = equiv_bytes = 0
    next_ti: dict = {}
    for jdir in journal_dirs:
        try:
            names = sorted(os.listdir(jdir))
        except OSError:
            continue
        for name in names:
            if not (name.startswith("wal.") and name.endswith(".log")):
                continue
            records, _torn = read_segment(os.path.join(jdir, name))
            for meta, payload in records:
                t = meta.get("t")
                if t == "ack":
                    legacy_ack_records += 1
                elif t == "acks":
                    n = int(meta["n"])
                    acks_records += 1
                    entries += n
                    coalesced_bytes += len(encode_record(meta, payload))
                    rows = np.frombuffer(payload, np.float64).reshape(
                        n, -1
                    )
                    for sid, row in zip(meta["sids"], rows):
                        ti = next_ti.get(sid, 0)
                        next_ti[sid] = ti + 1
                        equiv_bytes += len(
                            encode_record(
                                {
                                    "t": "ack",
                                    "sid": sid,
                                    "ti": ti,
                                    "ver": meta.get("ver", "A"),
                                    "shed": bool(meta.get("shed")),
                                },
                                row.tobytes(),
                            )
                        )
    return {
        "acks_records": acks_records,
        "entries": entries,
        "legacy_ack_records": legacy_ack_records,
        "coalesced_bytes": coalesced_bytes,
        "per_record_bytes": equiv_bytes,
        "bytes_per_window": (
            round(coalesced_bytes / entries, 2) if entries else None
        ),
        "per_record_bytes_per_window": (
            round(equiv_bytes / entries, 2) if entries else None
        ),
        "coalesce_ratio": (
            round(coalesced_bytes / equiv_bytes, 4)
            if equiv_bytes
            else None
        ),
    }


def _by_session(events) -> dict:
    from har_tpu_torch.serve.chaos import _event_fields

    out: dict = {}
    for fe in events:
        out.setdefault(fe.session_id, []).append(_event_fields(fe))
    return out


def _run_wire_ingest(
    peak_sessions: int,
    workers: int,
    seed: int,
    *,
    rounds: int = 40,
    window: int = 100,
    hop: int = 50,
    target_batch: int = 32,
) -> dict:
    """One measured front-door run: the same elastic traffic trace
    driven against (a) an in-process journaled FleetCluster — the
    reference — and (b) subprocess workers behind the ingest gateway
    over real sockets, batched push frames and all.  The verdict pins
    bit-identical per-session event streams at equal shed declarations,
    conservation balanced at the edge (every client window enqueued
    lands in fleet accounting; refusals are declared receipts), and
    zero undeclared drops."""
    from har_tpu_torch.serve.cluster.controller import FleetCluster
    from har_tpu_torch.serve.engine import FleetConfig
    from har_tpu_torch.serve.journal import JournalConfig
    from har_tpu_torch.serve.loadgen import AnalyticDemoModel
    from har_tpu_torch.serve.net.gateway import GatewayClient, launch_gateway
    from har_tpu_torch.serve.traffic import TraceSpec, TrafficTrace, drive_trace

    spec = TraceSpec(
        kind="diurnal",
        peak_sessions=peak_sessions,
        swing=4.0,
        rounds=rounds,
        period=rounds,
        seed=seed,
    )
    trace = TrafficTrace(spec)
    fleet_config = FleetConfig(
        target_batch=target_batch, max_delay_ms=0.0, retries=1
    )
    # snapshot_every=0: only the attach-time snapshot, so every ack
    # record of the run survives in the wal segments for measurement
    journal_config = JournalConfig(flush_every=512, snapshot_every=0)

    # ---- reference: the same trace, in-process, journaled workers
    ref_root = tempfile.mkdtemp(prefix="har_ingest_ref_")
    ref_events: list = []
    try:
        ref_cluster = FleetCluster(
            AnalyticDemoModel(),
            ref_root,
            workers=workers,
            window=window,
            hop=hop,
            fleet_config=fleet_config,
            journal_config=journal_config,
        )
        ref_events, ref_report = drive_trace(ref_cluster, trace)
        ref_acct = ref_cluster.accounting()
        for w in ref_cluster._workers.values():
            w.close()
    finally:
        shutil.rmtree(ref_root, ignore_errors=True)

    # ---- the wire run: subprocess workers + gateway + batched frames
    root = tempfile.mkdtemp(prefix="har_ingest_wire_")
    procs: list = []
    client = None
    try:
        net_workers = launch_workers(
            root,
            workers,
            window=window,
            hop=hop,
            target_batch=target_batch,
            max_delay_ms=0.0,
            flush_every=512,
            snapshot_every=0,
        )
        procs = [w.process for w in net_workers]
        gw_proc, gw_host, gw_port = launch_gateway(root, net_workers)
        procs.append(gw_proc)
        client = GatewayClient(gw_host, gw_port)
        wire_events, wire_report = drive_trace(
            client, TrafficTrace.from_spec(trace.spec())
        )
        wire_acct = client.accounting()
        gw_stats = client.gateway_stats()
        # orderly teardown so every journal byte is on disk before the
        # segment scan: gateway first, then the workers close their
        # journals via the shutdown RPC
        client.shutdown()
        client.close()
        client = None
        gw_proc.wait(timeout=30)
        jdirs = []
        for w in net_workers:
            jdirs.append(w.journal_dir)
            w.shutdown()
            w.close()
            w.process.wait(timeout=30)
        ack_stats = _ack_journal_stats(jdirs)

        # ---- verdict
        ref_by = _by_session(ref_events)
        wire_by = _by_session(wire_events)
        keys = {(fe.session_id, fe.event.t_index) for fe in wire_events}
        windows_lost = len(ref_events) - len(wire_events)
        why = None
        if len(keys) != len(wire_events):
            why = "an event was delivered twice through the gateway"
        elif wire_by != ref_by:
            if windows_lost > 0:
                why = f"{windows_lost} window(s) lost at the front door"
            else:
                why = (
                    "wire events are not bit-identical to the "
                    "in-process run"
                )
        elif client_sheds_differ(gw_stats, wire_report):
            why = "edge sheds were not declared symmetrically"
        elif not wire_acct["balanced"] or wire_acct["pending"] != 0:
            why = f"conservation violated over the wire: {wire_acct}"
        elif wire_acct["dropped"] != ref_acct["dropped"]:
            why = (
                "shed declarations diverged: wire dropped "
                f"{wire_acct['dropped']}, in-process "
                f"{ref_acct['dropped']}"
            )
        elif wire_acct["enqueued"] != ref_acct["enqueued"]:
            why = (
                "an undeclared drop at the edge: wire enqueued "
                f"{wire_acct['enqueued']}, in-process "
                f"{ref_acct['enqueued']}"
            )
        elif not ack_stats["entries"]:
            why = "no group-committed acks records reached the journal"
        return {
            "ok": why is None,
            "why": why,
            "sessions": int(trace.total_sessions),
            "workers": int(workers),
            "transport": "tcp",
            "rounds": int(rounds),
            "frames": int(gw_stats["admitted_frames"]),
            "shed_frames": int(gw_stats["shed_frames"]),
            "windows_lost": max(windows_lost, 0),
            "windows_enqueued": int(wire_acct["enqueued"]),
            "windows_scored": int(wire_acct["scored"]),
            "wire_duration_s": wire_report.duration_s,
            "inproc_duration_s": ref_report.duration_s,
            "event_latency_ms": [
                float(fe.event.latency_ms) for fe in wire_events
            ],
            "ack_stats": ack_stats,
        }
    finally:
        if client is not None:
            client.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(root, ignore_errors=True)


def client_sheds_differ(gw_stats: dict, wire_report) -> bool:
    """The edge's declared-receipt law, checked from both ends: every
    frame the gateway refused must be a shed the CLIENT also counted —
    here the honest drive sends no stale/oversized frames, so both
    sides must agree on zero."""
    return int(gw_stats["shed_frames"]) != 0


def wire_ingest_smoke(
    peak_sessions: int = 64, workers: int = 2, seed: int = 0
) -> dict:
    """One front-door run reshaped into the JAX package's gate-log
    stamp."""
    out = _run_wire_ingest(peak_sessions, workers, seed)
    ack = out["ack_stats"]
    return {
        "ok": out["ok"],
        "why": out["why"],
        "sessions": out["sessions"],
        "workers": out["workers"],
        "transport": out["transport"],
        "frames": out["frames"],
        "bytes_per_window": ack["bytes_per_window"],
        "per_record_bytes_per_window": ack[
            "per_record_bytes_per_window"
        ],
        "ack_coalesce_ratio": ack["coalesce_ratio"],
        "ack_records_coalesced": ack["entries"],
        "windows_lost": out["windows_lost"],
    }


def wire_ingest_benchmark(
    session_counts,
    n_runs: int = 3,
    *,
    workers: int = 2,
    seed: int = 0,
    rounds: int = 40,
) -> list[dict]:
    """``har_tpu_torch.bench``'s ``wire_ingest`` lane rows: per traffic size, the
    front-door throughput over real sockets (median windows/s of
    ``n_runs``) against the in-process drive of the SAME trace, the
    per-event p99 latency over the wire, and the ack path's journal
    bytes per window — coalesced vs the per-event equivalent, with the
    ratio the 0.5× acceptance bound rides on.  ``contract_ok`` pins
    the bit-identity + conservation verdict on every measured run."""
    rows = []
    for n_sessions in session_counts:
        wire_ws, inproc_ws, p99s = [], [], []
        ack = {}
        frames, ok = 0, True
        for r in range(int(n_runs)):
            out = _run_wire_ingest(
                int(n_sessions), workers, seed + r, rounds=rounds
            )
            ok = ok and out["ok"]
            scored = out["windows_scored"]
            if out["wire_duration_s"]:
                wire_ws.append(scored / out["wire_duration_s"])
            if out["inproc_duration_s"]:
                inproc_ws.append(scored / out["inproc_duration_s"])
            lat = out["event_latency_ms"]
            if lat:
                p99s.append(float(np.percentile(lat, 99)))
            ack = out["ack_stats"]
            frames = out["frames"]
        rows.append(
            {
                "n_sessions": int(n_sessions),
                "workers": int(workers),
                "transport": "tcp",
                "frames": int(frames),
                "windows_s_median": round(float(np.median(wire_ws)), 1),
                "windows_s_std": round(float(np.std(wire_ws)), 1),
                "inproc_windows_s_median": round(
                    float(np.median(inproc_ws)), 1
                ),
                "event_p99_ms": (
                    round(float(np.median(p99s)), 3) if p99s else None
                ),
                "ack_bytes_per_window": ack.get("bytes_per_window"),
                "per_record_bytes_per_window": ack.get(
                    "per_record_bytes_per_window"
                ),
                "ack_coalesce_ratio": ack.get("coalesce_ratio"),
                "contract_ok": ok,
            }
        )
    return rows


def _run_gateway_ha(
    sessions: int,
    workers: int,
    seed: int,
    *,
    rounds: int = 12,
    window: int = 100,
    hop: int = 50,
    lease_s: float = 1.0,
    kill_round: int | None = None,
) -> dict:
    """One measured HA front-door run: an elected gateway PAIR fronting
    subprocess workers, two tenant cohorts (``care`` weight 3.0 — the
    protected monitored-patient streams — and ``bulk`` weight 1.0)
    pushing through reconnecting HA clients, and the ACTIVE gateway
    SIGKILLed mid-run.  The verdict pins the lease flip losslessly:
    every client reconnects and resumes from the workers' watermarks,
    ``windows_lost == 0``, the combined scored stream bit-identical to
    an in-process un-killed run of the same schedule — then a one-
    tenant storm (an oversized ``bulk`` burst) is refused with a
    declared receipt while the ``care`` cohort sees ZERO edge sheds,
    and the edge ledger's per-tenant slices sum to its globals."""
    from har_tpu_torch.serve.chaos import _recordings
    from har_tpu_torch.serve.cluster.controller import FleetCluster
    from har_tpu_torch.serve.engine import FleetConfig
    from har_tpu_torch.serve.journal import JournalConfig
    from har_tpu_torch.serve.loadgen import AnalyticDemoModel
    from har_tpu_torch.serve.net.client import HAGatewayClient
    from har_tpu_torch.serve.net.gateway import launch_gateway_pair
    from har_tpu_torch.serve.net.ingest import IngestConfig
    from har_tpu_torch.utils.backoff import BackoffPolicy

    sessions = max(int(sessions), 2)
    if kill_round is None:
        kill_round = max(rounds // 3, 1)
    n_samples = rounds * hop
    recordings = _recordings(sessions, n_samples, 3, seed)
    care_sids = list(range(sessions // 2))
    bulk_sids = list(range(sessions // 2, sessions))
    config = IngestConfig(
        # a soft byte ceiling the storm burst overflows while every
        # honest frame stays far below it
        max_frame_bytes=1 << 18,
        tenants=(("bulk", 1.0), ("care", 3.0)),
    )

    # ---- reference: the same schedule, in-process, un-killed --------
    ref_root = tempfile.mkdtemp(prefix="har_gwha_ref_")
    ref_events: list = []
    try:
        ref = FleetCluster(
            AnalyticDemoModel(),
            ref_root,
            workers=workers,
            window=window,
            hop=hop,
            fleet_config=FleetConfig(
                target_batch=32, max_delay_ms=0.0, retries=1
            ),
            journal_config=JournalConfig(
                flush_every=512, snapshot_every=40
            ),
        )
        for i in range(sessions):
            ref.add_session(i)
        for r in range(rounds):
            for i in range(sessions):
                ref.push(i, recordings[i][r * hop:(r + 1) * hop])
            ref_events.extend(ref.poll(force=True))
        ref_events.extend(ref.flush())
        for w in ref._workers.values():
            w.close()
    finally:
        shutil.rmtree(ref_root, ignore_errors=True)

    # ---- the wire run: worker fleet + elected pair + two tenants ----
    root = tempfile.mkdtemp(prefix="har_gwha_wire_")
    procs: list = []
    clients: list = []
    try:
        net_workers = launch_workers(
            root, workers, window=window, hop=hop, target_batch=32,
            max_delay_ms=0.0, flush_every=512, snapshot_every=40,
        )
        procs = [w.process for w in net_workers]
        pair = launch_gateway_pair(
            root, net_workers, config=config, lease_s=lease_s,
        )
        procs.extend(p for p, _, _ in pair)
        addrs = [f"{h}:{p}" for _, h, p in pair]
        policy = BackoffPolicy(
            base_ms=20.0, cap_ms=250.0, factor=2.0, jitter=0.25
        )
        care = HAGatewayClient(
            addrs, tenant="care", deadline_s=2.0, retries=1,
            reconnect=policy, seed=seed,
        )
        bulk = HAGatewayClient(
            addrs, tenant="bulk", deadline_s=2.0, retries=1,
            reconnect=policy, seed=seed + 1,
        )
        clients = [care, bulk]
        for i in care_sids:
            care.add_session(i)
        for i in bulk_sids:
            bulk.add_session(i)
        events: list = []
        t_kill = None
        for r in range(rounds):
            if r == kill_round:
                # a real SIGKILL of the ACTIVE gateway, client frames
                # in flight on both tenants
                pair[0][0].kill()
                t_kill = time.monotonic()
            for i in care_sids:
                care.push(i, recordings[i][r * hop:(r + 1) * hop])
            for i in bulk_sids:
                bulk.push(i, recordings[i][r * hop:(r + 1) * hop])
            events.extend(care.poll(force=True))
            events.extend(bulk.poll(force=True))
        events.extend(care.flush())
        events.extend(bulk.flush())

        # ---- the one-tenant storm: an oversized bulk burst ----------
        storm_sid = sessions
        bulk.add_session(storm_sid)
        bulk.push(
            storm_sid, np.zeros((24576, 3), np.float32)
        )  # 288 KiB > the 256 KiB soft ceiling: shed, with a receipt
        events.extend(bulk.poll(force=True))

        acct = care.accounting()
        gw = care.gateway_stats()
        failover_s = time.monotonic() - (t_kill or time.monotonic())

        # ---- verdict ------------------------------------------------
        ref_by = _by_session(ref_events)
        got_by = _by_session(events)
        keys = {(fe.session_id, fe.event.t_index) for fe in events}
        windows_lost = len(ref_events) - len(events)
        slices = gw.get("tenants", {})
        why = None
        if len(keys) != len(events):
            why = "an event was delivered twice across the lease flip"
        elif windows_lost != 0:
            why = f"{windows_lost} window(s) lost across the lease flip"
        elif got_by != ref_by:
            why = (
                "scored stream not bit-identical to the un-killed "
                "in-process run"
            )
        elif care.edge_sheds != 0:
            why = (
                f"the protected tenant took {care.edge_sheds} edge "
                "shed(s) during the bulk storm"
            )
        elif bulk.shed_by_reason.get("frame_bytes", 0) < 1:
            why = "the bulk storm was not refused at the edge"
        elif slices.get("care", {}).get("shed_frames", 0) != 0:
            why = "the edge ledger charged sheds to the care slice"
        elif slices.get("bulk", {}).get("shed_frames", 0) < 1:
            why = "the edge ledger missed the bulk storm shed"
        elif any(
            sum(s.get(k, 0) for s in slices.values()) != gw.get(k)
            for k in (
                "admitted_frames", "admitted_sessions",
                "admitted_bytes", "shed_frames", "shed_sessions",
                "shed_bytes",
            )
        ):
            why = (
                "per-tenant slices do not sum to the edge ledger "
                "globals"
            )
        elif not acct["balanced"] or acct["pending"] != 0:
            why = f"conservation violated across the flip: {acct}"
        elif min(care.gen, bulk.gen) < 2:
            why = (
                "a client never saw the fenced generation move "
                f"(care={care.gen}, bulk={bulk.gen})"
            )
        elif min(care.failover_episodes, bulk.failover_episodes) < 1:
            why = "a client recorded no failover episode"
        failover_ms = max(
            care.last_failover_ms or 0.0, bulk.last_failover_ms or 0.0
        )
        out = {
            "ok": why is None,
            "why": why,
            "sessions": int(sessions),
            "workers": int(workers),
            "gateways": 2,
            "transport": "tcp",
            "rounds": int(rounds),
            "windows_lost": windows_lost,
            "delivered": len(events),
            "failover_ms": float(failover_ms),
            "run_failover_s": float(failover_s),
            "reconnects": care.reconnects + bulk.reconnects,
            "moved_receipts": care.moved_receipts + bulk.moved_receipts,
            "resumed_sessions": len(care.resumed | bulk.resumed),
            "tenant_sheds": {
                t: int(s.get("shed_frames", 0))
                for t, s in slices.items()
            },
            "lease_gen": int(max(care.gen, bulk.gen)),
            "accounting": acct,
        }
        care.shutdown()
        return out
    finally:
        for c in clients:
            c.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        shutil.rmtree(root, ignore_errors=True)


def gateway_ha_smoke(
    sessions: int = 8, workers: int = 2, seed: int = 0
) -> dict:
    """One gateway-pair failover run reshaped into the JAX package's
    gate-log stamp."""
    out = _run_gateway_ha(sessions, workers, seed)
    return {
        "ok": out["ok"],
        "why": out["why"],
        "sessions": out["sessions"],
        "workers": out["workers"],
        "gateways": out["gateways"],
        "transport": out["transport"],
        "failover_ms": out["failover_ms"],
        "resumed_sessions": out["resumed_sessions"],
        "tenant_sheds": out["tenant_sheds"],
        "windows_lost": out["windows_lost"],
    }


def gateway_ha_benchmark(
    session_counts,
    n_runs: int = 3,
    *,
    workers: int = 2,
    seed: int = 0,
    rounds: int = 12,
) -> list[dict]:
    """``har_tpu_torch.bench``'s ``gateway_ha`` lane rows: per session count, the
    failover cost of the ACTIVE gateway dying — wall time from the
    SIGKILL to the first frame the new leader ACCEPTS
    (``failover_ms``, median of ``n_runs``) — plus the reconnect storm
    size.  ``contract_ok`` pins the lossless verdict (bit-identity,
    zero windows lost, tenant fairness) on every measured run."""
    rows = []
    for n_sessions in session_counts:
        fo_ms, reconnects, moved = [], 0, 0
        resumed, ok = 0, True
        for r in range(int(n_runs)):
            out = _run_gateway_ha(
                int(n_sessions), workers, seed + r, rounds=rounds
            )
            ok = ok and out["ok"]
            fo_ms.append(out["failover_ms"])
            reconnects = out["reconnects"]
            moved = out["moved_receipts"]
            resumed = out["resumed_sessions"]
        rows.append(
            {
                "n_sessions": int(n_sessions),
                "workers": int(workers),
                "gateways": 2,
                "transport": "tcp",
                "failover_ms_median": round(float(np.median(fo_ms)), 1),
                "failover_ms_max": round(float(np.max(fo_ms)), 1),
                "reconnects": int(reconnects),
                "moved_receipts": int(moved),
                "resumed_sessions": int(resumed),
                "contract_ok": ok,
            }
        )
    return rows


if __name__ == "__main__":
    import json

    print(json.dumps(wire_failover_smoke()))
