"""The fleet cluster's wire transport (har_tpu_torch.serve.net) on the CPU.

The JAX package's RPC contracts (tests/test_net.py) on the port: the
remote-error taxonomy, a late answer retried under the same request id
and executed exactly once, the retry budget, refused connections failing
fast, and duplicated delivery running the handler once — each slow or
lost link injected with ``LinkFaults``, never read off a loaded machine.
Then:

  - either package's ``RpcClient`` against the other's ``RpcServer``;
  - the failure detector's two evidence species on the in-process
    cluster: timeouts never strike, refused connections do;
  - one ``NetCluster`` over three ``serve-worker`` subprocesses: a
    worker congested by ``LinkFaults`` is retried and not failed over, a
    worker SIGKILLed is, and the decision streams equal one in-process
    ``FleetServer``'s;
  - ``serve --workers 3 --net --kill-worker w1`` end to end;
  - a mixed cluster: a port ``NetCluster`` over one ``har_tpu``
    ``WorkerHost`` and one port ``WorkerHost``, each on a loopback
    thread, whose events equal a single server's;
  - what once waited for ROADMAP.md Queue 1 item 15 keeps its contract
    (ship agents, ``NetCluster(agents=)``, ``HAGatewayClient``, the wire
    runners); the wire bench lanes still name item 16.

Worker subprocesses start at ``nice 19`` with one thread each (a low
weight, not ``SCHED_IDLE``: an RPC server must keep answering on a busy
machine), under the lock ``tests/_torch_ranks.py``'s rank groups take, so
one test file's subprocesses run at a time; RPC deadlines that are not
under test are tens of seconds.
"""

import json
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from har_tpu_torch.serve import FakeClock
from har_tpu_torch.serve.cluster import (
    ClusterConfig,
    FleetCluster,
    WorkerTimeout,
    WorkerUnavailable,
)
from har_tpu_torch.serve.engine import FleetConfig, FleetServer
from har_tpu_torch.serve.loadgen import AnalyticDemoModel
from har_tpu_torch.serve.net.chaos import _drive_net_cluster, _net_cluster_config
from har_tpu_torch.serve.net.client import NetWorker
from har_tpu_torch.serve.net.controller import NetCluster, launch_workers
from har_tpu_torch.serve.net.rpc import (
    LinkFaults,
    RpcClient,
    RpcConnectionRefused,
    RpcDeadlineExceeded,
    RpcRemoteError,
    RpcServer,
)
from har_tpu_torch.serve.stats import FleetStats
from tests._torch_ranks import CHILD_ENV, CHILD_NICE, REPO, _one_at_a_time, child_hygiene

torch.set_num_threads(1)

MODEL = AnalyticDemoModel()
# deadlines no loaded machine can blow: only LinkFaults makes a call late
CALM_DEADLINE_S = 30.0


def _decision_fields(fe):
    ev = fe.event
    return (ev.t_index, ev.label, ev.raw_label, ev.drift,
            ev.probability.tobytes())


def _by_session(events):
    out = {}
    for e in events:
        out.setdefault(e.session_id, []).append(_decision_fields(e))
    return out


# ---------------------------------------------------------------- rpc


class _ServerThread:
    def __init__(self, handlers, server_cls=RpcServer):
        self.server = server_cls(handlers)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            self.server.step(0.02)

    @property
    def port(self):
        return self.server.port

    def close(self):
        self._stop.set()
        self._thread.join(5.0)
        self.server.close()


def _echo_handlers(calls):
    def echo(meta, payload):
        calls["n"] += 1
        return {"r": meta.get("x", 0) * 2}, payload[::-1]

    def boom(meta, payload):
        raise ValueError("handler exploded")

    return {"echo": echo, "boom": boom}


def test_rpc_roundtrip_payload_and_remote_error_taxonomy():
    calls = {"n": 0}
    srv = _ServerThread(_echo_handlers(calls))
    try:
        client = RpcClient("127.0.0.1", srv.port, deadline_s=CALM_DEADLINE_S)
        resp, payload = client.call("echo", {"x": 21}, b"abc")
        assert resp["r"] == 42 and payload == b"cba"
        with pytest.raises(RpcRemoteError) as ei:
            client.call("boom")
        assert ei.value.kind == "ValueError"
        # remote errors mean the worker is ALIVE: the next call works
        resp, _ = client.call("echo", {"x": 1})
        assert resp["r"] == 2
        with pytest.raises(RpcRemoteError, match="UnknownMethod"):
            client.call("nope")
        client.close()
    finally:
        srv.close()


def test_rpc_deadline_exceeded_retries_with_dedup_exactly_once():
    """A late answer is ambiguous — the peer may have executed the call.
    The retry reuses the SAME request id and the server's dedup cache
    answers it without re-running the handler: exactly-once.  The late
    answer is ``LinkFaults("delay")``: the request goes out and the
    client reads only past its own deadline."""
    calls = {"n": 0}

    def bump(meta, payload):
        calls["n"] += 1
        return {"r": calls["n"]}, b""

    srv = _ServerThread({"bump": bump})
    try:
        stats = FleetStats()
        client = RpcClient(
            "127.0.0.1", srv.port, deadline_s=0.5, retries=8, stats=stats,
            faults=LinkFaults("delay", method="bump", times=1),
        )
        resp, _ = client.call("bump")
        # the handler ran ONCE (the retry was served from the dedup
        # cache), and the answer is the first execution's
        assert resp["r"] == 1
        assert calls["n"] == 1
        assert stats.rpc_retries >= 1
        assert stats.rpc_rtt.count >= 1
        client.close()
    finally:
        srv.close()


def test_rpc_budget_exhausted_raises_deadline_refused_fails_fast():
    calls = {"n": 0}
    srv = _ServerThread(_echo_handlers(calls))
    try:
        stats = FleetStats()
        client = RpcClient(
            "127.0.0.1", srv.port, deadline_s=0.05, retries=2, stats=stats,
            faults=LinkFaults("delay", times=10**9),
        )
        with pytest.raises(RpcDeadlineExceeded):
            client.call("echo", {"x": 1})
        assert stats.rpc_retries == 2  # the whole budget, then the raise
        client.close()
    finally:
        srv.close()
    # nobody listening: refused at once, never a retry loop
    stats = FleetStats()
    dead = RpcClient("127.0.0.1", srv.port, deadline_s=CALM_DEADLINE_S,
                     retries=5, stats=stats)
    with pytest.raises(RpcConnectionRefused):
        dead.call("anything")
    assert stats.rpc_retries == 0 and stats.rpc_sent == 0
    dead.close()


def test_dropped_request_times_out_and_the_retry_lands():
    """A blackholed frame (``LinkFaults("drop")``) never reaches the
    server: the attempt times out, the retry executes the handler
    once."""
    calls = {"n": 0}
    srv = _ServerThread(_echo_handlers(calls))
    try:
        client = RpcClient(
            "127.0.0.1", srv.port, deadline_s=0.3, retries=8,
            faults=LinkFaults("drop", method="echo", times=1),
        )
        resp, _ = client.call("echo", {"x": 4})
        assert resp["r"] == 8 and calls["n"] == 1
        client.close()
    finally:
        srv.close()


def test_duplicated_delivery_executes_the_handler_once():
    calls = {"n": 0}

    def bump(meta, payload):
        calls["n"] += 1
        return {"r": calls["n"]}, b""

    srv = _ServerThread({"bump": bump})
    try:
        client = RpcClient(
            "127.0.0.1", srv.port, deadline_s=CALM_DEADLINE_S,
            faults=LinkFaults("dup", method="bump", times=10**9),
        )
        for i in range(1, 6):
            resp, _ = client.call("bump")
            assert resp["r"] == i  # duplicates answered from cache
        assert calls["n"] == 5
        client.close()
    finally:
        srv.close()


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_rpc_across_packages(direction):
    """Either package's client against the other's server: payloads,
    the remote-error taxonomy and duplicate dedup are the same
    protocol."""
    from har_tpu.serve.net import rpc as jax_rpc

    if direction == "port_client_jax_server":
        server_cls, client_mod = jax_rpc.RpcServer, sys.modules[RpcClient.__module__]
    else:
        server_cls, client_mod = RpcServer, jax_rpc
    calls = {"n": 0}
    srv = _ServerThread(_echo_handlers(calls), server_cls=server_cls)
    try:
        client = client_mod.RpcClient(
            "127.0.0.1", srv.port, deadline_s=CALM_DEADLINE_S,
            faults=client_mod.LinkFaults("dup", method="echo", times=10**9),
        )
        resp, payload = client.call("echo", {"x": 5}, b"xyz")
        assert resp["r"] == 10 and payload == b"zyx"
        assert calls["n"] == 1  # the duplicate was answered from cache
        with pytest.raises(client_mod.RpcRemoteError) as ei:
            client.call("boom")
        assert ei.value.kind == "ValueError"
        client.close()
    finally:
        srv.close()


# ------------------------------------------------- prober distinction


class _FlakyWorker:
    """ClusterWorker stand-in whose poll raises a chosen failure
    species for a while, then heals — the prober-distinction pin."""

    def __init__(self, inner, exc_type, times):
        self._inner = inner
        self._exc = exc_type
        self._times = times
        self.raised = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def poll(self, *, force=False):
        if self.raised < self._times:
            self.raised += 1
            raise self._exc("injected")
        return self._inner.poll(force=force)

    def heartbeat(self):
        if self.raised < self._times:
            self.raised += 1
            raise self._exc("injected")
        return self._inner.heartbeat()


def _flaky_cluster(tmp_path, exc_type, clock):
    cluster = FleetCluster(
        MODEL,
        str(tmp_path),
        workers=3,
        window=200,
        hop=200,
        smoothing="ema",
        fleet_config=FleetConfig(max_sessions=32, max_delay_ms=0.0),
        config=ClusterConfig(
            lease_s=0.2, probe_retries=2, probe_base_ms=10.0,
            probe_cap_ms=20.0,
        ),
        clock=clock,
    )
    for i in range(6):
        cluster.add_session(i)
    wid = cluster.worker_of(0)
    cluster._workers[wid] = _FlakyWorker(
        cluster._workers[wid], exc_type, times=40
    )
    return cluster, wid


def test_timeouts_never_strike_a_congested_worker_is_not_failovered(tmp_path):
    """A worker whose calls TIME OUT (slow link) loses its lease but
    never accumulates probe strikes — no failover fires no matter how
    long the congestion lasts."""
    clock = FakeClock()
    cluster, wid = _flaky_cluster(tmp_path / "t", WorkerTimeout, clock)
    rng = np.random.default_rng(5)
    for _ in range(30):
        for i in range(6):
            try:
                cluster.push(
                    i, rng.normal(size=(40, 3)).astype(np.float32)
                )
            except WorkerUnavailable:
                pass
        cluster.poll(force=True)
        clock.advance(0.1)  # way past lease_s=0.2 cumulative
    assert cluster.failovers == 0
    assert wid in cluster._workers
    # after the link heals the worker serves again and the fleet
    # drains to balance
    for _ in range(20):
        cluster.poll(force=True)
        clock.advance(0.05)
    acct = cluster.accounting()
    assert acct["balanced"]
    cluster.close()


def test_refused_connections_do_strike_and_failover_fires(tmp_path):
    """The SAME schedule with connection-refused evidence (plain
    WorkerUnavailable) declares the worker dead and fails over — the
    species distinction, not the schedule, is what protects the slow
    worker."""
    clock = FakeClock()
    cluster, wid = _flaky_cluster(
        tmp_path / "r", WorkerUnavailable, clock
    )
    # refused evidence comes from a DEAD worker: kill the underlying
    # engine so the failover has a journal to restore
    cluster._workers[wid]._inner.kill()
    rng = np.random.default_rng(5)
    for _ in range(30):
        for i in range(6):
            try:
                cluster.push(
                    i, rng.normal(size=(40, 3)).astype(np.float32)
                )
            except WorkerUnavailable:
                pass
        cluster.poll(force=True)
        clock.advance(0.1)
        if cluster.failovers:
            break
    assert cluster.failovers == 1
    assert wid not in cluster._workers
    cluster.close()


# ------------------------------------------------------- wire cluster

N_SESSIONS, N_SAMPLES, WINDOW, HOP = 6, 600, 100, 50


def _recordings():
    rng = np.random.default_rng(11)
    return [rng.normal(size=(N_SAMPLES, 3)).astype(np.float32)
            for _ in range(N_SESSIONS)]


def _single_server_events(recs, model=MODEL):
    """One in-process FleetServer fed the same hop-aligned rounds."""
    ref = FleetServer(
        model, window=WINDOW, hop=HOP, channels=3, smoothing="ema",
        config=FleetConfig(max_sessions=8, max_delay_ms=0.0),
    )
    for i in range(N_SESSIONS):
        ref.add_session(i)
    events: list = []
    cursors = [0] * N_SESSIONS
    while any(c < N_SAMPLES for c in cursors):
        for i in range(N_SESSIONS):
            if cursors[i] < N_SAMPLES:
                ref.push(i, recs[i][cursors[i] : cursors[i] + HOP])
                cursors[i] += HOP
        events.extend(ref.poll(force=True))
    events.extend(ref.flush())
    return events


@pytest.fixture(scope="module")
def wire_run(tmp_path_factory):
    """One NetCluster over three ``serve-worker`` subprocesses, driven in
    three phases: the owner of session 0 congested (its first polls
    answered late, ``LinkFaults``), then a healthy stretch in which
    another worker is SIGKILLed between rounds, then the rest."""
    root = str(tmp_path_factory.mktemp("wire_cluster"))
    recs = _recordings()
    out: dict = {}
    with _one_at_a_time(), child_hygiene():
        workers = launch_workers(
            root, 3, window=WINDOW, hop=HOP, max_delay_ms=0.0,
            deadline_s=CALM_DEADLINE_S, probe_deadline_s=CALM_DEADLINE_S,
            ready_timeout_s=600.0,
        )
        procs = {w.worker_id: w.process for w in workers}
        try:
            cluster = NetCluster(MODEL, root, _workers=workers,
                                 config=_net_cluster_config(),
                                 loader=lambda v: MODEL)
            for i in range(N_SESSIONS):
                cluster.add_session(i)
            events: list = []
            cursors = [0] * N_SESSIONS
            congested = cluster.worker_of(0)
            client = cluster._workers[congested]._client
            client.deadline_s, client.retries = 2.0, 8
            client.faults = LinkFaults("delay", method="poll", times=2)
            _drive_net_cluster(cluster, recs, cursors, 200, HOP, events)
            out["congested"] = congested
            out["congested_fired"] = client.faults.fired
            out["failovers_congested"] = cluster.failovers
            out["retries_congested"] = cluster.net_stats.rpc_retries
            client.deadline_s, client.retries, client.faults = CALM_DEADLINE_S, 2, None

            victim = next(w for w in cluster.workers if w != congested)
            killed = {"done": False}

            def on_round(c):
                if not killed["done"]:
                    procs[victim].kill()
                    procs[victim].wait()
                    killed["done"] = True

            _drive_net_cluster(cluster, recs, cursors, 400, HOP, events, on_round)
            _drive_net_cluster(cluster, recs, cursors, N_SAMPLES, HOP, events)
            out.update(victim=victim, events=events, stats=cluster.cluster_stats(),
                       rpc=cluster.transport_stats(), workers=cluster.workers)
            cluster.shutdown_workers()
            cluster.close()
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
    out["reference"] = _single_server_events(recs)
    return out


def test_net_cluster_bit_identical_to_single_server(wire_run):
    """The wire is invisible: subprocess workers over TCP, through a
    congested link and a real SIGKILL + failover, emit the same
    decision streams as one in-process FleetServer."""
    events = wire_run["events"]
    assert _by_session(events) == _by_session(wire_run["reference"])
    keys = [(e.session_id, e.event.t_index) for e in events]
    assert len(keys) == len(set(keys))  # zero double-scored
    acct = wire_run["stats"]["accounting"]
    assert acct["balanced"] and acct["pending"] == 0 and acct["dropped"] == 0
    assert acct["scored"] == len(events)
    rpc = wire_run["rpc"]
    assert rpc["rpc_sent"] > 0 and rpc["rpc_bytes_tx"] > 0 and rpc["rpc_bytes_rx"] > 0


def test_congested_worker_is_retried_not_failovered(wire_run):
    """Late answers from the congested worker show up as same-id RPC
    retries, never as a failover: it is still a member at the end."""
    assert wire_run["congested_fired"] == 2
    assert wire_run["retries_congested"] >= 2
    assert wire_run["failovers_congested"] == 0
    assert wire_run["congested"] in wire_run["workers"]


def test_sigkilled_worker_is_failed_over(wire_run):
    """Refused connections from the killed process strike, the lease
    runs out, and its partition migrates to the survivors."""
    stats = wire_run["stats"]
    assert stats["failovers"] == 1
    assert wire_run["victim"] not in wire_run["workers"]
    assert stats["retired"] == [wire_run["victim"]]
    assert max(stats["migrated_sessions"], stats["migrations"]) >= 1


def _run_cli_niced(args, timeout=900):
    """The port's CLI in a subprocess at ``nice 19`` (its workers
    inherit it), under the subprocess lock; the last stdout line's
    JSON."""
    with _one_at_a_time():
        proc = subprocess.run(
            ["nice", "-n", "19", sys.executable, "-m", "har_tpu_torch.cli", *args],
            capture_output=True, text=True, cwd=REPO, timeout=timeout,
            env={**os.environ, **CHILD_ENV,
                 "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")},
        )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_serve_workers_net_kill_worker(tmp_path):
    """``serve --workers 3 --net --kill-worker w1``: three worker
    processes on loopback, w1 SIGKILLed once windows are flowing; the
    summary balances with nothing dropped or pending, one failover, and
    as many windows scored as the in-process cluster scores."""
    out = _run_cli_niced(["serve", "--device", "cpu", "--workers", "3", "--net",
                          "--sessions", "24", "--kill-worker", "w1",
                          "--journal", str(tmp_path / "net")])
    assert out["transport"] == "tcp"
    assert out["killed_worker"] == "w1"
    assert out["failovers"] == 1 and out["workers"] == 2
    assert out["balanced"] is True and out["pending"] == 0 and out["dropped"] == 0
    assert out["scored"] == out["enqueued"] == out["n_events"] == 48
    assert out["migrated_sessions"] > 0
    assert out["rpc"]["rpc_sent"] > 0
    # the journal root stays, and no worker process outlived the run
    assert sorted(os.listdir(tmp_path / "net")) == ["w0", "w1", "w2"]


# ------------------------------------------------------ mixed cluster


class _HostThread:
    """One ``WorkerHost`` serving its RPCs on a loopback thread."""

    def __init__(self, host):
        self.host = host
        self.thread = threading.Thread(target=host.serve_forever, daemon=True)
        self.thread.start()

    def stop(self):
        self.host._shutdown = True
        self.thread.join(10.0)


def test_mixed_package_net_cluster_equals_single_server(tmp_path):
    """A port ``NetCluster`` over one ``har_tpu`` worker and one port
    worker, each a ``WorkerHost`` on a loopback thread: placement,
    pushes, polls, a hot swap broadcast and the accounting all cross
    the wire, and the decision streams equal one FleetServer's."""
    from har_tpu.serve.engine import FleetConfig as JaxConfig
    from har_tpu.serve.engine import FleetServer as JaxServer
    from har_tpu.serve.net.worker import WorkerHost as JaxHost
    from har_tpu.serve.net.worker import model_pool as jax_pool

    from har_tpu_torch.serve.net.worker import WorkerHost, model_pool

    hosts = []
    for wid, host_cls, server_cls, config_cls, pool in (
        ("w0", JaxHost, JaxServer, JaxConfig, jax_pool("demo")),
        ("w1", WorkerHost, FleetServer, FleetConfig, model_pool("demo")),
    ):
        jdir = str(tmp_path / wid)
        server = server_cls(
            pool["A"], window=WINDOW, hop=HOP, channels=3, smoothing="ema",
            config=config_cls(max_sessions=16, max_delay_ms=0.0),
            model_version="A", journal=jdir,
        )
        hosts.append(_HostThread(host_cls(wid, server, journal_dir=jdir, models=pool)))
    try:
        workers = [NetWorker(h.host.worker_id, h.host.rpc.host, h.host.rpc.port,
                             str(tmp_path / h.host.worker_id),
                             deadline_s=CALM_DEADLINE_S,
                             probe_deadline_s=CALM_DEADLINE_S)
                   for h in hosts]
        cluster = NetCluster(MODEL, str(tmp_path), _workers=workers,
                             config=_net_cluster_config(), loader=lambda v: MODEL)
        for i in range(N_SESSIONS):
            cluster.add_session(i)
        assert set(cluster.cluster_stats()["per_worker_sessions"].values()) != {0}
        recs = _recordings()
        events: list = []
        cursors = [0] * N_SESSIONS
        _drive_net_cluster(cluster, recs, cursors, N_SAMPLES // 2, HOP, events)
        cluster.swap_model(None, version="B")
        _drive_net_cluster(cluster, recs, cursors, N_SAMPLES, HOP, events)
        acct = cluster.accounting()
        assert acct["balanced"] and acct["pending"] == 0
        assert acct["scored"] == len(events)
        versions = [w.model_version() for w in cluster._workers.values()]
        assert versions == ["B", "B"]
        cluster.shutdown_workers()
        cluster.close()
    finally:
        for h in hosts:
            h.stop()

    # the reference swaps at the same sample on one server
    pool = {"A": MODEL, "B": AnalyticDemoModel(tau=5.0)}
    ref = FleetServer(pool["A"], window=WINDOW, hop=HOP, channels=3, smoothing="ema",
                      config=FleetConfig(max_sessions=16, max_delay_ms=0.0),
                      model_version="A")
    for i in range(N_SESSIONS):
        ref.add_session(i)
    ref_events: list = []
    for start in range(0, N_SAMPLES, HOP):
        if start == N_SAMPLES // 2:
            ref.swap_model(pool["B"], version="B")
        for i in range(N_SESSIONS):
            ref.push(i, recs[i][start : start + HOP])
        ref_events.extend(ref.poll(force=True))
    ref_events.extend(ref.flush())
    assert _by_session(events) == _by_session(ref_events)


# ------------------------------------------------------------ worker


def test_worker_warms_its_stack_before_the_ready_line(tmp_path, monkeypatch, capsys):
    """``serve-worker`` scores a warm-up window through every pool model
    before it prints ``{worker_id, host, port, pid}``, then serves until
    its idle timeout."""
    from har_tpu_torch.serve.net import worker as worker_mod

    warmed = []
    real = worker_mod._warm_up

    def spy(models, **kw):
        assert capsys.readouterr().out == ""  # nothing announced yet
        real(models, **kw)
        warmed.append(sorted(models))

    monkeypatch.setattr(worker_mod, "_warm_up", spy)
    rc = worker_mod.main(["--worker-id", "wq", "--journal", str(tmp_path / "wq"),
                          "--window", "100", "--hop", "50", "--max-idle-s", "0.2"])
    assert rc == 2  # the idle timeout: no controller ever called
    assert warmed == [["A", "B"]]
    ready = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert ready["worker_id"] == "wq" and ready["port"] > 0 and ready["pid"] == os.getpid()


def test_launch_names_a_worker_that_never_gets_ready(tmp_path):
    """A worker that exits before its ready line is a launch failure
    that names it and carries its stderr tail; no child is left
    running."""
    from har_tpu_torch.serve.cluster import ClusterError

    with child_hygiene(), pytest.raises(ClusterError,
                                        match=r"worker 'w0' never printed its ready line"):
        launch_workers(str(tmp_path), 1, model="nope")
    log = (tmp_path / "w0" / "worker.stderr.log").read_text()
    assert "invalid choice" in log


# ------------------------------------------------ once waiting (item 15)


def test_unported_parts_name_item_15(tmp_path):
    """What once waited for ROADMAP.md Queue 1 item 15 now keeps its
    contract: ``launch_agents`` starts a ``serve-agent`` that ships a
    journal; ``NetCluster(agents=)`` binds each agent to its transport
    counters; ``HAGatewayClient`` drives a gateway; the wire runners
    pass a ship point, a partition case and a gateway point (their full
    matrices live in tests/test_torch_{net_chaos,ship,gateway}.py).  The
    four wire bench lanes (item 16, ported) run beside ``har_tpu``'s on
    the same sizes and seeds (its worker and gateway processes niced as
    the port's): the same row keys, the seeded fields equal (migrated
    sessions, shipped bytes and chunks, none on the replicated failover
    path, frames and ack bytes, resumed sessions, contract_ok), the
    timings a float >= 0 in both."""
    from har_tpu_torch.serve.chaos import (
        GATEWAY_KILL_POINTS,
        SHIP_KILL_POINTS,
        NET_PARTITION_CASES,
    )
    from har_tpu_torch.serve.journal import FleetJournal, JournalConfig
    from har_tpu_torch.serve.net import launch_agents
    from har_tpu_torch.serve.net import smoke
    from har_tpu_torch.serve.net.chaos import (
        run_gateway_kill_point,
        run_net_kill_point,
        run_net_partition,
    )
    from har_tpu_torch.serve.net.client import HAGatewayClient
    from har_tpu_torch.serve.net.gateway import IngestGateway
    from har_tpu_torch.serve.net.ship import fetch_journal, journal_manifest
    from tests._torch_ranks import cell, run_cells

    import har_tpu.serve.net.controller as jax_controller
    import har_tpu.serve.net.gateway as jax_gateway
    from har_tpu.serve.net import smoke as jax_smoke

    jdir = tmp_path / "host" / "w0"
    server = FleetServer(MODEL, window=WINDOW, hop=HOP, channels=3, smoothing="ema",
                         config=FleetConfig(max_sessions=4, max_delay_ms=0.0),
                         journal=FleetJournal(str(jdir), JournalConfig(flush_every=4)))
    for i in range(2):
        server.add_session(i)
        server.push(i, np.ones((WINDOW, 3), np.float32))
    server.poll(force=True)
    server.journal.kill()
    from har_tpu_torch.serve.net.worker import WorkerHost, model_pool

    pool = model_pool("demo")
    live = _HostThread(WorkerHost(
        "w1", FleetServer(pool["A"], window=WINDOW, hop=HOP, channels=3, smoothing="ema",
                          config=FleetConfig(max_sessions=4, max_delay_ms=0.0),
                          model_version="A", journal=str(tmp_path / "w1")),
        journal_dir=str(tmp_path / "w1"), models=pool))
    with _one_at_a_time(), child_hygiene():
        handle = launch_agents({"w0": str(tmp_path / "host")})["w0"]
        try:
            client = handle.client()
            worker = NetWorker("w1", live.host.rpc.host, live.host.rpc.port,
                               str(tmp_path / "w1"), deadline_s=CALM_DEADLINE_S,
                               probe_deadline_s=CALM_DEADLINE_S)
            cluster = NetCluster(MODEL, str(tmp_path / "ctl"), _workers=[worker],
                                 agents={"w0": client}, loader=lambda v: MODEL)
            assert client._client.stats is cluster.net_stats
            out = fetch_journal(client, "w0", str(tmp_path / "staged"), chunk_bytes=1024,
                                stats=cluster.net_stats)
            assert out["bytes"] == sum(e["size"] for e in journal_manifest(str(jdir)))
            assert cluster.transport_stats()["shipped_bytes"] == out["bytes"]
            client.shutdown()
            cluster.close()
            assert handle.process.wait(timeout=60) == 0
        finally:
            live.stop()
            if handle.process.poll() is None:
                handle.process.kill()

    fleet = FleetCluster(MODEL, str(tmp_path / "fleet"), workers=2, window=WINDOW, hop=HOP,
                         smoothing="ema",
                         fleet_config=FleetConfig(max_sessions=8, max_delay_ms=0.0))
    gw = IngestGateway(fleet)
    stop = threading.Event()

    def serve():
        while not stop.is_set():
            gw.rpc.step(0.02)

    pump = threading.Thread(target=serve, daemon=True)
    pump.start()
    try:
        ha = HAGatewayClient([f"{gw.rpc.host}:{gw.rpc.port}"], deadline_s=CALM_DEADLINE_S)
        for i in range(3):
            ha.add_session(i)
        events = []
        for _ in range(2):
            for i in range(3):
                ha.push(i, np.ones((HOP, 3), np.float32))
            events.extend(ha.poll(force=True))
        events.extend(ha.flush())
        assert len(events) == 3  # one window a session: 2 hops = 1 window
        assert ha.accounting()["balanced"] and ha.reconnects == 0
        ha.close()
    finally:
        stop.set()
        pump.join(timeout=5)
        gw.close()
        fleet.close()

    results = run_cells({
        "ship": lambda: run_net_kill_point(SHIP_KILL_POINTS[1]),
        "partition": lambda: run_net_partition(NET_PARTITION_CASES[2]),
        "gateway": lambda: run_gateway_kill_point(GATEWAY_KILL_POINTS[0]),
    })
    for name in ("ship", "partition", "gateway"):
        verdict = cell(results, name)
        assert verdict["ok"], (name, verdict["why"])
        assert verdict.get("windows_lost", 0) == 0

    sizes = {"wire_failover_benchmark": 12, "journal_ship_benchmark": 12,
             "wire_ingest_benchmark": 24, "gateway_ha_benchmark": 8}
    benches = {(pkg, name): (lambda mod=mod, name=name, n=n: getattr(mod, name)([n], n_runs=1))
               for pkg, mod in (("port", smoke), ("jax", jax_smoke)) for name, n in sizes.items()}
    # one lane at a time: each starts 4-9 worker, agent and gateway
    # processes, and the JAX package's wall-clock tests share the cores
    niced = types.SimpleNamespace(**{**vars(subprocess), "Popen": _niced_popen})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_controller, "subprocess", niced)
        mp.setattr(jax_gateway, "subprocess", niced)
        results = run_cells(benches, max_workers=1)
    for name in sizes:
        (row,), (theirs,) = cell(results, ("port", name)), cell(results, ("jax", name))
        assert set(row) == set(theirs), name
        assert row["transport"] == "tcp" and row["contract_ok"] is True, (name, row)
        for key in BENCH_EQUAL_FIELDS[name]:
            assert row[key] == theirs[key], (name, key, row[key], theirs[key])
        for key in BENCH_TIMING_FIELDS[name]:
            for r in (row, theirs):
                assert isinstance(r[key], float) and r[key] >= 0, (name, key, r[key])
    rows = {name: cell(results, ("port", name))[0] for name in sizes}
    wire, ship = rows["wire_failover_benchmark"], rows["journal_ship_benchmark"]
    ingest, gw = rows["wire_ingest_benchmark"], rows["gateway_ha_benchmark"]
    assert wire["migrated_sessions"] > 0 and wire["failover_ms_median"] > 0
    assert ship["shipped_bytes"] > 0 and ship["chunks"] >= 1
    assert ship["ship_ms_median"] > 0 and ship["baseline_failover_ms_median"] > 0
    assert ship["replicated_steady_lag_records"] >= 0
    assert ingest["frames"] > 0 and ingest["windows_s_median"] > 0
    assert 0 < ingest["ack_bytes_per_window"] < ingest["per_record_bytes_per_window"]
    assert gw["failover_ms_median"] > 0 and gw["resumed_sessions"] >= 1
    for r in (gw, cell(results, ("jax", "gateway_ha_benchmark"))[0]):
        # how the clients met the flip (a dead socket or a moved receipt)
        # follows when each gateway renewed its lease, not the seed
        assert r["reconnects"] + r["moved_receipts"] >= 1


def _niced_popen(cmd, *args, **kwargs):
    return subprocess.Popen(["nice", "-n", str(CHILD_NICE), *cmd], *args, **kwargs)


# the fields of a wire bench row that the seeds decide, equal in both
# packages' runs, and its timings (each package's own, a float >= 0)
BENCH_EQUAL_FIELDS = {
    "wire_failover_benchmark": ("n_sessions", "workers", "transport", "migrated_sessions",
                                "contract_ok"),
    "journal_ship_benchmark": ("n_sessions", "workers", "transport", "shipped_bytes", "chunks",
                               "replicated_failover_path_bytes", "contract_ok"),
    "wire_ingest_benchmark": ("n_sessions", "workers", "transport", "frames",
                              "ack_bytes_per_window", "per_record_bytes_per_window",
                              "ack_coalesce_ratio", "contract_ok"),
    "gateway_ha_benchmark": ("n_sessions", "workers", "gateways", "transport",
                             "resumed_sessions", "contract_ok"),
}
BENCH_TIMING_FIELDS = {
    "wire_failover_benchmark": ("failover_ms_median", "failover_ms_std", "rpc_rtt_p50_ms",
                                "rpc_rtt_p99_ms"),
    "journal_ship_benchmark": ("ship_ms_median", "ship_ms_std", "failover_ms_median",
                               "baseline_failover_ms_median", "replicated_failover_ms_median"),
    "wire_ingest_benchmark": ("windows_s_median", "windows_s_std", "inproc_windows_s_median",
                              "event_p99_ms"),
    "gateway_ha_benchmark": ("failover_ms_median", "failover_ms_max"),
}
