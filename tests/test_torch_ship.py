"""Shared-nothing failover on the port (har_tpu_torch.serve.net.ship).

The JAX package's contracts (tests/test_ship.py) on the port: a dead
worker's journal shipped chunk by chunk from its host's agent into a
private staging directory restores as the in-place restore does; every
faulty transfer (truncated, reordered, duplicated, torn, garbled) is
refused or absorbed, never replayed; a mid-ship crash resumes from the
last durable chunk; a parked failover resumes when the agent comes
back; a corrupt source is quarantined; unsafe paths are refused.  Then,
against ``har_tpu`` on the same directories:

  - ``journal_manifest`` equals the JAX package's, and a fetch by either
    package writes the same ship log, byte for byte;
  - either package's ``fetch_journal`` pulls from the other's agent and
    the staged copy restores in both packages.

The ship-axis kill matrix (the victim worker SIGKILLed, then the agent
or the controller killed mid-transfer) and ``journal_ship_smoke`` run
over ``serve-worker`` and ``serve-agent`` processes started at ``nice
19`` with one thread each, a few at a time on threads of this process,
under the lock ``tests/_torch_ranks.py``'s rank groups take.
"""

import json
import os
import re
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from har_tpu_torch.monitoring import DriftMonitor
from har_tpu_torch.serve.chaos import SHIP_KILL_POINTS, _DEFAULT_AT
from har_tpu_torch.serve.engine import FleetConfig, FleetServer
from har_tpu_torch.serve.journal import (
    SHIP_DONE,
    SHIP_LOG,
    FleetJournal,
    JournalConfig,
    JournalError,
)
from har_tpu_torch.serve.loadgen import AnalyticDemoModel
from har_tpu_torch.serve.net.chaos import _net_cluster_config, run_net_kill_point
from har_tpu_torch.serve.net.controller import NetCluster, launch_workers
from har_tpu_torch.serve.net.rpc import LinkFaults, RpcServer
from har_tpu_torch.serve.net.ship import (
    ShipAgent,
    ShipClient,
    ShipError,
    ShipFaults,
    ShipTorn,
    ShipUnavailable,
    fetch_journal,
    journal_manifest,
    replay_ship_log,
)
from har_tpu_torch.serve.net.smoke import journal_ship_smoke
from tests._torch_ranks import _one_at_a_time, cell, child_hygiene, run_cells

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
MODEL = AnalyticDemoModel()


# ------------------------------------------------------------ fixtures


def _journaled_fleet(jdir, *, sessions=4, rounds=6, seed=0, snapshot_every=30):
    """A journaled fleet with real traffic, killed (the SIGKILL model):
    the directory a dead worker leaves."""
    server = FleetServer(
        MODEL, window=100, hop=50, channels=3, smoothing="ema",
        config=FleetConfig(max_sessions=sessions),
        journal=FleetJournal(jdir, JournalConfig(flush_every=8,
                                                 snapshot_every=snapshot_every)),
    )
    rng = np.random.default_rng(seed)
    for i in range(sessions):
        server.add_session(i)
    events = []
    for _ in range(rounds):
        for i in range(sessions):
            server.push(i, rng.normal(size=(50, 3)).astype(np.float32))
        events.extend(server.poll(force=True))
    server.journal.kill()
    return events


class _ServerThread:
    """An ``RpcServer`` (or an agent's) stepped on a background thread."""

    def __init__(self, srv, close=None):
        self.srv = srv
        self._close = close or srv.close
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            self.srv.step(0.02)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self._close()


class _AgentThread(_ServerThread):
    """An in-process ship agent of either package on a thread."""

    def __init__(self, root, agent_cls=ShipAgent):
        self.agent = agent_cls(root)
        super().__init__(self.agent.rpc, close=self.agent.close)

    def client(self, client_cls=ShipClient, **kw):
        return client_cls(self.agent.rpc.host, self.agent.rpc.port, **kw)


@pytest.fixture()
def shipped_env(tmp_path):
    """(client, host_root, jdir) over a killed journaled fleet."""
    host_root = tmp_path / "host"
    jdir = host_root / "w0"
    _journaled_fleet(str(jdir))
    srv = _AgentThread(str(host_root))
    client = srv.client()
    try:
        yield client, str(host_root), str(jdir)
    finally:
        client.close()
        srv.close()


def _dir_digest(root):
    """{relpath: bytes} of a journal dir's manifest file set."""
    out = {}
    for entry in journal_manifest(root):
        with open(os.path.join(root, entry["f"]), "rb") as f:
            out[entry["f"]] = f.read()
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ----------------------------------------------------- the happy path


def test_ship_roundtrip_is_byte_exact_and_restores(shipped_env, tmp_path):
    client, _, jdir = shipped_env
    dest = str(tmp_path / "staged" / "w0")
    out = fetch_journal(client, "w0", dest, chunk_bytes=1024)
    assert out["chunks"] > 1 and out["bytes"] > 0
    assert out["resumes"] == 0 and out["reshipped"] == 0
    assert _dir_digest(dest) == _dir_digest(jdir)
    shipped = FleetServer.restore(dest, MODEL)
    inplace = FleetServer.restore(jdir, MODEL)
    assert shipped.stats.accounting() == inplace.stats.accounting()
    assert sorted(shipped.sessions) == sorted(inplace.sessions)
    for sid in shipped.sessions:
        assert (shipped.export_session(sid)["ring"].tobytes()
                == inplace.export_session(sid)["ring"].tobytes())


def test_ship_is_idempotent_after_done(shipped_env, tmp_path):
    """A re-issued fetch of a completed transfer is a no-op: the done
    marker short-circuits before a single chunk."""
    client, _, _ = shipped_env
    dest = str(tmp_path / "w0")
    fetch_journal(client, "w0", dest, chunk_bytes=1024)
    before = _dir_digest(dest)
    again = fetch_journal(client, "w0", dest, chunk_bytes=1024)
    assert again == {"bytes": 0, "chunks": 0, "resumes": 0, "reshipped": 0, "files": 0}
    assert _dir_digest(dest) == before


def test_manifest_is_the_load_journal_file_set(shipped_env):
    """The manifest ships exactly what a restore reads: the newest
    complete snapshot's files + segments at/after its rotation."""
    client, _, jdir = shipped_env
    names = {e["f"] for e in client.manifest("w0")}
    snaps = sorted(n for n in os.listdir(jdir) if n.startswith("snap."))
    newest = snaps[-1]
    base = int(newest.split(".")[1])
    expect = {f"{newest}/state.json", f"{newest}/arrays.npz"}
    expect |= {n for n in os.listdir(jdir)
               if n.startswith("wal.") and int(n.split(".")[1]) >= base}
    assert names == expect


# ----------------------------------------------- against har_tpu


@pytest.mark.parametrize("snapshot_every", [0, 30])
def test_manifest_equals_jax(tmp_path, snapshot_every):
    """Both packages' ``journal_manifest`` on the same directory (one
    snapshot, or rotated segments): the same list, entry for entry."""
    from har_tpu.serve.net.ship import journal_manifest as jax_manifest

    jdir = str(tmp_path / "w0")
    _journaled_fleet(jdir, snapshot_every=snapshot_every, rounds=8)
    ours = journal_manifest(jdir)
    assert ours == jax_manifest(jdir)
    assert json.dumps(ours).encode() == json.dumps(jax_manifest(jdir)).encode()


def test_ship_log_and_staged_copy_equal_jax(shipped_env, tmp_path):
    """The same directory fetched by each package's ``fetch_journal``
    from the port's agent at the same chunk size: the ship logs, the
    done markers and every staged file are equal byte for byte."""
    from har_tpu.serve.net.ship import ShipClient as JaxClient
    from har_tpu.serve.net.ship import fetch_journal as jax_fetch

    client, host_root, _ = shipped_env
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    fetch_journal(client, "w0", ours, chunk_bytes=700)
    jax_client = JaxClient(client.host, client.port)
    try:
        jax_fetch(jax_client, "w0", theirs, chunk_bytes=700)
    finally:
        jax_client.close()
    assert _read(os.path.join(ours, SHIP_LOG)) == _read(os.path.join(theirs, SHIP_LOG))
    assert _read(os.path.join(ours, SHIP_DONE)) == _read(os.path.join(theirs, SHIP_DONE))
    assert _dir_digest(ours) == _dir_digest(theirs)


@pytest.mark.parametrize("direction", ["port_fetches_from_jax_agent",
                                       "jax_fetches_from_port_agent"])
def test_mixed_package_ship(tmp_path, direction):
    """A ``har_tpu`` ship agent serves the port's ``fetch_journal`` and
    the reverse; the staged copy is the source byte for byte, and both
    packages restore it to the in-place accounting."""
    from har_tpu.serve.engine import FleetServer as JaxServer
    from har_tpu.serve.loadgen import AnalyticDemoModel as JaxModel
    from har_tpu.serve.net.ship import ShipAgent as JaxAgent
    from har_tpu.serve.net.ship import ShipClient as JaxClient
    from har_tpu.serve.net.ship import fetch_journal as jax_fetch

    host_root = tmp_path / "host"
    jdir = str(host_root / "w0")
    _journaled_fleet(jdir)
    if direction == "port_fetches_from_jax_agent":
        srv, client_cls, fetch = _AgentThread(str(host_root), JaxAgent), ShipClient, fetch_journal
    else:
        srv, client_cls, fetch = _AgentThread(str(host_root)), JaxClient, jax_fetch
    client = srv.client(client_cls)
    dest = str(tmp_path / "staged")
    try:
        out = fetch(client, "w0", dest, chunk_bytes=512)
        assert client.list() == [{"name": "w0", "retired": False}]
    finally:
        client.close()
        srv.close()
    assert out["chunks"] > 1 and out["bytes"] == sum(e["size"] for e in journal_manifest(jdir))
    assert _dir_digest(dest) == _dir_digest(jdir)
    inplace = FleetServer.restore(jdir, MODEL).stats.accounting()
    assert FleetServer.restore(dest, MODEL).stats.accounting() == inplace
    assert JaxServer.restore(dest, JaxModel()).stats.accounting() == inplace


# --------------------------------------------- adversarial transfers


def _lying_chunk_server(jdir, mutate):
    """An RpcServer speaking the ship surface whose ship_chunk response
    is rewritten by ``mutate(meta, payload)``: the faulty peer the
    receiver must refuse."""
    agent = ShipAgent(os.path.dirname(jdir))
    handlers = dict(agent.rpc.handlers)
    real = handlers["ship_chunk"]

    def ship_chunk(meta, payload):
        rmeta, rpayload = real(meta, payload)
        return mutate(dict(rmeta), rpayload)

    handlers["ship_chunk"] = ship_chunk
    agent.rpc.close()
    return RpcServer(handlers)


@pytest.mark.parametrize(
    "name,mutate",
    [
        ("truncated", lambda m, p: (m, p[: max(0, len(p) - 3)])),
        ("reordered", lambda m, p: ({**m, "off": m["off"] + 1}, p)),
        ("wrong_file", lambda m, p: ({**m, "f": "wal.999.log"}, p)),
    ],
)
def test_mis_sequenced_chunk_responses_are_refused(tmp_path, name, mutate):
    host_root = tmp_path / "host"
    jdir = host_root / "w0"
    _journaled_fleet(str(jdir))
    srv = _ServerThread(_lying_chunk_server(str(jdir), mutate))
    client = ShipClient(srv.srv.host, srv.srv.port)
    dest = str(tmp_path / "staged")
    try:
        with pytest.raises(ShipError, match="mis-sequenced|short read"):
            fetch_journal(client, "w0", dest, chunk_bytes=512)
        with pytest.raises(JournalError, match="partially shipped"):
            FleetServer.restore(dest, MODEL)
    finally:
        client.close()
        srv.close()


def test_duplicated_chunk_frames_are_idempotent(shipped_env, tmp_path):
    """Every ship_chunk frame delivered twice (LinkFaults dup): the
    copy stays byte-exact and restores."""
    client, _, jdir = shipped_env
    client._client.faults = LinkFaults("dup", method="ship_chunk", times=10**9)
    dest = str(tmp_path / "w0")
    out = fetch_journal(client, "w0", dest, chunk_bytes=1024)
    assert out["chunks"] > 1
    assert _dir_digest(dest) == _dir_digest(jdir)
    assert FleetServer.restore(dest, MODEL).stats.accounting()["balanced"]


def test_garbled_chunk_refused_by_digest_and_reshipped(shipped_env, tmp_path):
    """A byte flipped between receive and disk: the whole-file digest
    refuses the file before any replay, it re-ships from zero, and the
    final copy is byte-exact."""
    client, _, jdir = shipped_env
    dest = str(tmp_path / "w0")
    out = fetch_journal(client, "w0", dest, chunk_bytes=1024,
                        faults=ShipFaults("garble", at=2))
    assert out["reshipped"] == 1
    assert _dir_digest(dest) == _dir_digest(jdir)


def _bad_manifest_server(jdir):
    """A ship server whose manifest digests can never be satisfied."""
    srv = _lying_chunk_server(jdir, lambda m, p: (m, p))
    real_manifest = srv.handlers["ship_manifest"]

    def bad_manifest(meta, payload):
        rmeta, rpayload = real_manifest(meta, payload)
        for entry in rmeta["files"]:
            entry["sha256"] = "0" * 64
        return rmeta, rpayload

    srv.handlers["ship_manifest"] = bad_manifest
    return srv, real_manifest


def test_corrupt_source_is_refused_never_replayed(tmp_path):
    """A source whose digests never verify: the re-ship budget runs out
    into a loud ShipError and the staging dir stays unrestorable."""
    jdir = tmp_path / "host" / "w0"
    _journaled_fleet(str(jdir))
    raw, _ = _bad_manifest_server(str(jdir))
    srv = _ServerThread(raw)
    client = ShipClient(srv.srv.host, srv.srv.port)
    dest = str(tmp_path / "staged")
    try:
        with pytest.raises(ShipError, match="digest"):
            fetch_journal(client, "w0", dest, chunk_bytes=512, reships=1)
        assert not os.path.exists(os.path.join(dest, SHIP_DONE))
        with pytest.raises(JournalError, match="partially shipped"):
            FleetServer.restore(dest, MODEL)
    finally:
        client.close()
        srv.close()


def test_agent_unreachable_is_ship_unavailable():
    client = ShipClient("127.0.0.1", 1)  # nobody listens on port 1
    with pytest.raises(ShipUnavailable):
        client.manifest("w0")
    client.close()


# ------------------------------------------------- resume / ship log


def test_ship_log_records_pinned_against_their_handlers():
    """Every ``{"t": "ship_..."}`` record the ship and tail modules
    append has a branch in the resume replay, and vice versa."""
    net = REPO / "har_tpu_torch" / "serve" / "net"
    src = (net / "ship.py").read_text()
    written = set(re.findall(r'append\(\s*\{"t": "(ship_\w+)"', src))
    written |= set(re.findall(r'append\(\s*\{"t": "(ship_\w+)"', (net / "tail.py").read_text()))
    handled = set(re.findall(r't == "(ship_\w+)"', src))
    assert written == handled == {
        "ship_begin", "ship_chunk", "ship_void", "ship_file", "ship_done", "ship_remanifest",
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resume_mid_ship_property(shipped_env, tmp_path, seed):
    """Kill the transfer at a random chunk (a torn receive), resume: the
    copy is byte-exact, durable pre-crash chunks are not pulled again,
    and the restore balances as the in-place one."""
    client, _, jdir = shipped_env
    rng = np.random.default_rng((seed, 0x5417))
    dest = str(tmp_path / f"w0_{seed}")
    kill_at = int(rng.integers(2, 12))
    with pytest.raises(ShipTorn):
        fetch_journal(client, "w0", dest, chunk_bytes=768,
                      faults=ShipFaults("torn", at=kill_at))
    prog = replay_ship_log(dest)
    assert not prog.done
    carried = sum(prog.offsets.values())
    out = fetch_journal(client, "w0", dest, chunk_bytes=768)
    assert out["resumes"] == 1
    total = sum(e["size"] for e in client.manifest("w0"))
    assert out["bytes"] == total - carried
    assert _dir_digest(dest) == _dir_digest(jdir)
    shipped = FleetServer.restore(dest, MODEL)
    inplace = FleetServer.restore(jdir, MODEL)
    assert shipped.stats.accounting() == inplace.stats.accounting()
    assert shipped.stats.accounting()["balanced"]


def test_crash_between_done_record_and_marker_resumes_clean(shipped_env, tmp_path):
    """Every digest verified and ship_done durable, the marker lost: the
    resume re-lands it from the log's verdict, pulling nothing."""
    client, _, _ = shipped_env
    dest = str(tmp_path / "w0")
    fetch_journal(client, "w0", dest, chunk_bytes=1024)
    os.remove(os.path.join(dest, SHIP_DONE))
    with pytest.raises(JournalError, match="digest|partially"):
        FleetServer.restore(dest, MODEL)
    out = fetch_journal(client, "w0", dest, chunk_bytes=1024)
    assert out["chunks"] == 0
    assert os.path.exists(os.path.join(dest, SHIP_DONE))
    assert FleetServer.restore(dest, MODEL).stats.accounting()["balanced"]


def test_half_shipped_directory_cannot_be_restored(shipped_env, tmp_path):
    """A staging dir holding ship.log without ship.done refuses the
    restore, whoever asks."""
    client, _, _ = shipped_env
    dest = str(tmp_path / "w0")
    with pytest.raises(ShipTorn):
        fetch_journal(client, "w0", dest, chunk_bytes=512, faults=ShipFaults("torn", at=3))
    assert os.path.exists(os.path.join(dest, SHIP_LOG))
    assert not os.path.exists(os.path.join(dest, SHIP_DONE))
    with pytest.raises(JournalError, match="digest"):
        FleetServer.restore(dest, MODEL)


def test_torn_ship_log_tail_truncated_on_resume(shipped_env, tmp_path):
    """A torn record at the end of ship.log is truncated before the
    resumed transfer appends, so a second crash's progress stays
    reachable."""
    client, _, jdir = shipped_env
    dest = str(tmp_path / "w0")
    with pytest.raises(ShipTorn):
        fetch_journal(client, "w0", dest, chunk_bytes=768, faults=ShipFaults("torn", at=4))
    with open(os.path.join(dest, SHIP_LOG), "ab") as f:
        f.write(b"\x40\x00\x00\x00garbage-torn-record")
    with pytest.raises(ShipTorn):
        fetch_journal(client, "w0", dest, chunk_bytes=768, faults=ShipFaults("torn", at=3))
    assert sum(replay_ship_log(dest).offsets.values()) > 0
    out = fetch_journal(client, "w0", dest, chunk_bytes=768)
    assert out["resumes"] == 1
    assert _dir_digest(dest) == _dir_digest(jdir)


def test_torn_log_then_resume_counts_progress(shipped_env, tmp_path):
    client, _, jdir = shipped_env
    dest = str(tmp_path / "w0")
    with pytest.raises(ShipTorn):
        fetch_journal(client, "w0", dest, chunk_bytes=768, faults=ShipFaults("torn", at=4))
    with open(os.path.join(dest, SHIP_LOG), "ab") as f:
        f.write(b"\x40\x00\x00\x00torn-tail")
    carried = sum(replay_ship_log(dest).offsets.values())
    assert carried > 0
    out = fetch_journal(client, "w0", dest, chunk_bytes=768)
    assert out["resumes"] == 1
    total = sum(e["size"] for e in client.manifest("w0"))
    assert out["bytes"] == total - carried
    assert _dir_digest(dest) == _dir_digest(jdir)


# ------------------------------ parked failover and the quarantine


class _DeadWorker:
    worker_id = "w0"

    def __init__(self, jdir):
        self.journal_dir = str(jdir)


def _bare_net_cluster(root, agents):
    """The fetch seam of a NetCluster without workers."""
    from har_tpu_torch.serve.stats import FleetStats

    cluster = NetCluster.__new__(NetCluster)
    cluster.root = root
    cluster.net_stats = FleetStats()
    cluster._agents = dict(agents)
    cluster._ship_quarantine = {}
    cluster._standbys = {}
    cluster._ship_chunk_bytes = 1024
    cluster.ship_ms = 0.0
    cluster.ship_transfers = []
    cluster.chaos = None
    return cluster


def test_failover_parks_when_agent_down_and_resumes_on_restart(tmp_path):
    """A dead worker whose host agent is down too parks the failover
    (``PartitionUnavailable``) and completes once ``register_agent``
    points at a live agent."""
    from har_tpu_torch.serve.cluster.controller import PartitionUnavailable

    jdir = tmp_path / "host" / "w0"
    _journaled_fleet(str(jdir))
    srv = _AgentThread(str(tmp_path / "host"))
    root = str(tmp_path / "ctl")
    os.makedirs(root)
    cluster = _bare_net_cluster(root, {"w0": ShipClient("127.0.0.1", 1)})
    try:
        with pytest.raises(PartitionUnavailable):
            cluster._fetch_partition(_DeadWorker(jdir))
        cluster.register_agent("w0", srv.client())
        dest = cluster._fetch_partition(_DeadWorker(jdir))
        assert dest == os.path.join(root, "_shipped", "w0")
        assert os.path.exists(os.path.join(dest, SHIP_DONE))
        assert cluster.net_stats.shipped_bytes > 0
        assert FleetServer.restore(dest, MODEL).stats.accounting()["balanced"]
    finally:
        for c in cluster._agents.values():
            c.close()
        srv.close()


def test_corrupt_source_quarantines_not_crash_loops(tmp_path):
    """A partition whose digests never verify degrades that partition
    only (``PartitionUnavailable`` and a warning), is not pulled again
    every poll, and ``register_agent`` lifts the quarantine."""
    import warnings

    from har_tpu_torch.serve.cluster.controller import PartitionUnavailable

    jdir = tmp_path / "host" / "w0"
    _journaled_fleet(str(jdir))
    raw, real_manifest = _bad_manifest_server(str(jdir))
    srv = _ServerThread(raw)
    root = str(tmp_path / "ctl")
    os.makedirs(root)
    cluster = _bare_net_cluster(root, {"w0": ShipClient(srv.srv.host, srv.srv.port)})
    try:
        with pytest.warns(RuntimeWarning, match="REFUSED"):
            with pytest.raises(PartitionUnavailable):
                cluster._fetch_partition(_DeadWorker(jdir))
        assert "w0" in cluster._ship_quarantine
        chunks_before = cluster.net_stats.ship_chunks
        with pytest.raises(PartitionUnavailable, match="quarantined"):
            cluster._fetch_partition(_DeadWorker(jdir))
        assert cluster.net_stats.ship_chunks == chunks_before
        raw.handlers["ship_manifest"] = real_manifest
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            cluster.register_agent("w0", ShipClient(srv.srv.host, srv.srv.port))
            dest = cluster._fetch_partition(_DeadWorker(jdir))
        assert dest is not None
        assert FleetServer.restore(dest, MODEL).stats.accounting()["balanced"]
    finally:
        for c in cluster._agents.values():
            c.close()
        srv.close()


def test_fetch_queue_survives_a_mid_retry_crash(tmp_path):
    """A crash while retrying the first parked failover keeps the rest
    of the fetch queue; only the in-flight entry is at risk."""
    from har_tpu_torch.serve.cluster.controller import FleetCluster

    cluster = FleetCluster(MODEL, str(tmp_path / "c"), workers=1, window=100, hop=100)
    cluster._fetch_queue = [("wA", _DeadWorker(tmp_path / "wA")),
                            ("wB", _DeadWorker(tmp_path / "wB"))]

    def boom(dead_wid, worker):
        raise RuntimeError(f"mid-retry crash on {dead_wid}")

    cluster._continue_failover = boom
    with pytest.raises(RuntimeError, match="wA"):
        cluster.poll(force=True)
    assert [wid for wid, _ in cluster._fetch_queue] == ["wB"]
    assert cluster.pending_failovers == 1
    cluster.close()


# --------------------------------------------------- agent hygiene


def test_agent_refuses_unsafe_paths(shipped_env):
    from har_tpu_torch.serve.net.rpc import RpcRemoteError

    client, _, _ = shipped_env
    for evil in ("../w0", "..", "./w0", "/etc", "a/b/c"):
        with pytest.raises((ShipError, RpcRemoteError)):
            client.manifest(evil)


def test_agent_lists_and_marks_retired(shipped_env):
    client, host_root, _ = shipped_env
    assert client.list() == [{"name": "w0", "retired": False}]
    assert client.retired("w0") is False
    client.retire("w0", {"worker_id": "w0", "accounting": {}})
    assert client.retired("w0") is True
    with open(os.path.join(host_root, "w0", "retired.json")) as f:
        assert json.load(f)["worker_id"] == "w0"


def test_serve_agent_cli_serves_a_journal(tmp_path):
    """``python -m har_tpu_torch.cli serve-agent`` (what ``launch_agents``
    starts) prints its ready line and ships a journal on request."""
    from har_tpu_torch.serve.net.controller import launch_agents

    host_root = tmp_path / "host"
    jdir = host_root / "w0"
    _journaled_fleet(str(jdir))
    with _one_at_a_time(), child_hygiene():
        handle = launch_agents({"w0": str(host_root)})["w0"]
        client = handle.client()
        try:
            out = fetch_journal(client, "w0", str(tmp_path / "staged"), chunk_bytes=2048)
            client.shutdown()
            assert handle.process.wait(timeout=30) == 0
        finally:
            client.close()
            if handle.process.poll() is None:
                handle.process.kill()
    assert out["bytes"] == sum(e["size"] for e in journal_manifest(str(jdir)))
    assert _dir_digest(str(tmp_path / "staged")) == _dir_digest(str(jdir))


# ------------------------------------ the shared-nothing chaos matrix


def test_ship_kill_points_declared_and_calibrated():
    assert SHIP_KILL_POINTS == ("mid_ship_send", "mid_ship_recv", "post_ship_pre_drain")
    for p in SHIP_KILL_POINTS:
        assert p in _DEFAULT_AT


@pytest.fixture(scope="module")
def wire_cells():
    """The ship-axis cells and the smoke, two at a time: four at once
    left a worker past its 30 s ready-line deadline on a loaded host."""
    cells = {point: (lambda p=point: run_net_kill_point(p))
             for point in SHIP_KILL_POINTS}
    cells["smoke"] = lambda: journal_ship_smoke()
    return run_cells(cells, max_workers=2)


@pytest.mark.parametrize("point", SHIP_KILL_POINTS)
def test_ship_axis_kill_matrix(wire_cells, point):
    """The victim worker SIGKILLed with its journal in a private host
    directory, then the transfer killed at ``point``: the sending agent
    (restarted; the parked failover resumes from the last durable
    chunk), the receiving controller (the takeover resumes the staged
    transfer) or after the verify (the takeover restores the staged
    copy).  Streams equal to the un-killed in-process run, nothing lost
    or scored twice, and the mid-ship kills really resume."""
    out = cell(wire_cells, point)
    assert out["ok"], (point, out["why"])
    assert out["windows_lost"] == 0
    assert out["failovers"] >= 1 and out["migrated_sessions"] >= 1
    assert out["shipped_bytes"] > 0
    if point in ("mid_ship_send", "mid_ship_recv"):
        assert out["ship_resumes"] >= 1


def test_journal_ship_smoke_verdict_green(wire_cells):
    """3 workers with private journal dirs and agents, one SIGKILLed:
    the failover rides the shipped journal only."""
    out = cell(wire_cells, "smoke")
    assert out["ok"], out["why"]
    assert out["private_dirs"] is True
    assert out["shipped_bytes"] > 0 and out["chunks"] >= 1
    assert out["resumes"] == 0
    assert out["windows_lost"] == 0
    json.dumps(out)


# ------------------------------------------- drift over the wire


def _drifted_net_fleet(root, priv, *, n_sessions, drifted):
    """A 2-process net cluster with monitored sessions, ``drifted`` of
    them pushed a +25 population shift."""
    workers = launch_workers(root, 2, window=100, hop=100, journal_root=priv)
    cluster = NetCluster(MODEL, root, _workers=workers, config=_net_cluster_config(),
                         loader=lambda ver: MODEL)
    rng = np.random.default_rng(7)
    for i in range(n_sessions):
        cluster.add_session(i, monitor=DriftMonitor(np.zeros(3), np.ones(3), halflife=50.0,
                                                    patience=2))
    for _ in range(4):
        for i in range(n_sessions):
            chunk = rng.normal(size=(100, 3)).astype(np.float32)
            if i < drifted:
                chunk = chunk + 25.0
            cluster.push(i, chunk)
        cluster.poll(force=True)
    return cluster, [w.process for w in workers]


@pytest.mark.parametrize("drifted", [4, 3])
def test_observe_drift_across_workers_with_private_journals(tmp_path, drifted):
    """K = 4 sessions drifting across two worker processes (journals in
    private host directories) fire the fleet-global trigger once; the
    same reports pulled again are no-ops; K - 1 do not fire."""
    from collections import Counter

    from har_tpu_torch.adapt.trigger import RetrainTrigger, TriggerConfig

    K = 4
    root, priv = str(tmp_path / "root"), str(tmp_path / "priv")
    with _one_at_a_time(), child_hygiene():
        cluster, procs = _drifted_net_fleet(root, priv, n_sessions=K + 2, drifted=drifted)
        try:
            assert len(Counter(cluster._placement[i] for i in range(K))) == 2
            trigger = RetrainTrigger(TriggerConfig(min_sessions=K, window_s=1e9,
                                                   cooldown_s=0.0, recovery_patience=1))
            cluster.observe_drift(trigger)
            job = trigger.poll()
            if drifted == K:
                assert job is not None and sorted(job.session_ids) == list(range(K))
                cluster.observe_drift(trigger)
                assert trigger.poll() is None
            else:
                assert job is None
            cluster.shutdown_workers()
            cluster.close()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            shutil.rmtree(root, ignore_errors=True)
            shutil.rmtree(priv, ignore_errors=True)
