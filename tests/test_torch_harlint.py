"""harlint over the port (har_tpu_torch.analyze).

HL002-HL005 and HL008 run as in the JAX package: every snippet of
``tests/test_harlint.py`` for those rules (its inline fixtures and its
mutations of ``har_tpu``'s real files), with ``har_tpu`` renamed to
``har_tpu_torch``, goes through ``har_tpu.analyze.lint_sources`` and the
port's, and both must report the same findings (rule, path, line).
HL001, HL006 and HL007 are retargeted to torch, so they get torch
fixtures, positive and negative (and the one HL008 snippet on the real
JAX dispatch.py, whose annotations sit on JAX syncs, is replaced by the
same mutation of the port's dispatch.py).  Then the acceptance mutations on
in-memory copies of the port's real files, the repo-clean contract
over the port's fileset and baseline, and the ``lint`` CLI.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from har_tpu_torch.analyze import (
    LintReport,
    default_rules,
    lint_sources,
    run_harlint,
)
from har_tpu_torch.analyze.baseline import DEFAULT_BASELINE, load_baseline
from har_tpu_torch.analyze.callgraph import CallGraph
from har_tpu_torch.analyze.core import DEFAULT_FILESET, FileContext
from har_tpu_torch.analyze.hotpath import HotPathRule
from har_tpu_torch.analyze.jitpurity import JitPurityRule
from har_tpu_torch.analyze.partitionspec import PartitionSpecRule
from har_tpu_torch.analyze.statecheck import StateCompletenessRule
from har_tpu_torch.analyze.journalcheck import JournalExhaustivenessRule
from har_tpu_torch.analyze.suppressions import SuppressionAuditRule

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ALL_RULES = [f"HL00{i}" for i in range(1, 9)]
_RENAME = re.compile(r"\bhar_tpu\b(?!_torch)")


def _to_port(text: str) -> str:
    return _RENAME.sub("har_tpu_torch", text)


def _real(rel: str) -> str:
    return (REPO / rel).read_text()


def _replaced(text: str, old: str, new: str, count: int = -1) -> str:
    out = text.replace(old, new, count)
    assert out != text, f"anchor changed: {old[:60]!r}"
    return out


# ------------------------------------------ the shared HL002-HL005, HL008


_STATS = """
class Stats:
    _COUNTERS = ("a", "b")

    def __init__(self):
        self.a = 0
        self.b = 0
        self.c = 0
        self._private = []

    def state(self):
        return {{"counters": {{k: getattr(self, k) for k in self._COUNTERS}},
                {c_state}}}

    def load_state(self, state):
        for k, v in state.get("counters", {{}}).items():
            if k in self._COUNTERS:
                setattr(self, k, v)
        {c_load}
"""
_COMPLETE = _STATS.format(c_state='"c": self.c', c_load='self.c = state.get("c", 0)')
_MISSING = _STATS.format(c_state='"x": 1', c_load="pass")

_ENGINE = """
class Engine:
    def push(self):
        self._jappend({"t": "push", "sid": 1}, b"")

    def ack(self):
        self._jappend({"t": "ack", "sid": 1})
"""
_RECOVER = """
def restore(records):
    for meta, payload in records:
        t = meta.get("t")
        if t == "push":
            pass
        elif t == "ack":
            pass
"""
_CHAOS = """
KILL_POINTS = ("pre_dispatch",)
ENGINE_KILL_POINTS = ()
_DEFAULT_AT = {"pre_dispatch": 1}
"""
_CHAOS_CALL = """
class Engine2:
    def poll(self):
        self._chaos("pre_dispatch")
"""


def _hl003(engine=_ENGINE, recover=_RECOVER, chaos=_CHAOS, calls=_CHAOS_CALL):
    return {
        "har_tpu/serve/engine.py": engine + calls,
        "har_tpu/serve/recover.py": recover,
        "har_tpu/serve/chaos.py": chaos,
    }


_LIST_ENGINE = """
class Engine:
    def push(self):
        self._jappend({"t": "push", "sid": 1}, b"")

    def trace(self, events):
        events.append({"t": "window", "sid": 1})
        self.log.append({"t": "poll"})
"""
_LIST_RECOVER = """
def restore(records):
    for meta, payload in records:
        t = meta.get("t")
        if t == "push":
            pass
"""
_HL004_BAD = """
import random
import time
import numpy as np

def step(sessions):
    now = time.time()
    jitter = random.random()
    rng = np.random.default_rng()
    noise = np.random.rand(3)
    for sid in {s for s in sessions}:
        pass
    return [x for x in set(sessions)]
"""
_HL004_GOOD = """
import time
import numpy as np

class Engine:
    def __init__(self, clock=None):
        self._clock = clock or time.monotonic  # injectable default

    def step(self, seed, sessions):
        now = self._clock()
        rng = np.random.default_rng(seed)
        dur = time.perf_counter()  # duration reporting, not decisions
        for sid in sorted(set(sessions)):
            pass
        return now, rng, dur
"""
_HL004_GAP = """
import datetime
import time

class Registry:
    def __init__(self, clock=None):
        self._clock = clock or time.time      # callable, not a call

    def stamp(self):
        a = datetime.datetime.now()
        b = datetime.datetime.utcnow()
        return a, b
"""
_HL004_GAP_OK = (
    _HL004_GAP.replace("time.time", "time.monotonic")
    .replace("a = datetime.datetime.now()", "a = None")
    .replace("b = datetime.datetime.utcnow()", "b = None")
)
_LEASE = """
import random
import time

class Lease:
    def __init__(self, wall=None):
        self._wall = wall or time.time      # callable ref

    def expires(self):
        return time.time() + 1.0            # direct call

    def jitter(self, peers):
        bad = random.random()               # still illegal in net/
        for p in {x for x in peers}:        # still illegal in net/
            pass
        return bad
"""
_HL005_BAD = """
import json
import os

def save(path, meta):
    with open(path, "w") as f:
        json.dump(meta, f)

def swap(tmp, dst):
    os.replace(tmp, dst)
"""
_HL005_GOOD = """
import json
import os
from har_tpu.utils.durable import atomic_write, fsync_dir

def save(path, meta):
    atomic_write(path, json.dumps(meta))

def explicit(path, data):
    with open(path, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path, path + ".final")
    fsync_dir(os.path.dirname(path))

def reader(path):
    with open(path) as f:
        return f.read()

def stash_handle(path):
    # open for append, nothing written here: the fsync lives in flush()
    return open(path, "ab")
"""
_HL005_SCOPE = 'def f(p, d):\n    with open(p, "w") as fh:\n        fh.write(d)\n'
_HL008_LIVE = """
import numpy as np

class Scorer:
    def fetch(self, handle, k):
        return np.asarray(handle[:k])  # harlint: fetch-ok
"""
_HL008_UNJUDGED = """
import numpy as np

class Scorer:
    def fetch(self, handle, k):
        return handle[:k]  # harlint: fetch-ok
"""

# the journal-writing and replay files of har_tpu that HL003's real-tree
# snippets lint together
_HL003_REAL = (
    "har_tpu/serve/engine.py",
    "har_tpu/serve/recover.py",
    "har_tpu/serve/chaos.py",
    "har_tpu/serve/journal.py",
    "har_tpu/serve/cluster/controller.py",
    "har_tpu/serve/net/ship.py",
    "har_tpu/serve/net/tail.py",
    "har_tpu/serve/net/gateway.py",
    "har_tpu/serve/net/client.py",
    "har_tpu/adapt/swap.py",
)


def _hl003_real(rel=None, old=None, new=None, *more):
    sources = {r: _real(r) for r in _HL003_REAL}
    edits = [(rel, old, new)] + [tuple(more[i:i + 3]) for i in range(0, len(more), 3)]
    for r, o, n in edits:
        if r is not None:
            sources[r] = _replaced(sources[r], o, n)
    return sources


def _one(rel, text):
    return {rel: text}


# id -> (sources builder, rule names); the JAX package's snippets
SHARED = {
    "hl002_complete": (lambda: _one("har_tpu/serve/stats.py", _COMPLETE), ["HL002"]),
    "hl002_missing": (lambda: _one("har_tpu/serve/stats.py", _MISSING), ["HL002"]),
    "hl002_ephemeral": (lambda: _one("har_tpu/serve/stats.py", _MISSING.replace(
        "self.c = 0", "self.c = 0  # harlint: ephemeral")), ["HL002"]),
    "hl002_table_deletion": (lambda: _one("har_tpu/serve/stats.py", _COMPLETE.replace(
        '_COUNTERS = ("a", "b")', '_COUNTERS = ("a",)')), ["HL002"]),
    "hl002_real_fleetstats_minus_field": (lambda: _one(
        "har_tpu/serve/stats.py", _replaced(_real("har_tpu/serve/stats.py"),
                                            '"model_swaps", "rollbacks",',
                                            '"model_swaps",')), ["HL002"]),
    "hl002_real_arena": (lambda: _one("har_tpu/serve/arena.py",
                                      _real("har_tpu/serve/arena.py")), ["HL002"]),
    "hl002_real_arena_minus_slot_array": (lambda: _one(
        "har_tpu/serve/arena.py", _replaced(_real("har_tpu/serve/arena.py"),
                                            '"vote_len", "vote_head",',
                                            '"vote_head",')), ["HL002"]),
    "hl002_real_pending_minus_column": (lambda: _one(
        "har_tpu/serve/arena.py", _replaced(
            _real("har_tpu/serve/arena.py"),
            '"dropped", "launched", "next_idx", "refs",',
            '"dropped", "launched", "refs",')), ["HL002"]),
    "hl003_bijection": (_hl003, ["HL003"]),
    "hl003_written_without_handler": (lambda: _hl003(recover=_RECOVER.replace(
        'elif t == "ack":\n            pass', "pass")), ["HL003"]),
    "hl003_handler_without_writer_and_drift": (lambda: _hl003(
        engine=_ENGINE.replace('self._jappend({"t": "ack", "sid": 1})', "pass"),
        chaos=_CHAOS.replace('("pre_dispatch",)', '("pre_dispatch", "mid_never")')),
        ["HL003"]),
    "hl003_point_missing_from_matrix": (lambda: _hl003(
        calls=_CHAOS_CALL.replace('"pre_dispatch"', '"post_new_stage"')), ["HL003"]),
    "hl003_list_append_is_not_a_record": (lambda: {
        "har_tpu/serve/engine.py": _LIST_ENGINE,
        "har_tpu/serve/recover.py": _LIST_RECOVER}, ["HL003"]),
    "hl003_journal_append_is_a_record": (lambda: {
        "har_tpu/serve/engine.py": _LIST_ENGINE.replace(
            "self.log.append", "self._journal.append"),
        "har_tpu/serve/recover.py": _LIST_RECOVER}, ["HL003"]),
    "hl003_real_tree": (_hl003_real, ["HL003"]),
    "hl003_real_minus_lost": (lambda: _hl003_real(
        "har_tpu/serve/recover.py", 'elif t == "lost":', 'elif t == "__deleted__":'),
        ["HL003"]),
    "hl003_real_minus_handoff": (lambda: _hl003_real(
        "har_tpu/serve/recover.py", 'elif t == "handoff":', 'elif t == "__deleted__":'),
        ["HL003"]),
    "hl003_real_minus_adopt": (lambda: _hl003_real(
        "har_tpu/serve/recover.py", 'elif t == "adopt":', 'elif t == "__gone__":'),
        ["HL003"]),
    "hl003_real_cluster_matrix": (lambda: _hl003_real(
        "har_tpu/serve/chaos.py",
        'CLUSTER_KILL_POINTS = ("mid_handoff", "mid_migration")',
        'CLUSTER_KILL_POINTS = ("mid_migration",)'), ["HL003"]),
    "hl003_real_minus_ship_chunk": (lambda: _hl003_real(
        "har_tpu/serve/net/ship.py", 'elif t == "ship_chunk":',
        'elif t == "__deleted__":'), ["HL003"]),
    "hl003_real_ship_matrix": (lambda: _hl003_real(
        "har_tpu/serve/chaos.py", '    "mid_ship_recv",\n', ""), ["HL003"]),
    "hl003_real_minus_acks": (lambda: _hl003_real(
        "har_tpu/serve/recover.py", 'elif t == "acks":', 'elif t == "__deleted__":'),
        ["HL003"]),
    "hl003_real_live_type_retired": (lambda: _hl003_real(
        "har_tpu/serve/recover.py", 'RETIRED_RECORD_TYPES = ("ack",)',
        'RETIRED_RECORD_TYPES = ("ack", "acks")'), ["HL003"]),
    "hl003_real_retirement_dropped": (lambda: _hl003_real(
        "har_tpu/serve/recover.py", 'RETIRED_RECORD_TYPES = ("ack",)',
        "RETIRED_RECORD_TYPES = ()"), ["HL003"]),
    "hl003_real_retired_without_handler": (lambda: _hl003_real(
        "har_tpu/serve/recover.py", 'elif t == "ack":', 'elif t == "__gone__":'),
        ["HL003"]),
    "hl003_real_minus_remanifest": (lambda: _hl003_real(
        "har_tpu/serve/net/ship.py", 'elif t == "ship_remanifest":',
        'elif t == "__deleted__":'), ["HL003"]),
    "hl003_real_tail_matrix": (lambda: _hl003_real(
        "har_tpu/serve/chaos.py", '    "mid_tail_recv",\n', ""), ["HL003"]),
    "hl003_real_gateway_matrix": (lambda: _hl003_real(
        "har_tpu/serve/chaos.py", '    "mid_frame_recv",\n', ""), ["HL003"]),
    "hl003_real_moved_handler": (lambda: _hl003_real(
        "har_tpu/serve/net/client.py", '"moved" in resp', '"m0ved" in resp',
        "har_tpu/serve/net/client.py", 'resp.get("moved")', 'resp.get("m0ved")'),
        ["HL003"]),
    "hl003_real_moved_writer": (lambda: _hl003_real(
        "har_tpu/serve/net/gateway.py", '{"moved": self._leader_addr()}',
        '{"m0ved": None}'), ["HL003"]),
    "hl004_wall_clock_and_global_rng": (lambda: _one(
        "har_tpu/serve/engine.py", _HL004_BAD), ["HL004"]),
    "hl004_seeded_and_injected": (lambda: _one(
        "har_tpu/serve/engine.py", _HL004_GOOD), ["HL004"]),
    "hl004_scope_serving": (lambda: _one(
        "har_tpu/serving.py", "import time\nnow = time.time()\n"), ["HL004"]),
    "hl004_scope_adapt": (lambda: _one(
        "har_tpu/adapt/trigger.py", "import time\nnow = time.time()\n"), ["HL004"]),
    "hl004_clock_callables_and_datetime": (lambda: _one(
        "har_tpu/adapt/registry2.py", _HL004_GAP), ["HL004"]),
    "hl004_monotonic_default": (lambda: _one(
        "har_tpu/adapt/registry2.py", _HL004_GAP_OK), ["HL004"]),
    "hl004_real_registry": (lambda: _one(
        "har_tpu/adapt/registry.py", _real("har_tpu/adapt/registry.py")), ["HL004"]),
    "hl004_real_registry_unannotated": (lambda: _one(
        "har_tpu/adapt/registry.py", _replaced(
            _real("har_tpu/adapt/registry.py"), "        # harlint: disable=HL004\n",
            "")), ["HL004"]),
    "hl004_net_allowlist": (lambda: _one(
        "har_tpu/serve/net/election2.py", _LEASE), ["HL004"]),
    "hl004_outside_net": (lambda: _one(
        "har_tpu/serve/lease_helper.py", _LEASE), ["HL004"]),
    "hl004_real_engine": (lambda: _one(
        "har_tpu/serve/engine.py", _real("har_tpu/serve/engine.py")), ["HL004"]),
    "hl004_real_engine_planted": (lambda: _one(
        "har_tpu/serve/engine.py", _replaced(
            _real("har_tpu/serve/engine.py"),
            "    def poll(self, *, force: bool = False)",
            "    def _wall_now(self):\n        return time.time()\n\n"
            "    def poll(self, *, force: bool = False)", 1)), ["HL004"]),
    "hl004_real_net_sources": (lambda: {
        r: _real(r) for r in ("har_tpu/serve/net/rpc.py",
                              "har_tpu/serve/net/election.py",
                              "har_tpu/serve/net/chaos.py")}, ["HL004"]),
    "hl004_disable_counts": (lambda: _one(
        "har_tpu/serve/engine.py",
        "import time\nnow = time.time()  # harlint: disable=HL004\n"), ["HL004"]),
    "hl004_disable_does_not_bleed": (lambda: _one(
        "har_tpu/serve/engine.py",
        "import time\na = time.time()  # harlint: disable=HL004\nb = time.time()\n"),
        ["HL004"]),
    "hl005_unsynced_write_and_bare_replace": (lambda: _one(
        "har_tpu/adapt/registry.py", _HL005_BAD), ["HL005"]),
    "hl005_durable_discipline": (lambda: _one(
        "har_tpu/serve/journal.py", _HL005_GOOD), ["HL005"]),
    "hl005_scope_engine": (lambda: _one("har_tpu/serve/engine.py", _HL005_SCOPE),
                           ["HL005"]),
    "hl005_scope_journal": (lambda: _one("har_tpu/serve/journal.py", _HL005_SCOPE),
                            ["HL005"]),
    "hl005_real_registry": (lambda: _one(
        "har_tpu/adapt/registry.py", _real("har_tpu/adapt/registry.py")), ["HL005"]),
    "hl005_real_registry_unfixed": (lambda: _one(
        "har_tpu/adapt/registry.py", _replaced(
            _real("har_tpu/adapt/registry.py"),
            "_atomic_write(\n                os.path.join(path, _META), "
            "json.dumps(meta, indent=1)\n            )",
            'with open(os.path.join(path, _META), "w") as f:\n'
            "                json.dump(meta, f, indent=1)")), ["HL005"]),
    "hl008_live_fetch_ok": (lambda: _one(
        "har_tpu/serve/dispatch.py", _HL008_LIVE), ["HL001", "HL008"]),
    "hl008_stale_fetch_ok": (lambda: _one(
        "har_tpu/serve/dispatch.py",
        _HL008_LIVE.replace("np.asarray(handle[:k])", "handle[:k]")),
        ["HL001", "HL008"]),
    "hl008_owner_rule_did_not_run": (lambda: _one(
        "har_tpu/serve/dispatch.py", _HL008_UNJUDGED), ["HL004", "HL008"]),
    "hl008_stale_disable": (lambda: _one(
        "har_tpu/serve/engine.py", "import time\nnow = 1  # harlint: disable=HL004\n"),
        ["HL004", "HL008"]),
}


def _rules(package: str, ids):
    mod = __import__(f"{package}.analyze", fromlist=["default_rules"])
    return [r for r in mod.default_rules() if r.rule_id in ids]


def _keyed(findings):
    return [(f.rule, f.path, f.line) for f in findings]


@pytest.mark.parametrize("case", sorted(SHARED))
def test_shared_fixture_same_findings(case):
    """A JAX-package snippet for HL002-HL005 / HL008, renamed into the
    port's tree, gives the port's linter the findings it gives
    ``har_tpu.analyze``: same rule, path (renamed) and line."""
    from har_tpu.analyze import lint_sources as jax_lint_sources

    build, ids = SHARED[case]
    sources = build()
    want = jax_lint_sources(sources, _rules("har_tpu", ids))
    got = lint_sources({_to_port(k): _to_port(v) for k, v in sources.items()},
                       _rules("har_tpu_torch", ids))
    assert _keyed(got) == [(r, _to_port(p), ln) for r, p, ln in _keyed(want)]
    assert [f.symbol for f in got] == [f.symbol for f in want]


def test_shared_fixtures_fire():
    """The shared cases are not all silent: each rule fires on its
    positive snippets (so the equality above compares findings)."""
    fired = set()
    for build, ids in SHARED.values():
        sources = {_to_port(k): _to_port(v) for k, v in build().items()}
        fired |= {f.rule for f in lint_sources(sources, _rules("har_tpu_torch", ids))}
    assert fired == {"HL002", "HL003", "HL004", "HL005", "HL008"}


# ----------------------------------------------------- HL001 on torch


_LAUNCH = {
    "har_tpu_torch/serve/engine.py": """
from har_tpu_torch.serve.dispatch import Staging, Scorer

class FleetServer:
    def __init__(self):
        self._staging = Staging()
        self._scorer = Scorer()

    def _launch_batch(self):
        windows = self._staging.gather([0])
        return self._scorer.launch(windows)
""",
    "har_tpu_torch/serve/dispatch.py": """
import numpy as np
import torch

class Staging:
    def __init__(self):
        self.buf = np.zeros((8, 3), np.float32)
        self.slots = np.arange(8)

    def gather(self, slots):
        idx = self.slots[slots].tolist()      # numpy: no device
        return self.summarize(self.buf[idx])

    def summarize(self, rows):
        return rows.cpu()                     # on no name list

class Scorer:
    def __init__(self):
        self.device = torch.device("cpu")

    def launch(self, windows):
        x = torch.from_numpy(windows).to(self.device, non_blocking=True)
        return x.to(torch.float32)

    def fetch(self, handle, k):
        return handle[:k].cpu()  # harlint: fetch-ok
""",
}


def _launch_fixture(**edits):
    out = dict(_LAUNCH)
    for rel, (old, new) in edits.items():
        out[rel] = _replaced(out[rel], old, new)
    return out


def test_hl001_cpu_in_a_helper_reachable_from_launch():
    """A ``.cpu()`` in a helper two calls below ``_launch_batch`` (through
    a typed attribute), on no name list, is flagged with its reach
    chain; the numpy ``.tolist()``, the non-blocking copy, the dtype
    ``.to`` and the annotated fetch are not."""
    findings = lint_sources(dict(_LAUNCH), [HotPathRule()])
    assert [(f.symbol, f.line) for f in findings] == [("Staging.summarize", 15)]
    assert "`.cpu()`" in findings[0].message
    assert "reached from launch root `FleetServer._launch_batch`" in findings[0].message


def test_hl001_same_line_under_fetch_ok_in_fetch():
    """The same ``.cpu()`` is the allowed sink in ``fetch`` under
    ``fetch-ok`` and a finding there without it."""
    clean = _launch_fixture(**{"har_tpu_torch/serve/dispatch.py": (
        "        return rows.cpu()                     # on no name list",
        "        return rows")})
    assert lint_sources(clean, [HotPathRule(), SuppressionAuditRule()]) == []
    bare = _launch_fixture(**{"har_tpu_torch/serve/dispatch.py": (
        "return handle[:k].cpu()  # harlint: fetch-ok", "return handle[:k].cpu()")})
    found = [f for f in lint_sources(bare, [HotPathRule()]) if f.symbol == "Scorer.fetch"]
    assert len(found) == 1 and "without the `# harlint: fetch-ok`" in found[0].message


@pytest.mark.parametrize("sync", [
    "x.item()", "x.tolist()", "x.numpy()", "torch.cuda.synchronize()",
    "torch.cuda.current_stream().synchronize()", "self.event.synchronize()",
])
def test_hl001_hard_syncs_resist_host_ok(sync):
    """Every torch hard sync on the launch path is a finding, and
    ``host-ok`` does not excuse it."""
    src = _launch_fixture(**{"har_tpu_torch/serve/dispatch.py": (
        "        return x.to(torch.float32)",
        f"        # harlint: host-ok\n        {sync}\n        return x.to(torch.float32)")})
    findings = lint_sources(src, [HotPathRule()])
    launch = [f for f in findings if f.symbol == "Scorer.launch"]
    assert len(launch) == 1, [f.render() for f in findings]
    assert "forces a host sync" in launch[0].message


def test_hl001_soft_sync_and_host_ok():
    """``np.asarray`` on the launch path is a soft sync: flagged, and
    excused by a reviewed ``host-ok``."""
    line = "        x = torch.from_numpy(windows).to(self.device, non_blocking=True)"
    soft = _launch_fixture(**{"har_tpu_torch/serve/dispatch.py": (
        line, line.replace("from_numpy(windows)", "from_numpy(np.asarray(windows))"))})
    assert [f.symbol for f in lint_sources(soft, [HotPathRule()])
            if "np.asarray" in f.message] == ["Scorer.launch"]
    reviewed = _launch_fixture(**{"har_tpu_torch/serve/dispatch.py": (
        line, "        # harlint: host-ok\n"
        + line.replace("from_numpy(windows)", "from_numpy(np.asarray(windows))"))})
    assert [f.symbol for f in lint_sources(reviewed, [HotPathRule()])] == [
        "Staging.summarize"]


def test_hl001_blocking_copy_in():
    """A host tensor copied to a device without ``non_blocking=True`` is a
    hard sync (the pageable copy waits for the stream); a
    device-to-device ``.to`` of an argument is not judged."""
    line = "        x = torch.from_numpy(windows).to(self.device, non_blocking=True)"
    blocking = _launch_fixture(**{"har_tpu_torch/serve/dispatch.py": (
        line, "        x = torch.from_numpy(windows).to(self.device)")})
    found = [f for f in lint_sources(blocking, [HotPathRule()]) if f.symbol == "Scorer.launch"]
    assert len(found) == 1 and "blocking host-to-device" in found[0].message
    local = _launch_fixture(**{"har_tpu_torch/serve/dispatch.py": (
        line, "        t = torch.as_tensor(windows)\n        x = t.cuda()")})
    assert [f.symbol for f in lint_sources(local, [HotPathRule()])
            if "blocking" in f.message] == ["Scorer.launch"]
    d2d = _launch_fixture(**{"har_tpu_torch/serve/dispatch.py": (
        line, "        x = windows.to(self.device)")})
    assert not [f for f in lint_sources(d2d, [HotPathRule()]) if "blocking" in f.message]


def test_hl001_compiled_bodies():
    """A sync inside a ``torch.compile`` body or a fake kernel is an
    HL001 finding even off the launch path."""
    src = """
import torch

@torch.compile
def step(x):
    return x.sum().item()

def build(op):
    @op.register_fake
    def fake(x):
        return x.cpu()
    return fake

def plain(x):
    return x.sum().item()

fast = torch.compile(plain)
"""
    findings = lint_sources({"har_tpu_torch/serve/loadgen.py": src}, [HotPathRule()])
    assert sorted(f.symbol for f in findings) == ["build.fake", "plain", "step"]
    assert all("inside a compiled body" in f.message for f in findings)


def test_callgraph_resolves_port_modules():
    """Imports under ``har_tpu_torch.*`` resolve across files."""
    ctxs = [FileContext(rel, src) for rel, src in sorted(_LAUNCH.items())]
    graph = CallGraph(ctxs)
    roots = [fi for fi in graph.functions.values() if fi.name == "_launch_batch"]
    quals = {graph.functions[k].qual for k in graph.reachable(roots)}
    assert {"Staging.gather", "Staging.summarize", "Scorer.launch"} <= quals


# ----------------------------------------------------- HL006 on torch


_EXPORTED = """
import time
import torch
from torch import nn

hits = []

class Core(nn.Module):
    def forward(self, x):
        return helper(self, x)

def helper(mod, x):
    mod.calls = 1
    hits.append(x)
    print("tracing", x.shape)
    t = time.perf_counter()
    return x * 2

def export_it(example):
    core = Core()
    return torch.export.export(core, (example,))
"""


def test_hl006_export_forward_closure():
    """``torch.export.export`` of a module traces its ``forward``: the
    closure's captured mutation, print and clock are flagged there."""
    findings = lint_sources({"har_tpu_torch/serve/loadgen.py": _EXPORTED},
                            [JitPurityRule()])
    msgs = " | ".join(f.message for f in findings)
    assert {f.symbol for f in findings} == {"helper"}
    assert "`.append(...)` on closed-over `hits`" in msgs
    assert "`print(...)`" in msgs and "time.perf_counter()" in msgs
    assert "traced via `Core.forward` -> `helper`" in msgs
    pure = _EXPORTED.replace(
        "    mod.calls = 1\n    hits.append(x)\n    print(\"tracing\", x.shape)\n"
        "    t = time.perf_counter()\n", "")
    assert lint_sources({"har_tpu_torch/serve/loadgen.py": pure}, [JitPurityRule()]) == []


def test_hl006_vmap_cuda_graph_and_self_mutation():
    src = """
import torch

class Model:
    def make(self):
        def local_step(x):
            self.calls = self.calls + 1
            return x

        return torch.func.vmap(local_step)

def step(x):
    torch.cuda.synchronize()
    return x + 1

def capture(g, x):
    with torch.cuda.graph(g):
        y = step(x)
    return y
"""
    findings = lint_sources({"har_tpu_torch/serve/loadgen.py": src}, [JitPurityRule()])
    got = {(f.symbol, "self.calls" in f.message, ".synchronize()" in f.message)
           for f in findings}
    assert got == {("Model.make.local_step", True, False), ("step", False, True)}


def test_hl006_compiled_sync_stays_hl001():
    """A sync directly in a compiled body is HL001's finding only."""
    src = "import torch\n\n@torch.compile\ndef step(x):\n    return x.item()\n"
    both = lint_sources({"har_tpu_torch/serve/loadgen.py": src},
                        [HotPathRule(), JitPurityRule()])
    assert [f.rule for f in both] == ["HL001"]
    fake = ("import torch\n\n@torch.library.register_fake('ns::op')\n"
            "def fake(x):\n    return x.new_empty(x.shape)\n")
    assert lint_sources({"har_tpu_torch/serve/loadgen.py": fake},
                        [HotPathRule(), JitPurityRule()]) == []


# ----------------------------------------------------- HL007 on DTensor


_SPEC = """
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import local_map

from har_tpu_torch.parallel.rules import P, placements

DP_AXIS = "dp"
TP_AXIS = "tp"

TOY_RULES = (
    (r"in\\.weight$", P(TP_AXIS, None)),
    (r"in\\.bias$", P(TP_AXIS)),
    (r".*", P()),
)

def dense_specs(params, tp_axis=TP_AXIS):
    return {k: P(tp_axis, None) if i % 2 == 0 else P(None, tp_axis)
            for i, k in enumerate(params)}

def place(x, mesh, spec):
    return distribute_tensor(x, mesh, placements(spec, mesh))

def local(fn, mesh, where):
    def body(q, k):
        return fn(q, k)

    return local_map(body, (where,), (where, where), device_mesh=mesh)
"""


def _hl007(src):
    return lint_sources({"har_tpu_torch/parallel/fixture.py": src}, [PartitionSpecRule()])


def test_hl007_clean_fixture():
    assert _hl007(_SPEC) == []


@pytest.mark.parametrize("old,new,message", [
    ("P(TP_AXIS)),", 'P("tpp")),', "axis `tpp` is not a declared mesh axis"),
    ("distribute_tensor(x, mesh, placements(spec, mesh))",
     "distribute_tensor(x, mesh)", "`distribute_tensor(...)` without placements"),
    ("local_map(body, (where,), (where, where), device_mesh=mesh)",
     "local_map(body, (where,), device_mesh=mesh)", "without in_placements"),
    ("local_map(body, (where,), (where, where), device_mesh=mesh)",
     "local_map(body, (where,), (where,), device_mesh=mesh)",
     "declares 1 placements but `body` takes 2"),
    ("local_map(body, (where,), (where, where), device_mesh=mesh)",
     "local_map(body, (where,), (None, None), device_mesh=mesh)",
     "every `in_placements` entry of this local_map is `None`"),
    ('    (r".*", P()),\n)', "    )", "does not end in the replicating"),
    ("P(TP_AXIS, None)),", "P()),", "splits the model axis only on 1-D leaves"),
    (("P(TP_AXIS, None)),", "P()),", "P(TP_AXIS)),", "P()),"), None, "shards nothing"),
    ("return {k: P(tp_axis, None) if i % 2 == 0 else P(None, tp_axis)",
     "return {k: P() if i % 2 == 0 else P(tp_axis)",
     "spec builder `dense_specs` produces no ≥2-dim"),
])
def test_hl007_fires(old, new, message):
    src = _SPEC
    # a tuple of (old, new) pairs, flattened, for a case of two edits
    pairs = zip(old[::2], old[1::2]) if isinstance(old, tuple) else [(old, new)]
    for o, n in pairs:
        src = _replaced(src, o, n)
    findings = _hl007(src)
    assert any(message in f.message for f in findings), [f.message for f in findings]


def test_hl007_spec_ok_is_a_reviewed_escape():
    src = _replaced(_SPEC, "    return distribute_tensor(x, mesh, placements(spec, mesh))",
                    "    # replicated on purpose: a small table every rank reads\n"
                    "    # harlint: spec-ok\n    return distribute_tensor(x, mesh)")
    assert lint_sources({"har_tpu_torch/parallel/fixture.py": src},
                        [PartitionSpecRule(), SuppressionAuditRule()]) == []


# ------------------------------- acceptance mutations on the port's files


def _port(*rels):
    return {rel: _real(rel) for rel in rels}


def test_acceptance_fleetstats_field_deleted_from_state():
    sources = _port("har_tpu_torch/serve/stats.py")
    assert lint_sources(dict(sources), [StateCompletenessRule()]) == []
    mutated = {"har_tpu_torch/serve/stats.py": _replaced(
        sources["har_tpu_torch/serve/stats.py"], '"model_swaps", "rollbacks",',
        '"model_swaps",')}
    findings = lint_sources(mutated, [StateCompletenessRule()])
    assert {f.symbol for f in findings} == {"FleetStats.rollbacks"}
    assert len(findings) == 2  # absent from state() AND load_state()


def test_acceptance_replay_handler_deleted_from_recover():
    sources = _port(*(_to_port(r) for r in _HL003_REAL))
    assert lint_sources(dict(sources), [JournalExhaustivenessRule()]) == []
    rel = "har_tpu_torch/serve/recover.py"
    sources[rel] = _replaced(sources[rel], 'elif t == "lost":', 'elif t == "__deleted__":')
    msgs = " | ".join(f.message for f in lint_sources(sources, [JournalExhaustivenessRule()]))
    assert "'lost'" in msgs and "no replay handler" in msgs
    assert "'__deleted__'" in msgs


_HL007_PORT = (
    "har_tpu_torch/parallel/rules.py",
    "har_tpu_torch/parallel/tensor_parallel.py",
    "har_tpu_torch/parallel/mesh.py",
    "har_tpu_torch/parallel/expert_parallel.py",
    "har_tpu_torch/parallel/pipeline_parallel.py",
    "har_tpu_torch/parallel/data_parallel.py",
    "har_tpu_torch/parallel/sharding.py",
    "har_tpu_torch/serve/dispatch.py",
)


def test_acceptance_mesh_axis_typo_in_a_rule_table():
    sources = _port(*_HL007_PORT)
    assert lint_sources(dict(sources), [PartitionSpecRule()]) == []
    rel = "har_tpu_torch/parallel/rules.py"
    sources[rel] = _replaced(sources[rel], '(r"^experts(/|$)", P("ep")),',
                             '(r"^experts(/|$)", P("epp")),')
    msgs = " | ".join(f.message for f in lint_sources(sources, [PartitionSpecRule()]))
    assert "`epp` is not a declared mesh axis" in msgs


def test_acceptance_deleted_kernel_specs():
    """Every kernel rule of the real tables degraded to ``P()``: the
    dense tables keep only their biases split (flagged), the int8 table
    shards nothing (flagged)."""
    sources = _port(*_HL007_PORT)
    rel = "har_tpu_torch/parallel/rules.py"
    sources[rel] = _replaced(_replaced(sources[rel], "P(None, TP_AXIS)),", "P()),"),
                             "P(TP_AXIS, None)),", "P()),")
    findings = lint_sources(sources, [PartitionSpecRule()])
    msgs = " | ".join(f.message for f in findings)
    assert "FULLY REPLICATED" in msgs
    for family in ("DENSE_MLP_RULES", "TRANSFORMER_RULES", "INT8_RULES"):
        assert f"`{family}`" in msgs, family


# the launch path's files: the engine, the scorers, the arenas whose
# numpy columns the launch reads, the helpers it reaches
_LAUNCH_PATH = (
    "har_tpu_torch/serve/engine.py", "har_tpu_torch/serve/dispatch.py",
    "har_tpu_torch/serve/arena.py", "har_tpu_torch/serve/stats.py",
    "har_tpu_torch/serving.py", "har_tpu_torch/utils/backoff.py",
    "har_tpu_torch/parallel/mesh.py", "har_tpu_torch/parallel/rules.py",
    "har_tpu_torch/parallel/sharding.py", "har_tpu_torch/serve/model_parallel.py",
)


def test_acceptance_stale_annotation():
    rels = _LAUNCH_PATH
    sources = _port(*rels)
    rules = lambda: [HotPathRule(), SuppressionAuditRule()]  # noqa: E731
    before = {(f.rule, f.symbol) for f in lint_sources(dict(sources), rules())}
    assert before <= {("HL001", "DeviceScorer._place"), ("HL001", "ShardedScorer._place")}
    rel = "har_tpu_torch/serve/dispatch.py"
    sources[rel] = _replaced(
        sources[rel], "return np.asarray(handle[:k], np.float64)  # harlint: fetch-ok",
        "return handle[:k]  # harlint: fetch-ok")
    stale = [f for f in lint_sources(sources, rules()) if f.rule == "HL008"]
    assert [f.symbol for f in stale] == ["HostScorer.fetch"]
    assert "stale `# harlint: fetch-ok`" in stale[0].message


# the copy into the card through a pinned buffer, and the pageable copy
# it replaced (it waits for every kernel queued before it)
_STAGED = "        return self._staging.put(x, [(slice(None), self.device)])[0]\n"
_PAGEABLE = "        return torch.from_numpy(x).to(self.device)\n"


def test_acceptance_sync_below_launch_and_the_logged_copy_in():
    """A ``.cpu()`` planted in ``_split_predict`` (reached only through
    ``_launch_batch`` -> ``_get_scorer`` -> ``make_scorer`` ->
    ``DeviceScorer.__init__``) is flagged, and so is a pageable copy into
    the card planted back in ``DeviceScorer._place``; the launch path's
    copies go through pinned buffers, so nothing else is flagged and the
    baseline is empty."""
    rels = _LAUNCH_PATH
    sources = _port(*rels)
    assert lint_sources(dict(sources), [HotPathRule()]) == []
    rel = "har_tpu_torch/serve/dispatch.py"
    pageable = dict(sources)
    pageable[rel] = _replaced(sources[rel], _STAGED, _PAGEABLE)
    blocking = lint_sources(pageable, [HotPathRule()])
    assert [f.symbol for f in blocking] == ["DeviceScorer._place"]
    assert "blocking host-to-device" in blocking[0].message
    sources[rel] = _replaced(sources[rel], "    pre = None\n    inner = model\n",
                             "    pre = None\n    model.weight.cpu()\n    inner = model\n")
    planted = [f for f in lint_sources(sources, [HotPathRule()])
               if f.symbol == "_split_predict"]
    assert len(planted) == 1 and "`.cpu()`" in planted[0].message
    assert "reached from launch root" in planted[0].message
    assert load_baseline(REPO / DEFAULT_BASELINE) == set()


# ------------------------------------------------------- repo + baseline


def test_repo_lints_clean_with_the_port_baseline():
    """The contract: the port's fileset with the port's own baseline
    gives zero findings, eight rules run, and the baseline is empty (the
    copies into the card no longer wait)."""
    report = run_harlint()
    assert report.ok, "\n" + report.render()
    assert report.rules_run == ALL_RULES
    assert report.files >= 50
    assert report.baseline_path == DEFAULT_BASELINE
    assert report.baseline_size == 0 and report.baselined == 0
    assert report.annotation_suppressed >= 28
    assert report.per_rule == {r: 0 for r in ALL_RULES}
    assert all(p.startswith("har_tpu_torch/") for p in DEFAULT_FILESET)


def test_port_never_uses_the_root_baseline(tmp_path):
    """The root ``harlint_baseline.json`` is the JAX package's: the port
    reads its own, and with an empty one the port has no finding."""
    assert DEFAULT_BASELINE == "har_tpu_torch/harlint_baseline.json"
    empty = tmp_path / "b.json"
    report = run_harlint(baseline=empty, rules=[HotPathRule()])
    assert report.findings == [] and report.baselined == 0
    assert not empty.exists()


# ----------------------------------------------------------------- CLI


def _cli(capsys, *argv):
    from har_tpu_torch.cli import main

    rc = main(["lint", *argv])
    return rc, capsys.readouterr().out


def test_cli_lint_json_and_rc(capsys):
    rc, out = _cli(capsys, "--json")
    report = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and report["ok"] is True and report["findings"] == 0
    assert report["rules_run"] == ALL_RULES
    for key in ("suppressed", "baselined", "baseline_size", "per_rule",
                "rule_ms", "callgraph_ms", "lint_ms", "files"):
        assert key in report
    assert set(report) == set(LintReport([], 0, 0, [], 0, "", 0).to_json())


def test_cli_lint_rc_1_on_a_finding_and_update_baseline(capsys, tmp_path, monkeypatch):
    """On a copy of the fileset with the pageable copy into the card
    planted back in ``DeviceScorer._place``: rc 1 naming it, then an
    updated baseline holds it and the check passes."""
    import shutil

    import har_tpu_torch.analyze as analyze

    root = tmp_path / "checkout"
    for rel in DEFAULT_FILESET:
        src = REPO / rel
        if src.is_dir():
            shutil.copytree(src, root / rel, ignore=shutil.ignore_patterns("__pycache__"))
        else:
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, root / rel)
    rel = "har_tpu_torch/serve/dispatch.py"
    (root / rel).write_text(_replaced(_real(rel), _STAGED, _PAGEABLE))
    monkeypatch.setattr(analyze, "repo_root", lambda: root)
    base = tmp_path / "b.json"
    rc, out = _cli(capsys, "--rule", "HL001", "--baseline", str(base))
    assert rc == 1 and "DeviceScorer._place" in out
    rc, _ = _cli(capsys, "--rule", "HL001", "--baseline", str(base),
                 "--update-baseline")
    assert rc == 0 and len(load_baseline(base)) == 1
    rc, out = _cli(capsys, "--rule", "HL001", "--baseline", str(base), "--check")
    assert rc == 0 and out.strip().startswith("harlint: 0 finding(s), ")


def test_cli_lint_rule_filter_dedupes_and_refuses_unknown(capsys):
    rc, out = _cli(capsys, "--rule", "HL005", "--rule", "HL005", "--json")
    assert rc == 0 and json.loads(out.strip().splitlines()[-1])["rules_run"] == ["HL005"]
    with pytest.raises(SystemExit):
        _cli(capsys, "--rule", "HL099")


def test_cli_lint_paths_stats_and_changed(capsys, monkeypatch):
    rc, out = _cli(capsys, "har_tpu_torch/utils/durable.py", "--check", "--stats")
    assert rc == 0
    assert "harlint --stats (per-rule):" in out and "callgraph build:" in out
    import har_tpu_torch.analyze as analyze

    monkeypatch.setattr(analyze, "changed_fileset_paths", lambda root, ref: [])
    rc, out = _cli(capsys, "--changed", "--json")
    report = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and report["files"] == 0 and report["rules_run"] == []
    with pytest.raises(SystemExit):
        _cli(capsys, "har_tpu_torch/serving.py", "--changed")


def test_cli_lint_loads_no_torch_jax_or_har_tpu():
    """``lint --check`` in a fresh interpreter leaves torch, jax and
    har_tpu out of ``sys.modules``."""
    code = (
        "import json, sys\n"
        "from har_tpu_torch.cli import main\n"
        "rc = main(['lint', '--check'])\n"
        "print(json.dumps({'rc': rc, 'loaded': sorted(m for m in "
        "('torch', 'jax', 'har_tpu', 'numpy') if m in sys.modules)}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "loaded": []}


def test_default_rules_are_the_eight():
    assert [r.rule_id for r in default_rules()] == ALL_RULES
