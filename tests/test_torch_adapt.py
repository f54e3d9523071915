"""Online adaptation subsystem (har_tpu_torch.adapt).

The JAX package's tests/test_adapt.py on the port, with the imports
renamed, ``device="cpu"`` where a model or the CLI takes a device, and
the int8 fleet on ``JitDemoModel(device="cpu")``.  It pins the
contracts the drift loop ships on:
  1. registry — monotone version ids, parent-hash lineage, atomic
     current pointer, promote/rollback/prune (rollback target survives
     a prune);
  2. trigger — K-session common-channel escalation, cooldown debounce,
     onset de-duplication (one episode alerts once; a monitor reset
     re-arms cleanly), hysteresis on recovery;
  3. shadow — bounded-fraction sampling, agreement accounting, gates;
  4. swap — a FORCED mid-run hot-swap under the fault-injection
     harness (FakeClock + DispatchFaults) completes with ZERO dropped
     windows and bit-identical scores for every window dispatched
     before the swap point; a shadow-gate failure leaves the incumbent
     serving; an injected post-swap SLO regression triggers automatic
     rollback to the prior registry version;
  5. accounting — enqueued == scored + dropped + pending holds across
     a swap at the N=64 equivalence pin, per version and in total.
The port against ``har_tpu`` on the same inputs is in
tests/test_torch_adapt_cross.py.
"""

import json

import numpy as np
import pytest
import torch

from har_tpu_torch.adapt import (
    AdaptationConfig,
    AdaptationEngine,
    DriftAggregator,
    ModelRegistry,
    ReplayBuffer,
    RetrainTrigger,
    ShadowConfig,
    ShadowEvaluator,
    TriggerConfig,
    adapt_smoke,
    data_fingerprint,
    register_classical,
)
from har_tpu_torch.monitoring import DriftMonitor, DriftReport
from har_tpu_torch.serve import (
    DispatchFaults,
    FakeClock,
    FleetConfig,
    FleetServer,
)

torch.set_num_threads(1)


class _StubModel:
    """Row-deterministic numpy stand-in (same as test_fleet_serving):
    per-row results are bit-identical under any batch composition."""

    num_classes = 3

    def transform(self, x):
        from har_tpu_torch.models.base import Predictions

        x = np.asarray(x)
        m = x.mean(axis=(1, 2))
        raw = np.stack([-m, m, np.zeros_like(m)], axis=-1)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return Predictions.from_raw(raw, e / e.sum(axis=-1, keepdims=True))


class _OtherModel(_StubModel):
    """A genuinely different decision rule — post-swap events must
    change, pre-swap events must not."""

    def transform(self, x):
        from har_tpu_torch.models.base import Predictions

        x = np.asarray(x)
        m = x.mean(axis=(1, 2))
        raw = np.stack([m, np.zeros_like(m), -m], axis=-1)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return Predictions.from_raw(raw, e / e.sum(axis=-1, keepdims=True))


class _CorrectiveModel(_StubModel):
    """What a real drift retrain produces: identical decisions on
    in-distribution windows, DIFFERENT (corrected) decisions on the
    far-out-of-distribution ones — the candidate the agreement gate
    must not reject."""

    def transform(self, x):
        from har_tpu_torch.models.base import Predictions

        x = np.asarray(x)
        m = x.mean(axis=(1, 2))
        raw = np.stack([-m, m, np.zeros_like(m)], axis=-1)
        raw[np.abs(m) > 10.0] = (0.0, 0.0, 10.0)  # drifted → class 2
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return Predictions.from_raw(raw, e / e.sum(axis=-1, keepdims=True))


def _recordings(n_sessions, n_samples=450, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(n_samples, channels)).astype(np.float32)
        for _ in range(n_sessions)
    ]


def _report(drifting, onset, z=(5.0, 0.0, 0.0), n=1000):
    return DriftReport(
        drifting=drifting,
        location_z=np.asarray(z, np.float64),
        scale_log_ratio=np.zeros(3),
        n_samples=n,
        onset=onset,
    )


# ---------------------------------------------------------------- registry


def test_registry_lineage_and_atomic_pointer(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    assert reg.current() is None
    v1 = reg.register(
        lambda p: open(f"{p}/weights.bin", "wb").write(b"\x00" * 64),
        note="first",
        promote=True,
    )
    # a second version chains to the first's artifact hash
    v2 = reg.register(
        lambda p: open(f"{p}/weights.bin", "wb").write(b"\x01" * 64),
        metrics={"accuracy": 0.9},
        data_fingerprint="abc123",
    )
    assert (v1.version, v2.version) == (1, 2)
    assert v2.parent_sha256 == v1.sha256
    assert v2.metrics == {"accuracy": 0.9}
    assert v2.data_fingerprint == "abc123"
    assert reg.current().version == 1  # registering does not promote
    reg.promote(2)
    assert reg.current().version == 2
    # the pointer survives a fresh registry handle (it's on disk)
    assert ModelRegistry(str(tmp_path / "reg")).current().version == 2


def test_registry_rollback_and_history(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.register(None, promote=True)
    reg.register(None)
    reg.promote(2)
    rolled = reg.rollback()
    assert rolled.version == 1
    assert reg.current().version == 1
    events = [h["event"] for h in reg.history()]
    assert events == ["promote", "promote", "rollback"]
    # nothing before v1: rolling back the bootstrap refuses loudly
    with pytest.raises(RuntimeError, match="predecessor"):
        reg.rollback()


def test_registry_ids_monotone_across_prune(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    for _ in range(5):
        reg.register(None)
    reg.promote(4)
    reg.promote(5)  # predecessor of current is now 4
    pruned = reg.prune(keep=2)
    # oldest go first; current (5) and its rollback target (4) survive
    assert pruned == [1, 2, 3]
    assert [v.version for v in reg.versions()] == [4, 5]
    # a new registration continues the monotone sequence — pruned ids
    # are never reissued as different models
    assert reg.register(None).version == 6


def test_registry_failed_save_leaves_no_half_version(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))

    def bad_save(path):
        raise OSError("disk full")

    with pytest.raises(OSError):
        reg.register(bad_save)
    assert reg.versions() == []
    assert reg.register(None).version == 2  # the id was still consumed


def test_register_classical_roundtrip_with_lineage(tmp_path):
    from har_tpu_torch.checkpoint import (
        load_classical_model,
        load_model_meta,
        version_info,
    )
    from har_tpu_torch.models.logistic_regression import LogisticRegressionModel

    model = LogisticRegressionModel(
        coefficients=np.arange(12, dtype=np.float32).reshape(4, 3),
        intercept=np.zeros(3, np.float32),
        num_classes=3,
    )
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.register(None, promote=True)  # bootstrap incumbent
    fp = data_fingerprint(np.ones((4, 8, 3), np.float32))
    mv = register_classical(reg, model, data_fingerprint=fp)
    # the checkpoint inside the version dir is loadable and carries the
    # registry's lineage in its own meta
    restored = load_classical_model(mv.path, "cpu")
    np.testing.assert_array_equal(
        restored.coefficients, model.coefficients
    )
    info = version_info(load_model_meta(mv.path))
    assert info["version"] == mv.version == 2
    assert info["parent_sha256"] == reg.get(1).sha256
    assert isinstance(info["created_unix"], int)
    assert mv.data_fingerprint == fp


def test_registry_atomic_writes_fsync_and_leave_no_tmp(tmp_path):
    """The registry's durability: CURRENT / NEXT_ID / promotions.jsonl go
    through the fsync-before-rename helper — no stray .tmp files
    survive a clean pass, and the pointer round-trips through a fresh
    handle (the on-disk format is unchanged)."""
    import os

    root = str(tmp_path / "reg")
    reg = ModelRegistry(root)
    reg.register(None, promote=True)
    reg.register(None)
    reg.promote(2)
    reg.rollback()
    leftovers = [
        f for f in os.listdir(root) if f.endswith(".tmp")
    ]
    assert leftovers == []
    reg2 = ModelRegistry(root)
    assert reg2.current().version == 1
    assert [h["event"] for h in reg2.history()] == [
        "promote", "promote", "rollback",
    ]


def test_registry_version_metadata_write_is_durable(tmp_path):
    """Regression for the finding harlint HL005 surfaced at its
    introduction: a version's registry.json was the one registry write
    still on a bare buffered open/json.dump — a crash after promote
    could leave CURRENT pointing at a version whose metadata is torn
    (``_load_version`` -> None, ``current()`` -> None, lineage blind).
    Every byte of version metadata must ride the shared atomic-write
    discipline (tmp + fsync + rename + dir fsync), and the artifact
    hash must be computed BEFORE the tmp file could pollute it."""
    import os

    import har_tpu_torch.adapt.registry as regmod

    meta_writes = []
    real = regmod._atomic_write

    def spy(path, data):
        meta_writes.append(os.path.basename(path))
        return real(path, data)

    reg = ModelRegistry(str(tmp_path / "reg"))
    orig = regmod._atomic_write
    regmod._atomic_write = spy
    try:
        mv = reg.register(
            lambda p: open(os.path.join(p, "weights.bin"), "wb").write(
                b"\x01\x02"
            ),
            note="durable-meta",
            promote=True,
        )
    finally:
        regmod._atomic_write = orig
    assert "registry.json" in meta_writes
    # the metadata is complete and readable through a fresh handle,
    # with no tmp residue in the version dir
    reg2 = ModelRegistry(str(tmp_path / "reg"))
    got = reg2.get(mv.version)
    assert got.note == "durable-meta"
    assert got.sha256 == mv.sha256
    assert not any(
        f.endswith(".tmp") for f in os.listdir(mv.path)
    )
    # the artifact hash ignores the (now atomic) metadata write: it
    # still matches a recomputation over the artifact bytes alone
    assert got.sha256 == regmod._dir_sha256(mv.path)


def test_pre_fsync_registry_loads_with_defaults(tmp_path):
    """A registry directory written before the fsync discipline (plain writes,
    no fsync discipline; possibly no NEXT_ID at all) loads unchanged —
    and a registry written today reads back through the same plain
    file semantics (round-trip both ways, no format change)."""
    import json
    import os

    root = str(tmp_path / "reg")
    vdir = os.path.join(root, "versions", "v0000001")
    os.makedirs(vdir)
    with open(os.path.join(vdir, "registry.json"), "w") as f:
        json.dump(
            {
                "version": 1,
                "sha256": "metadata-only:v0000001",
                "parent_sha256": None,
                "created_unix": 100,
                "data_fingerprint": None,
                "metrics": {},
                "note": "pre-fsync era",
            },
            f,
        )
    # an old-style plain-text CURRENT pointer, no NEXT_ID, no log
    with open(os.path.join(root, "CURRENT"), "w") as f:
        f.write(os.path.join("versions", "v0000001"))
    reg = ModelRegistry(root)
    assert reg.current().version == 1
    assert reg.history() == []  # no promotions.jsonl: empty, not error
    # registering on top continues the sequence (NEXT_ID falls back to
    # max(existing)+1) and everything re-reads via plain open()
    mv = reg.register(None, promote=True)
    assert mv.version == 2
    with open(os.path.join(root, "NEXT_ID")) as f:
        assert int(f.read().strip()) == 3
    with open(os.path.join(root, "promotions.jsonl")) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert lines[-1]["version"] == 2
    assert ModelRegistry(root).current().version == 2


# ----------------------------------------------------------------- trigger


def test_trigger_escalates_on_common_channel():
    clock = FakeClock()
    trig = RetrainTrigger(
        TriggerConfig(min_sessions=3, window_s=100.0, cooldown_s=50.0),
        clock=clock,
    )
    # two sessions drifting on channel 0: below K, no job
    trig.observe("a", _report(True, onset=200))
    trig.observe("b", _report(True, onset=180))
    assert trig.poll() is None
    # a third on a DIFFERENT channel: still no common channel at K
    trig.observe("c", _report(True, onset=150, z=(0.0, 5.0, 0.0)))
    assert trig.poll() is None
    # the third joins channel 0 (its monitor now implicates both)
    trig.observe("c", _report(True, onset=150, z=(5.0, 5.0, 0.0), n=1200))
    job = trig.poll()
    assert job is not None
    assert set(job.session_ids) == {"a", "b", "c"}
    assert 0 in job.channels
    assert "3 sessions" in job.reason


def test_trigger_onset_dedup_and_cooldown():
    clock = FakeClock()
    trig = RetrainTrigger(
        TriggerConfig(min_sessions=2, window_s=1e9, cooldown_s=30.0),
        clock=clock,
    )
    for sid in ("a", "b"):
        trig.observe(sid, _report(True, onset=100))
    assert trig.poll() is not None
    # same episodes keep reporting: no re-alert even past the cooldown
    clock.advance(60.0)
    for sid in ("a", "b"):
        trig.observe(sid, _report(True, onset=100, n=2000))
    assert trig.poll() is None
    # a monitor reset (n_samples restarts) then RE-drift = new episodes
    # — alerts again, even at a numerically equal onset index
    for sid in ("a", "b"):
        trig.observe(sid, _report(True, onset=100, n=300))
    clock.advance(60.0)
    job = trig.poll()
    assert job is not None and job.job_id == 2


def test_trigger_cooldown_debounces_new_episodes():
    clock = FakeClock()
    trig = RetrainTrigger(
        TriggerConfig(min_sessions=2, window_s=1e9, cooldown_s=100.0),
        clock=clock,
    )
    for sid in ("a", "b"):
        trig.observe(sid, _report(True, onset=100))
    assert trig.poll() is not None
    # brand-new episodes inside the cooldown stay queued, not fired
    for sid in ("c", "d"):
        trig.observe(sid, _report(True, onset=50))
    assert trig.poll() is None
    clock.advance(101.0)
    assert trig.poll() is not None


def test_aggregator_flap_cannot_strobe_an_alerted_episode():
    """A monitor flap (one clean chunk clears the monitor's onset, then
    drift resumes with a NEW onset) is still the SAME episode under the
    aggregator's hysteresis — the alerted mark carries over and no
    duplicate job fires.  Full recovery then re-drift DOES re-alert."""
    clock = FakeClock()
    trig = RetrainTrigger(
        TriggerConfig(
            min_sessions=2, window_s=1e9, cooldown_s=0.0,
            recovery_patience=3,
        ),
        clock=clock,
    )
    for sid in ("a", "b"):
        trig.observe(sid, _report(True, onset=100))
    assert trig.poll() is not None
    clock.advance(1.0)
    for sid in ("a", "b"):
        trig.observe(sid, _report(False, onset=None, n=1200))  # flap
        trig.observe(sid, _report(True, onset=1300, n=1400))
    assert trig.poll() is None  # same episode: deduped despite new onset
    # genuine recovery (hysteresis satisfied), then a real re-drift
    for sid in ("a", "b"):
        for k in range(3):
            trig.observe(sid, _report(False, onset=None, n=1500 + k))
        trig.observe(sid, _report(True, onset=1900, n=1900))
    clock.advance(1.0)
    assert trig.poll() is not None


def test_aggregator_recovery_hysteresis():
    clock = FakeClock()
    agg = DriftAggregator(
        TriggerConfig(min_sessions=1, recovery_patience=3), clock=clock
    )
    agg.observe("a", _report(True, onset=100))
    assert "a" in agg.drifted()
    # one clean report is NOT recovery (hysteresis) ...
    agg.observe("a", _report(False, onset=None, n=1100))
    assert "a" in agg.drifted()
    agg.observe("a", _report(False, onset=None, n=1200))
    assert "a" in agg.drifted()
    # ... three consecutive are
    agg.observe("a", _report(False, onset=None, n=1300))
    assert "a" not in agg.drifted()


def test_aggregator_ignores_stale_reports():
    """step() can run at ANY cadence over the server's STORED latest
    reports: re-observing the same report adds no evidence — it must
    neither refresh recency on a dead stream nor be double-counted
    into the recovery hysteresis."""
    clock = FakeClock()
    agg = DriftAggregator(
        TriggerConfig(min_sessions=1, window_s=10.0, recovery_patience=2),
        clock=clock,
    )
    agg.observe("a", _report(True, onset=100, n=500))
    assert "a" in agg.drifted()
    # the session's stream ends; its last report is re-pulled forever —
    # the recency window must still expire it
    for _ in range(5):
        clock.advance(5.0)
        agg.observe("a", _report(True, onset=100, n=500))
    assert "a" not in agg.drifted()
    # one stale CLEAN report re-observed twice is still one clean
    # report: hysteresis holds
    agg.observe("b", _report(True, onset=100, n=500))
    agg.observe("b", _report(False, onset=None, n=600))
    agg.observe("b", _report(False, onset=None, n=600))  # stale dup
    assert "b" in agg.drifted()


def test_replay_buffer_bounded_and_session_scoped():
    buf = ReplayBuffer(per_session=3)
    for i in range(10):
        buf.add("a", np.full((4, 3), i, np.float32))
    buf.add("b", np.zeros((4, 3), np.float32))
    assert len(buf) == 4  # a capped at 3, b has 1
    sample = buf.sample(["a"], max_windows=2)
    assert sample.shape == (2, 4, 3)
    assert sample[0, 0, 0] == 9.0  # newest first
    assert buf.sample(["zzz"]) is None
    # the cap spreads ROUND-ROBIN across sessions (newest first within
    # each): a tight budget still samples every drifted session
    both = buf.sample(["a", "b"], max_windows=2)
    assert both.shape == (2, 4, 3)
    assert both[0, 0, 0] == 9.0 and both[1, 0, 0] == 0.0


# ------------------------------------------------------------------ shadow


def test_shadow_sampling_agreement_and_gates():
    clock = FakeClock()
    shadow = ShadowEvaluator(
        _StubModel(),
        ShadowConfig(sample_every=2, min_windows=8),
        clock=clock,
    )
    rng = np.random.default_rng(0)
    windows = rng.normal(size=(4, 20, 3)).astype(np.float32)
    probs = np.asarray(
        _StubModel().transform(windows).probability, np.float64
    )
    scored = [shadow([0, 1, 2, 3], windows, probs) for _ in range(6)]
    assert scored == [True, False, True, False, True, False]  # 1-in-2
    assert shadow.n_windows == 12
    assert shadow.agreement == 1.0  # candidate == incumbent
    gates = shadow.gates()
    assert gates["passed"] is True and gates["reasons"] == []
    assert gates["mean_abs_prob_delta"] == 0.0
    # zero-evidence gates are unrepresentable, not just unlikely
    with pytest.raises(ValueError, match="min_windows"):
        ShadowConfig(min_windows=0)


def test_shadow_agreement_excludes_drifted_sessions():
    """Agreement is measured on TRUSTED traffic only: a candidate that
    disagrees with the incumbent exactly on the drifted sessions (i.e.
    corrects them) still passes; disagreement on clean traffic would
    not.  Evidence floor counts trusted windows only."""
    rng = np.random.default_rng(2)
    windows = (rng.normal(size=(8, 20, 3)) + 1.0).astype(np.float32)
    stub = np.asarray(
        _StubModel().transform(windows).probability, np.float64
    )
    other = np.asarray(
        _OtherModel().transform(windows).probability, np.float64
    )
    assert (stub.argmax(-1) != other.argmax(-1)).all()  # they disagree
    # incumbent probs: stub's on the drifted rows, candidate's own on
    # the clean rows — so the candidate "corrects" drifted, agrees clean
    inc = np.concatenate([stub[:4], other[4:]])
    sids = ["drifted"] * 4 + ["clean"] * 4
    shadow = ShadowEvaluator(
        _OtherModel(),
        ShadowConfig(sample_every=1, min_windows=4),
        exclude_sessions={"drifted"},
        clock=FakeClock(),
    )
    shadow(sids, windows, inc)
    assert shadow.n_windows == 4  # trusted only
    assert shadow.n_windows_excluded == 4
    assert shadow.agreement == 1.0  # drifted disagreement not counted
    assert shadow.gates()["passed"] is True


def test_shadow_gates_fail_on_disagreement_and_thin_evidence():
    clock = FakeClock()
    shadow = ShadowEvaluator(
        _OtherModel(),
        ShadowConfig(sample_every=1, min_windows=64),
        clock=clock,
    )
    rng = np.random.default_rng(1)
    windows = rng.normal(size=(8, 20, 3)).astype(np.float32) + 1.0
    probs = np.asarray(
        _StubModel().transform(windows).probability, np.float64
    )
    shadow([0] * 8, windows, probs)
    gates = shadow.gates()
    assert gates["passed"] is False
    assert any("insufficient evidence" in r for r in gates["reasons"])
    for _ in range(10):
        shadow([0] * 8, windows, probs)
    gates = shadow.gates()
    assert gates["passed"] is False
    assert any("agreement" in r for r in gates["reasons"])


# ------------------------------------------------- hot swap (server level)


def _drive_with_optional_swap(swap_after_round, faults=True):
    """8 sessions, 6 rounds of 100-sample pushes through the
    fault-injection harness; optionally hot-swap after a round.
    Returns (events_by_round, server)."""
    clock = FakeClock()
    fault_hook = (
        DispatchFaults(
            stall_every=3, stall_ms=1.0, fail_every=5, fake_clock=clock
        )
        if faults
        else None
    )
    server = FleetServer(
        _StubModel(),
        window=100,
        hop=50,
        smoothing="ema",
        config=FleetConfig(max_sessions=8, retries=1, max_delay_ms=0.0),
        fault_hook=fault_hook,
        clock=clock,
        model_version="A",
    )
    recs = _recordings(8, n_samples=600, seed=3)
    for i in range(8):
        server.add_session(i)
    by_round = []
    for rnd in range(6):
        for i in range(8):
            server.push(i, recs[i][rnd * 100 : (rnd + 1) * 100])
        by_round.append(server.poll(force=True))
        clock.advance(0.01)
        if rnd == swap_after_round:
            server.swap_model(_OtherModel(), version="B")
    by_round.append(server.flush())
    return by_round, server


def test_mid_run_hot_swap_zero_drop_bit_identical_before_swap():
    """THE acceptance pin: a forced mid-run hot-swap under the fault-
    injection harness drops nothing, pre-swap events are bit-identical
    to a no-swap run, and post-swap events prove the swap took."""
    base_rounds, base_server = _drive_with_optional_swap(None)
    swap_rounds, swap_server = _drive_with_optional_swap(2)

    # zero dropped windows, everything scored, in BOTH runs
    for server in (base_server, swap_server):
        acct = server.stats.accounting()
        assert acct["dropped"] == 0
        assert acct["pending"] == 0
        assert acct["enqueued"] == acct["scored"] > 0
    assert swap_server.stats.model_swaps == 1
    # the retry path really ran under the harness (fail_every=5 with
    # retries=1: injected failures absorbed, not dropped)
    assert swap_server.stats.dispatch_retries > 0

    # windows dispatched BEFORE the swap point: bit-identical scores
    for rnd in range(3):  # rounds 0..2 dispatched before the swap
        got, want = swap_rounds[rnd], base_rounds[rnd]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.session_id == w.session_id
            assert g.event.t_index == w.event.t_index
            assert g.event.label == w.event.label
            np.testing.assert_array_equal(
                g.event.probability, w.event.probability
            )
    # ... and AFTER it the new model demonstrably serves
    post_g = [e for rnd in swap_rounds[3:] for e in rnd]
    post_w = [e for rnd in base_rounds[3:] for e in rnd]
    assert len(post_g) == len(post_w) > 0
    assert any(
        g.event.label != w.event.label
        or not np.array_equal(g.event.probability, w.event.probability)
        for g, w in zip(post_g, post_w)
    )
    # per-version attribution conserves across the swap
    by_ver = swap_server.stats.scored_by_version
    assert set(by_ver) == {"A", "B"}
    assert sum(by_ver.values()) == swap_server.stats.scored


def test_swap_from_dispatch_tap_defers_to_boundary():
    """A swap_model() issued DURING a dispatch (from the tap) must not
    take effect until that dispatch has fully completed — the in-flight
    batch finishes on the old model."""
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(target_batch=4, max_delay_ms=0.0),
        model_version="A",
    )
    server.add_session(0)
    new_model = _OtherModel()

    def tap(sids, windows, probs):
        server.swap_model(new_model, version="B")
        # the in-flight dispatch's version is still the old one
        assert server.model_version == "A"
        return False

    server.set_dispatch_tap(tap)
    server.push(0, np.zeros((40, 3), np.float32))
    server.poll(force=True)
    server.set_dispatch_tap(None)
    # applied at the boundary: the NEXT dispatch serves the new model
    assert server.model is new_model
    assert server.model_version == "B"
    server.push(0, np.ones((40, 3), np.float32))
    server.poll(force=True)
    by_ver = server.stats.scored_by_version
    assert by_ver == {"A": 4, "B": 4}


def test_fleet_stats_invariant_across_swap_n64():
    """The N=64 equivalence-pin fleet, with a swap mid-stream: the
    conservation law (and its per-version refinement) holds in every
    snapshot."""
    n = 64
    server = FleetServer(
        _StubModel(), window=100, hop=50, smoothing="ema",
        config=FleetConfig(max_sessions=n), model_version="v1",
    )
    recs = _recordings(n, n_samples=430, seed=1)
    for i in range(n):
        server.add_session(i)
    for rnd, start in enumerate(range(0, 430, 100)):
        for i in range(n):
            server.push(i, recs[i][start : start + 100])
        server.poll(force=True)
        snap = server.stats_snapshot()
        acct = snap["accounting"]
        assert acct["balanced"]
        assert acct["enqueued"] == (
            acct["scored"] + acct["dropped"] + acct["pending"]
        )
        if rnd == 1:
            server.swap_model(_OtherModel(), version="v2")
    server.flush()
    snap = server.stats_snapshot()
    acct = snap["accounting"]
    assert acct["dropped"] == 0 and acct["pending"] == 0
    assert set(snap["scored_by_version"]) == {"v1", "v2"}
    assert (
        sum(snap["scored_by_version"].values()) == acct["scored"]
    )
    assert snap["model_swaps"] == 1
    assert json.dumps(snap)  # snapshot stays JSON-serializable


def test_raising_dispatch_tap_never_breaks_serving():
    server = FleetServer(
        _StubModel(), window=10, hop=10, smoothing="none",
        config=FleetConfig(target_batch=4, max_delay_ms=0.0),
    )
    server.add_session(0)
    server.set_dispatch_tap(lambda *a: 1 / 0)
    server.push(0, np.zeros((40, 3), np.float32))
    events = server.poll(force=True)
    assert len(events) == 4  # serving unharmed
    assert server.stats.shadow_errors == 1
    assert server.stats.shadow_batches == 0


# ------------------------------------------------ engine (the closed loop)


def _drifting_fleet(tmp_path, retrainer, *, adapt_config=None,
                    shadow_config=None, fault_hook=None,
                    trigger_config=None):
    """8-session monitored fleet where half the fleet re-mounts after
    round 1; returns (server, engine, clock, recordings)."""
    clock = FakeClock()
    server = FleetServer(
        _StubModel(),
        window=100,
        hop=100,
        smoothing="none",
        config=FleetConfig(
            max_sessions=8, max_delay_ms=0.0, retries=1,
            degrade_after_breaches=1,
        ),
        clock=clock,
        fault_hook=fault_hook,
    )
    for i in range(8):
        server.add_session(
            i,
            monitor=DriftMonitor(
                np.zeros(3), np.ones(3), halflife=50.0, patience=2
            ),
        )
    registry = ModelRegistry(str(tmp_path / "reg"), clock=clock)
    engine = AdaptationEngine(
        server,
        registry,
        retrainer,
        config=adapt_config
        or AdaptationConfig(probation_dispatches=2, max_shadow_dispatches=3),
        trigger_config=trigger_config
        or TriggerConfig(
            min_sessions=2, window_s=1e9, cooldown_s=1e9,
            recovery_patience=1,
        ),
        shadow_config=shadow_config
        or ShadowConfig(sample_every=1, min_windows=4),
        clock=clock,
    )
    recs = _recordings(8, n_samples=800, seed=7)
    return server, engine, clock, recs


def _run_rounds(server, engine, clock, recs, n_rounds, drift_from=1):
    for rnd in range(n_rounds):
        for i in range(8):
            chunk = recs[i][rnd * 100 : (rnd + 1) * 100]
            if i < 4 and rnd >= drift_from:
                chunk = chunk + 25.0  # half the fleet re-mounts
            server.push(i, chunk)
        server.poll(force=True)
        engine.step()
        clock.advance(1.0)


def test_engine_full_loop_swaps_and_registry_promotes(tmp_path):
    server, engine, clock, recs = _drifting_fleet(
        tmp_path, lambda job: _StubModel()
    )
    _run_rounds(server, engine, clock, recs, 8)
    status = engine.status()
    assert status["swaps"] == 1
    assert status["rollbacks"] == 0
    assert status["retrain_jobs"] == 1
    assert status["state"] == "serving"  # probation closed clean
    assert engine.registry.current().version == 2
    assert engine.registry.current().note == "candidate:job1"
    acct = server.stats.accounting()
    assert acct["dropped"] == 0
    events = [e["event"] for e in engine.log]
    assert events[:3] == ["trigger_fired", "shadow_started", "swapped"]
    assert "probation_passed" in events
    # the job carried replay windows of the drifted distribution
    assert engine.trigger.replay is not None


def test_engine_promotes_corrective_candidate(tmp_path):
    """THE point of the trusted-traffic agreement gate: a candidate
    that changes decisions exactly on the drifted sessions (corrects
    them) but matches the incumbent on clean traffic must be promoted,
    and must survive probation."""
    server, engine, clock, recs = _drifting_fleet(
        tmp_path, lambda job: _CorrectiveModel()
    )
    _run_rounds(server, engine, clock, recs, 8)
    status = engine.status()
    assert status["swaps"] == 1
    assert status["rollbacks"] == 0
    assert status["rejected_candidates"] == 0
    assert status["state"] == "serving"  # probation closed clean
    assert engine.registry.current().version == 2
    assert server.stats.accounting()["dropped"] == 0
    # the swap actually corrects: a drifted window now scores class 2
    server.push(0, np.full((100, 3), 25.0, np.float32))
    ev = server.poll(force=True)
    assert ev[0].event.raw_label == 2


def test_engine_retrain_failure_rearms_trigger(tmp_path):
    """A transient retrain failure must not disarm adaptation for a
    persistent drift: the episodes re-arm and the trigger re-fires
    after the cooldown, and the second attempt swaps."""
    calls = {"n": 0}

    def flaky(job):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient OOM")
        return _StubModel()

    server, engine, clock, recs = _drifting_fleet(
        tmp_path,
        flaky,
        trigger_config=TriggerConfig(
            min_sessions=2, window_s=1e9, cooldown_s=3.0,
            recovery_patience=1,
        ),
    )
    _run_rounds(server, engine, clock, recs, 8)
    status = engine.status()
    assert status["retrain_errors"] == 1
    assert calls["n"] == 2  # re-fired after the cooldown
    assert status["retrain_jobs"] == 2
    assert status["swaps"] == 1
    assert server.stats.accounting()["dropped"] == 0


def test_engine_shadow_gate_failure_leaves_incumbent(tmp_path):
    """A disagreeing candidate must never serve: gates fail, the
    incumbent keeps serving, the candidate stays unpromoted."""
    incumbent_version = None
    server, engine, clock, recs = _drifting_fleet(
        tmp_path, lambda job: _OtherModel()
    )
    incumbent = server.model
    incumbent_version = server.model_version
    _run_rounds(server, engine, clock, recs, 8)
    status = engine.status()
    assert status["swaps"] == 0
    assert status["rejected_candidates"] == 1
    assert server.model is incumbent
    assert server.model_version == incumbent_version
    assert engine.registry.current().version == 1  # bootstrap still
    assert engine.registry.get(2).note == "candidate:job1"  # auditable
    assert [e["event"] for e in engine.log][-1] == "candidate_rejected"
    assert server.stats.accounting()["dropped"] == 0


def test_engine_post_swap_regression_rolls_back(tmp_path):
    """Injected post-swap SLO regression (the stall harness turned
    on right after the swap) must auto-rollback to the prior registry
    version — and the fleet keeps serving on it, zero drops."""
    faults = DispatchFaults(stall_every=0, stall_ms=2000.0)
    server, engine, clock, recs = _drifting_fleet(
        tmp_path,
        lambda job: _StubModel(),
        adapt_config=AdaptationConfig(
            probation_dispatches=6, probation_max_breach_frac=0.5
        ),
        fault_hook=faults,
    )
    faults.fake_clock = clock
    incumbent = server.model
    swapped = {"seen": False}
    rounds = 0
    while rounds < 14 and server.stats.rollbacks == 0:
        for i in range(8):
            chunk = recs[i][rounds * 50 : rounds * 50 + 50]
            if i < 4 and rounds >= 1:
                chunk = chunk + 25.0
            if len(chunk):
                server.push(i, chunk)
        server.poll(force=True)
        engine.step()
        if engine.state == "probation" and not swapped["seen"]:
            swapped["seen"] = True
            faults.stall_every = 1  # the new model's serving regresses
        clock.advance(1.0)
        rounds += 1
    assert swapped["seen"], "the loop never swapped"
    status = engine.status()
    assert status["rollbacks"] == 1
    assert status["swaps"] == 2  # the swap + the rollback swap-back
    assert server.model is incumbent
    assert engine.registry.current().version == 1  # rolled back
    assert engine.registry.history()[-1]["event"] == "rollback"
    last = engine.log[-1]
    assert last["event"] == "rolled_back"
    assert "SLO regression" in last["reason"]
    assert server.stats.accounting()["dropped"] == 0
    # serving continues on the rolled-back incumbent
    faults.stall_every = 0
    server.push(0, np.zeros((100, 3), np.float32))
    assert len(server.poll(force=True)) == 1


def test_engine_registry_failure_is_contained(tmp_path):
    """Registry I/O errors (disk full) are contained like retrainer
    errors: candidate dropped, incumbent serving, loop alive."""
    server, engine, clock, recs = _drifting_fleet(
        tmp_path, lambda job: _StubModel()
    )
    incumbent = server.model

    def boom(*a, **k):
        raise OSError("disk full")

    engine.registry.register = boom
    _run_rounds(server, engine, clock, recs, 6)
    status = engine.status()
    assert status["registry_errors"] == 1
    assert status["swaps"] == 0
    assert engine.state == "serving"
    assert server.model is incumbent
    assert server.stats.accounting()["dropped"] == 0
    assert engine.log[-1]["event"] == "registry_failed"


def test_engine_shadow_budget_survives_dispatch_failures(tmp_path):
    """The evidence budget counts dispatch ATTEMPTS: a fleet whose
    every dispatch fails mid-shadow still runs the budget down and
    rejects the undecidable candidate — `shadowing` can never pin."""
    faults = DispatchFaults()
    server, engine, clock, recs = _drifting_fleet(
        tmp_path, lambda job: _StubModel(), fault_hook=faults
    )
    armed = False
    for rnd in range(10):
        for i in range(8):
            chunk = recs[i][rnd * 100 : (rnd + 1) * 100]
            if i < 4 and rnd >= 1:
                chunk = chunk + 25.0
            if len(chunk):
                server.push(i, chunk)
        server.poll(force=True)
        engine.step()
        if engine.state == "shadowing" and not armed:
            armed = True
            faults.fail_every = 1  # every dispatch attempt now fails
        clock.advance(1.0)
    assert armed, "the loop never entered shadowing"
    assert engine.state == "serving"
    assert engine.rejected_candidates == 1
    assert server.stats.dispatch_failures > 0


def test_trigger_survives_monitor_reset_landing_on_equal_watermark():
    """A monitor reset whose first post-reset report lands EXACTLY on
    the pre-reset n_samples (and a numerically equal onset) is still
    detected — the DriftReport.generation stamp, not the sample count,
    is the reset signal."""
    mon = DriftMonitor(np.zeros(3), np.ones(3), halflife=50.0, patience=2)
    clock = FakeClock()
    trig = RetrainTrigger(
        TriggerConfig(min_sessions=1, window_s=1e9, cooldown_s=0.0),
        clock=clock,
    )
    rng = np.random.default_rng(6)

    def drift_until_alert():
        r = None
        for _ in range(3):
            r = mon.update(
                rng.normal(size=(200, 3)).astype(np.float32) + 25.0
            )
        return r

    r1 = drift_until_alert()
    assert r1.drifting
    trig.observe("a", r1)
    clock.advance(1.0)
    assert trig.poll() is not None
    # reset + identical re-drift cadence: same n_samples (600), same
    # onset index — only the generation differs
    mon.reset()
    r2 = drift_until_alert()
    assert r2.n_samples == r1.n_samples and r2.onset == r1.onset
    assert r2.generation == r1.generation + 1
    trig.observe("a", r2)
    clock.advance(1.0)
    assert trig.poll() is not None  # the NEW episode re-alerts


def test_engine_retrain_failure_is_contained(tmp_path):
    def broken(job):
        raise RuntimeError("no training data mounted")

    server, engine, clock, recs = _drifting_fleet(tmp_path, broken)
    _run_rounds(server, engine, clock, recs, 6)
    status = engine.status()
    assert status["retrain_errors"] == 1
    assert status["swaps"] == 0
    assert engine.state == "serving"
    assert server.stats.accounting()["dropped"] == 0


def test_cli_serve_adapt_closes_the_loop(tmp_path, capsys):
    """`har serve --adapt --inject-drift`: the population re-mount is
    detected, retrained past the shadow gates, and hot-swapped with
    zero dropped windows — and --registry persists the lineage."""
    from har_tpu_torch.cli import main

    rc = main(
        [
            "serve", "--device", "cpu", "--sessions", "24",
            "--windows-per-session", "6",
            "--adapt", "--inject-drift", "0.5",
            "--registry", str(tmp_path / "reg"),
        ]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["dropped"] == 0
    assert out["drift_events"] > 0
    adapt = out["adapt"]
    assert adapt["retrain_jobs"] == 1
    assert adapt["swaps"] == 1
    assert adapt["rollbacks"] == 0
    assert adapt["serving_version"] == "v0000002"
    assert out["stats"]["accounting"]["balanced"]
    assert (
        sum(out["stats"]["scored_by_version"].values()) == out["scored"]
    )
    # the lineage is on disk
    reg = ModelRegistry(str(tmp_path / "reg"))
    assert reg.current().version == 2
    assert reg.current().note == "candidate:job1"


# -------------------------------------------------------------- the smoke


def test_adapt_smoke_verdict(tmp_path):
    out = adapt_smoke(
        sessions=8, rounds=8, registry_root=str(tmp_path / "reg")
    )
    assert out["ok"] is True
    assert out["swaps"] >= 1
    assert out["rollbacks"] == 0
    assert out["dropped"] == 0
    assert out["shadow_agreement"] >= 0.98
    assert out["accounting_balanced"]
    assert sum(out["scored_by_version"].values()) == out["windows"]
    # the lineage survived on disk: bootstrap + promoted candidate
    reg = ModelRegistry(str(tmp_path / "reg"))
    assert reg.current().version == 2
    assert [h["event"] for h in reg.history()] == ["promote", "promote"]


# ---------------------------------------------------- int8 promotion


def _int8_fleet(depth, n=16, fused=True):
    from har_tpu_torch.serve import JitDemoModel, synthetic_sessions

    model = JitDemoModel(device="cpu")
    recs, _ = synthetic_sessions(n, windows_per_session=8, seed=17)
    server = FleetServer(
        model, window=200, hop=200, smoothing="vote",
        config=FleetConfig(
            max_sessions=n, target_batch=16, pipeline_depth=depth,
            fused=fused,
        ),
    )
    for i in range(n):
        server.add_session(i)
    return model, server, recs


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_int8_promotion_shadow_agreement_at_every_ring_depth(
    depth, tmp_path
):
    """THE int8 shadow-agreement pin: propose_int8 quantizes the
    serving incumbent, shadows it against live f32 traffic through the
    fused + depth-N dispatch plane, passes the agreement + latency
    gates on evidence, hot-swaps at a dispatch boundary with zero
    drops, and survives probation — at every ticket-ring depth 1-4."""
    from har_tpu_torch.quantize import Int8ServingModel
    from har_tpu_torch.serve import drive_fleet

    model, server, recs = _int8_fleet(depth)
    engine = AdaptationEngine(
        server, ModelRegistry(str(tmp_path / "reg")),
        lambda job: None,
        config=AdaptationConfig(probation_dispatches=2,
                                probation_min_agreement=0.9),
        shadow_config=ShadowConfig(sample_every=1, min_windows=8),
    )
    ver = engine.propose_int8(shadow_config=ShadowConfig(
        sample_every=1, min_windows=8, min_agreement=0.95,
        max_latency_factor=50.0,
    ))
    assert engine.state == "shadowing"
    assert isinstance(engine._candidate[1], Int8ServingModel)
    halves = [(r[: len(r) // 2], r[len(r) // 2:]) for r in recs]
    drive_fleet(server, [h[0] for h in halves], seed=17,
                on_poll=lambda s, r: engine.step())
    drive_fleet(server, [h[1] for h in halves], seed=18,
                on_poll=lambda s, r: engine.step())
    engine.step()
    assert engine.state == "serving"
    assert server.model_version == ver
    assert server.stats.model_swaps == 1
    assert server.stats.rollbacks == 0
    assert isinstance(server.model, Int8ServingModel)
    events = [e for e in engine.log if e["event"] == "swapped"]
    assert events and events[0]["shadow"]["agreement"] >= 0.95
    acct = server.stats.accounting()
    assert acct["balanced"] and acct["pending"] == 0
    assert server.stats.dropped_total == 0
    # the per-version attribution saw both tiers serve
    assert set(server.stats.scored_by_version) >= {"v0000001", ver}


def test_int8_promotion_rejected_on_agreement_evidence(tmp_path):
    """An int8 gate that demands impossible agreement rejects the
    candidate on evidence: the f32 incumbent keeps serving and the
    candidate stays registered unpromoted — adoption on measurement,
    not faith."""
    from har_tpu_torch.serve import drive_fleet

    model, server, recs = _int8_fleet(depth=2)
    engine = AdaptationEngine(
        server, ModelRegistry(str(tmp_path / "reg")),
        lambda job: None,
        config=AdaptationConfig(max_shadow_dispatches=4),
        shadow_config=ShadowConfig(sample_every=1, min_windows=8),
    )
    ver = engine.propose_int8(shadow_config=ShadowConfig(
        sample_every=1, min_windows=10_000,  # unmeetable evidence floor
    ))
    drive_fleet(server, recs, seed=17,
                on_poll=lambda s, r: engine.step())
    engine.step()
    assert engine.state == "serving"
    assert server.model_version == "v0000001"  # incumbent unchanged
    assert server.stats.model_swaps == 0
    assert engine.rejected_candidates == 1
    current = engine.registry.current()
    assert current is not None and current.name == "v0000001"
    names = {mv.name for mv in engine.registry.versions()}
    assert ver in names  # auditable, unpromoted


def test_propose_refused_outside_serving(tmp_path):
    model, server, recs = _int8_fleet(depth=1)
    engine = AdaptationEngine(
        server, ModelRegistry(str(tmp_path / "reg")),
        lambda job: None,
        shadow_config=ShadowConfig(sample_every=1, min_windows=4),
    )
    engine.propose_int8()
    with pytest.raises(RuntimeError, match="shadowing"):
        engine.propose_int8()


def test_shadow_latency_warmup_excludes_compile_batch():
    """The candidate's first mirrored batch pays jit compilation —
    deployment cadence, not serving speed — so latency_warmup=1
    (default) drops it from the latency-gate sample while agreement
    still counts it."""
    clock = FakeClock()
    ticks = iter([0.0, 5.0, 5.0, 5.1, 5.1, 5.15])  # 5 s compile, then fast

    class _TickClock:
        def __call__(self):
            try:
                return next(ticks)
            except StopIteration:
                return 6.0

    cand = _StubModel()
    ev = ShadowEvaluator(
        cand, ShadowConfig(sample_every=1, min_windows=1,
                           max_latency_factor=2.0),
        clock=_TickClock(),
    )
    x = np.zeros((4, 10, 3), np.float32)
    probs = np.tile(np.asarray([0.5, 0.3, 0.2]), (4, 1))  # argmax 0, matching the stub
    ev(list("abcd"), x, probs)  # warmup batch: 5000 ms
    ev(list("abcd"), x, probs)  # steady batch: ~0 ms
    rep = ev.report()
    assert rep["batches_scored"] == 2
    assert rep["windows_scored"] == 8  # both batches count as evidence
    assert rep["candidate_mean_batch_ms"] < 1000  # compile excluded
    ev.set_incumbent_ms(50.0)
    assert ev.gates()["passed"]
    # warmup=0 restores the raw sample
    ticks2 = iter([0.0, 5.0])
    ev2 = ShadowEvaluator(
        cand, ShadowConfig(sample_every=1, min_windows=1,
                           latency_warmup=0, max_latency_factor=2.0),
    )
    ev2._clock = lambda: next(ticks2, 6.0)
    ev2(list("abcd"), x, probs)
    assert ev2.report()["candidate_mean_batch_ms"] >= 5000


def test_latency_gate_needs_post_warmup_evidence():
    """A configured max_latency_factor may never pass
    on an EMPTY latency sample — when warmup excluded the only scored
    batch, gates() holds the candidate until a measured batch lands
    (a slow candidate must not promote unmeasured)."""
    cand = _StubModel()
    ev = ShadowEvaluator(
        cand, ShadowConfig(sample_every=1, min_windows=1,
                           max_latency_factor=2.0),
    )
    x = np.zeros((4, 10, 3), np.float32)
    probs = np.tile(np.asarray([0.5, 0.3, 0.2]), (4, 1))
    ev(list("abcd"), x, probs)  # the only batch: warmup-excluded
    ev.set_incumbent_ms(50.0)
    gates = ev.gates()
    assert not gates["passed"]
    assert any("latency evidence" in r for r in gates["reasons"])
    ev(list("abcd"), x, probs)  # a measured batch arrives
    assert ev.gates()["passed"]
