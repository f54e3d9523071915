"""The port's adaptation loop against ``har_tpu``'s on the same inputs.

  1. the loop — one drifting fleet, driven by ``har_tpu.adapt`` and by
     ``har_tpu_torch.adapt`` under a FakeClock with the analytic demo
     model: for a promotion, a shadow-gate rejection, a post-swap
     rollback and a retrain failure, ``engine.log`` entry by entry,
     ``status()``, every event and the whole stats snapshot are equal;
  2. the registry — built by either package and read by the other:
     versions, pointer, history and prune agree, and a classical version
     loads in the other package and predicts the same labels (a JAX
     neural version, an orbax checkpoint, is refused);
  3. journals with ``adapt`` records — a fleet killed inside a registry
     transition by either package restores in the other, whose
     ``AdaptationEngine(resume=True)`` reconciles it to the same
     CURRENT, with the same log and stats as a same-package recovery;
  4. int8 promotion on a narrow float32 transformer — the same labels
     through the swap, shadow agreement within 0.01 of ``har_tpu``'s.
Tolerances: equal everywhere (numpy host models on one FakeClock)
except item 4's agreement (0.01) and its probabilities (not compared).
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("har_tpu", "har_tpu_torch")
SESSIONS = 12
ROUNDS = 12


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _Permuted:
    """A candidate that moves every decision one class over: the
    agreement gate must reject it on trusted traffic."""

    def __init__(self, base):
        self.base = base
        self.num_classes = base.num_classes

    def transform(self, x):
        preds = self.base.transform(x)
        raw = np.roll(np.asarray(preds.raw), 1, axis=-1)
        prob = np.roll(np.asarray(preds.probability), 1, axis=-1)
        return type(preds).from_raw(raw, prob)


def _fleet(pkg, clock, faults=None, journal=None):
    serve = _mod(pkg, "serve")
    monitoring = _mod(pkg, "monitoring")
    recordings, _ = serve.synthetic_sessions(
        SESSIONS, windows_per_session=ROUNDS, seed=0)
    pool = np.concatenate(recordings)
    ref = (pool.mean(axis=0), pool.std(axis=0))
    server = serve.FleetServer(
        serve.AnalyticDemoModel(), window=200, hop=200, smoothing="ema",
        config=serve.FleetConfig(
            max_sessions=SESSIONS, max_delay_ms=0.0, retries=1,
            degrade_after_breaches=1,
        ),
        clock=clock, fault_hook=faults, journal=journal,
    )
    for i in range(SESSIONS):
        server.add_session(i, monitor=monitoring.DriftMonitor(
            *ref, halflife=100.0, patience=2))
    return server, recordings


def _engine(pkg, server, registry, retrainer, clock, scenario="promote", **kw):
    adapt = _mod(pkg, "adapt")
    return adapt.AdaptationEngine(
        server, registry, retrainer,
        config=adapt.AdaptationConfig(
            probation_dispatches=6 if scenario == "rollback" else 2,
            max_shadow_dispatches=4,
        ),
        trigger_config=adapt.TriggerConfig(
            min_sessions=3, window_s=1e9,
            cooldown_s=3.0 if scenario == "retrain_failure" else 1e9,
            recovery_patience=2,
        ),
        shadow_config=adapt.ShadowConfig(sample_every=1, min_windows=8),
        clock=clock, **kw,
    )


def _deliver(server, recordings, cursors, rnd):
    """Round ``rnd``: one 200-sample window a session; the first half of
    the fleet re-mounts (+25 on every axis) from round 2 on."""
    for i, rec in enumerate(recordings):
        chunk = rec[cursors[i]: cursors[i] + 200]
        cursors[i] += len(chunk)
        if not len(chunk):
            continue
        if i < SESSIONS // 2 and rnd >= 2:
            chunk = chunk + 25.0
        server.push(i, chunk)


def _event(fe):
    ev = fe.event
    return (fe.session_id, fe.degraded, ev.t_index, ev.label, ev.raw_label,
            ev.drift, ev.latency_ms, ev.probability.tobytes())


def _drive_loop(pkg, scenario, root):
    serve = _mod(pkg, "serve")
    adapt = _mod(pkg, "adapt")
    clock = serve.FakeClock()
    faults = serve.DispatchFaults(stall_ms=2000.0, fake_clock=clock)
    server, recordings = _fleet(pkg, clock, faults=faults)
    calls = {"n": 0}

    def retrainer(job):
        calls["n"] += 1
        if scenario == "retrain_failure" and calls["n"] == 1:
            raise RuntimeError("transient OOM")
        if scenario == "reject":
            return _Permuted(serve.AnalyticDemoModel())
        return serve.AnalyticDemoModel()

    engine = _engine(pkg, server, adapt.ModelRegistry(root, clock=clock),
                     retrainer, clock, scenario)
    events, statuses = [], []
    cursors = [0] * SESSIONS
    stalled = False
    for rnd in range(ROUNDS):
        _deliver(server, recordings, cursors, rnd)
        events += server.poll(force=True)
        statuses.append(engine.step())
        if scenario == "rollback" and engine.state == "probation" and not stalled:
            stalled = True
            faults.stall_every = 1  # the new model's serving regresses
        clock.advance(1.0)
    events += server.flush()
    statuses.append(engine.step())
    return dict(log=engine.log, statuses=statuses, status=engine.status(),
                events=[_event(e) for e in events],
                snap=server.stats.snapshot(),
                history=engine.registry.history(),
                current=engine.registry.current().name)


@pytest.mark.parametrize("scenario", ["promote", "reject", "rollback",
                                      "retrain_failure"])
def test_adaptation_loop_equals_jax(scenario, tmp_path):
    theirs = _drive_loop("har_tpu", scenario, str(tmp_path / "jax"))
    ours = _drive_loop("har_tpu_torch", scenario, str(tmp_path / "port"))
    assert ours["log"] == theirs["log"]
    assert ours["statuses"] == theirs["statuses"]
    assert ours["events"] == theirs["events"]
    assert ours["snap"] == theirs["snap"]  # the whole stats snapshot
    assert ours["history"] == theirs["history"]
    assert ours["current"] == theirs["current"]
    log = [e["event"] for e in ours["log"]]
    status, acct = ours["status"], ours["snap"]["accounting"]
    assert acct["balanced"] and acct["pending"] == 0 and acct["dropped"] == 0
    if scenario == "promote":
        assert log[:3] == ["trigger_fired", "shadow_started", "swapped"]
        assert "probation_passed" in log and status["swaps"] == 1
    elif scenario == "reject":
        assert log[-1] == "candidate_rejected" and status["swaps"] == 0
        assert ours["current"] == "v0000001"
    elif scenario == "rollback":
        assert log[-1] == "rolled_back" and status["rollbacks"] == 1
        assert "SLO regression" in ours["log"][-1]["reason"]
        assert ours["current"] == "v0000001"
    else:
        assert status["retrain_errors"] == 1 and status["swaps"] == 1
        assert log[:4] == ["trigger_fired", "retrain_failed", "trigger_fired",
                           "shadow_started"]


def test_adapt_smoke_equals_jax(tmp_path):
    """The host smoke of each package: the same verdict."""
    from har_tpu.adapt import adapt_smoke as jax_smoke
    from har_tpu_torch.adapt import adapt_smoke

    ours = adapt_smoke(sessions=8, rounds=8, registry_root=str(tmp_path / "p"))
    theirs = jax_smoke(sessions=8, rounds=8, registry_root=str(tmp_path / "j"))
    assert ours == theirs and ours["ok"]


# ------------------------------------------------------------ registry


def _lr(pkg):
    lr = _mod(pkg, "models.logistic_regression").LogisticRegressionModel
    rng = np.random.default_rng(3)
    kw = dict(coefficients=rng.normal(size=(8, 4)).astype(np.float32),
              intercept=rng.normal(size=4).astype(np.float32), num_classes=4)
    return lr(**kw, device="cpu") if pkg == "har_tpu_torch" else lr(**kw)


def _labels(pkg, model, x):
    fs = _mod(pkg, "features.wisdm_pipeline").FeatureSet(
        features=x, label=np.zeros(len(x), np.int32))
    return np.asarray(model.transform(fs).probability).argmax(-1)


def _build_registry(pkg, root):
    adapt = _mod(pkg, "adapt")
    t = {"now": 1_700_000_000.0}
    reg = adapt.ModelRegistry(root, clock=lambda: t["now"])
    reg.register(None, note="incumbent:bootstrap", promote=True)
    t["now"] += 10
    mv = adapt.register_classical(reg, _lr(pkg), data_fingerprint=adapt.data_fingerprint(
        np.ones((4, 8, 3), np.float32)))
    reg.promote(mv.version)
    for _ in range(3):
        t["now"] += 10
        reg.register(None, note="candidate")
    reg.promote(5)
    reg.rollback()
    return reg


def _registry_view(reg):
    return dict(
        versions=[(v.version, v.sha256, v.parent_sha256, v.created_unix,
                   v.data_fingerprint, v.metrics, v.note, v.name)
                  for v in reg.versions()],
        current=reg.current().name,
        history=reg.history(),
    )


@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]],
                         ids=["jax_to_port", "port_to_jax"])
def test_registry_crosses_packages(writer, reader, tmp_path):
    root = str(tmp_path / "reg")
    written = _build_registry(writer, root)
    read = _mod(reader, "adapt").ModelRegistry(root)
    assert _registry_view(read) == _registry_view(written)
    assert read.current().version == 2  # rolled back from v5 to v2
    # the classical version loads in the reader and predicts as the
    # writer's model does; its sha256 is the same in both packages
    x = np.random.default_rng(5).normal(size=(64, 8)).astype(np.float32)
    mv = read.get(2)
    if reader == "har_tpu_torch":
        from har_tpu_torch.adapt import load_version

        model = load_version(mv, "cpu")
    else:
        from har_tpu.checkpoint import load_classical_model

        model = load_classical_model(mv.path)
    np.testing.assert_array_equal(_labels(reader, model, x),
                                  _labels(writer, _lr(writer), x))
    # prune in the reader: the same survivors as the writer would keep
    pruned = read.prune(keep=2)
    assert pruned == [3, 4]  # never CURRENT (v2) nor v5's predecessor
    assert [v.version for v in _mod(writer, "adapt").ModelRegistry(root).versions()] == [1, 2, 5]
    assert read.register(None).version == 6  # ids stay monotone


def test_registry_neural_version_loads_on_the_named_device(tmp_path):
    """A port neural version is a params.npz checkpoint saved from the
    model as it is; load_version rebuilds it on the named device with
    the same logits, and a metadata-only version has nothing to load."""
    from har_tpu_torch.adapt import ModelRegistry, load_version, register_neural
    from tests.test_torch_serving import random_pair

    port, _, kwargs = random_pair("transformer", window=40, classes=4, seed=2,
                                  kwargs=dict(embed_dim=16, num_heads=2, num_layers=1))
    reg = ModelRegistry(str(tmp_path / "reg"))
    boot = reg.register(None, promote=True)
    mv = register_neural(reg, port, "transformer", model_kwargs=kwargs,
                         input_shape=(40, 3))
    assert mv.parent_sha256 == boot.sha256
    x = np.random.default_rng(1).normal(size=(5, 40, 3)).astype(np.float32)
    back = load_version(mv, "cpu")
    np.testing.assert_allclose(back.transform(x).probability,
                               port.transform(x).probability, atol=1e-6)
    with pytest.raises(ValueError, match="metadata-only"):
        load_version(boot, "cpu")


def test_registry_jax_neural_version_is_refused(tmp_path):
    """A JAX neural version is an orbax checkpoint: the port refuses it
    with the message its checkpoint loader gives."""
    from har_tpu.adapt import ModelRegistry as JaxRegistry
    from har_tpu.adapt import register_neural as jax_register_neural
    from har_tpu_torch.adapt import ModelRegistry, load_version
    from tests.test_torch_serving import random_pair

    _, jax_model, kwargs = random_pair("mlp", shape=(24,), classes=3, seed=1,
                                       kwargs=dict(hidden=(8,)))
    mv = jax_register_neural(JaxRegistry(str(tmp_path / "reg")), jax_model, "mlp",
                             model_kwargs=kwargs)
    with pytest.raises(ValueError, match="orbax"):
        load_version(ModelRegistry(str(tmp_path / "reg")).get(mv.version), "cpu")


# ---------------------------------------------- journals with adapt records


def _crash_in_transition(pkg, point, jdir, reg_root):
    """Drive ``pkg``'s journaled fleet until the adaptation engine dies
    at ``point`` (after the registry write, before the fleet swap)."""
    serve = _mod(pkg, "serve")
    adapt = _mod(pkg, "adapt")
    chaos = _mod(pkg, "serve.chaos")
    clock = serve.FakeClock()
    journal = serve.FleetJournal(jdir, serve.JournalConfig(flush_every=8, snapshot_every=0))
    faults = serve.DispatchFaults(fake_clock=clock)
    server, recordings = _fleet(pkg, clock, faults=faults, journal=journal)
    engine = _engine(pkg, server, adapt.ModelRegistry(reg_root, clock=clock),
                     lambda job: serve.AnalyticDemoModel(tau=5.0), clock)
    journal.chaos = chaos.KillPlan(point, 1)
    cursors = [0] * SESSIONS
    try:
        for rnd in range(ROUNDS):
            _deliver(server, recordings, cursors, rnd)
            server.poll(force=True)
            if point == "mid_rollback" and engine.state == "probation":
                faults.fail_every = 1  # regression: every dispatch dies
            engine.step()
            clock.advance(1.0)
    except chaos.SimulatedCrash:
        journal.kill()
        return clock.t
    raise AssertionError(f"{point} never fired in {pkg}")


def _recover(pkg, jdir, reg_root, t):
    serve = _mod(pkg, "serve")
    adapt = _mod(pkg, "adapt")
    clock = serve.FakeClock(t)
    models = {"v0000001": serve.AnalyticDemoModel()}

    def loader(ver):
        return models.setdefault(ver, serve.AnalyticDemoModel(tau=5.0))

    server = serve.FleetServer.restore(jdir, loader, clock=clock)
    engine = _engine(pkg, server, adapt.ModelRegistry(reg_root, clock=clock),
                     lambda job: serve.AnalyticDemoModel(tau=5.0), clock,
                     resume=True, loader=loader)
    current = engine.registry.current().name
    assert server.model_version == current
    assert server.model is models[current]
    events = server.poll(force=True)
    _, recordings = _fleet(pkg, serve.FakeClock())
    cursors = [server.watermark(i) for i in range(SESSIONS)]
    for rnd in range(3):
        for i, rec in enumerate(recordings):
            chunk = rec[cursors[i]: cursors[i] + 200]
            cursors[i] += len(chunk)
            if len(chunk):
                server.push(i, chunk)
        events += server.poll(force=True)
        engine.step()
        clock.advance(1.0)
    events += server.flush()
    engine.step()
    return dict(current=current, log=engine.log, status=engine.status(),
                events=[_event(e) for e in events], snap=server.stats.snapshot(),
                serving=server.model_version, now=engine.registry.current().name)


@pytest.mark.parametrize("point", ["mid_promote", "mid_rollback"])
@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]],
                         ids=["jax_to_port", "port_to_jax"])
def test_adapt_journal_restores_across_packages(writer, reader, point, tmp_path):
    import shutil

    base = tmp_path / "w"
    t = _crash_in_transition(writer, point, str(base / "wal"), str(base / "reg"))
    # the same crash recovered by the reader and by the writer itself,
    # each from its own copy of the directories
    out = {}
    for pkg in (reader, writer):
        d = tmp_path / pkg
        shutil.copytree(base, d, symlinks=True)
        out[pkg] = _recover(pkg, str(d / "wal"), str(d / "reg"), t)
    a, b = out[reader], out[writer]
    assert a["current"] == b["current"] == ("v0000002" if point == "mid_promote"
                                              else "v0000001")
    for key in ("log", "status", "events", "snap", "serving", "now"):
        assert a[key] == b[key], key
    assert a["serving"] == a["now"]
    acct = a["snap"]["accounting"]
    assert acct["balanced"] and acct["pending"] == 0
    assert a["status"]["state"] == "serving"


# ------------------------------------------------- int8 promotion


def _int8_run(pkg, model, root):
    serve = _mod(pkg, "serve")
    adapt = _mod(pkg, "adapt")
    clock = serve.FakeClock()
    recs, _ = serve.synthetic_sessions(16, windows_per_session=6, window=40, seed=17)
    server = serve.FleetServer(
        model, window=40, hop=40, smoothing="vote",
        config=serve.FleetConfig(max_sessions=16, target_batch=16, max_delay_ms=0.0),
        clock=clock,
    )
    for i in range(16):
        server.add_session(i)
    engine = adapt.AdaptationEngine(
        server, adapt.ModelRegistry(root, clock=clock), lambda job: None,
        config=adapt.AdaptationConfig(probation_dispatches=2,
                                      probation_min_agreement=0.9),
        shadow_config=adapt.ShadowConfig(sample_every=1, min_windows=8),
        clock=clock,
    )
    # the default latency factor (1.5) on the FakeClock: both sides of
    # the gate read the same unmoving clock
    ver = engine.propose_int8()
    events, _ = serve.drive_fleet(server, recs, seed=17,
                                  on_poll=lambda s, r: engine.step())
    engine.step()
    swapped = [e for e in engine.log if e["event"] == "swapped"]
    return dict(ver=ver, labels=[(fe.session_id, fe.event.t_index, fe.event.label)
                                 for fe in events],
                agreement=swapped[0]["shadow"]["agreement"] if swapped else None,
                status=engine.status(), log=[e["event"] for e in engine.log],
                scored_by_version=server.stats.scored_by_version)


def test_int8_promotion_equals_jax_on_narrow_transformer(tmp_path):
    """propose_int8 on a narrow float32 transformer (1 layer, embed 16):
    the same gates pass, the same swap lands, the labels of every event
    are equal, and the shadow agreement is within 0.01 of har_tpu's."""
    from tests.test_torch_serving import random_pair

    port, jax_model, _ = random_pair("transformer", window=40, classes=6, seed=4,
                                     kwargs=dict(embed_dim=16, num_heads=2,
                                                 num_layers=1))
    ours = _int8_run("har_tpu_torch", port, str(tmp_path / "p"))
    theirs = _int8_run("har_tpu", jax_model, str(tmp_path / "j"))
    assert ours["log"] == theirs["log"]
    assert "swapped" in ours["log"] and ours["status"]["state"] == "serving"
    assert ours["ver"] == theirs["ver"]
    assert ours["labels"] == theirs["labels"]
    assert abs(ours["agreement"] - theirs["agreement"]) <= 0.01
    assert ours["scored_by_version"] == theirs["scored_by_version"]
    assert json.dumps(ours["status"])
    assert os.path.isdir(tmp_path / "p" / "versions")
