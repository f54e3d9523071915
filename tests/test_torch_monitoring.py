"""Input-drift monitoring (har_tpu_torch.monitoring) against har_tpu's.

``monitoring.py`` is a numpy copy, so every case of
``tests/test_monitoring.py`` (none needs the fleet) runs here on both
packages, and the two packages' ``DriftReport`` fields are equal bit for
bit on the same samples (sequential updates, ``update_many``, and a
monitor rebuilt from ``state()``).  The CLI's ``stream --monitor`` on a
saved port checkpoint prints the drift block ``har_tpu``'s CLI prints for
the same parameters.
"""

import json

import numpy as np
import pytest
import torch

import har_tpu.monitoring as jax_monitoring
from har_tpu_torch import monitoring
from har_tpu_torch.models.base import Predictions
from har_tpu_torch.serving import StreamingClassifier
from tests.test_torch_serving import random_pair

torch.set_num_threads(1)

PACKAGES = {"har_tpu_torch": monitoring, "har_tpu": jax_monitoring}


@pytest.fixture(params=list(PACKAGES))
def mon_cls(request):
    return PACKAGES[request.param].DriftMonitor


def _stream(rng, n, mean=(0.0, 0.0, 9.8), std=(1.0, 1.0, 1.0)):
    return (rng.normal(size=(n, 3)) * np.asarray(std) + np.asarray(mean)).astype(np.float32)


def _monitor(cls, **kw):
    kw.setdefault("halflife", 100.0)
    kw.setdefault("patience", 2)
    return cls([0.0, 0.0, 9.8], [1.0, 1.0, 1.0], **kw)


def test_in_distribution_never_alarms(mon_cls):
    mon = _monitor(mon_cls)
    rng = np.random.default_rng(0)
    for _ in range(50):
        report = mon.update(_stream(rng, 40))
    assert not report.drifting
    assert report.location_z.max() < 1.0
    assert abs(report.scale_log_ratio).max() < 0.3
    assert report.n_samples == 2000


def test_location_shift_alarms_after_patience(mon_cls):
    mon = _monitor(mon_cls)
    rng = np.random.default_rng(1)
    mon.update(_stream(rng, 200))
    verdicts = [mon.update(_stream(rng, 200, mean=(9.8, 0.0, 0.0))).drifting
                for _ in range(6)]
    assert verdicts[-1] is True and verdicts[0] is False
    assert mon.update(_stream(rng, 1, mean=(9.8, 0.0, 0.0))).worst_channel in (0, 2)


def test_scale_shift_alarms(mon_cls):
    mon = _monitor(mon_cls)
    rng = np.random.default_rng(2)
    mon.update(_stream(rng, 200))
    for _ in range(8):
        report = mon.update(_stream(rng, 200, std=(4.0, 4.0, 4.0)))
    assert report.drifting and abs(report.scale_log_ratio).max() > 0.69


def test_recovery_clears_flag(mon_cls):
    mon = _monitor(mon_cls)
    rng = np.random.default_rng(3)
    for _ in range(8):
        mon.update(_stream(rng, 200, mean=(9.8, 0.0, 0.0)))
    assert mon.update(_stream(rng, 1, mean=(9.8, 0.0, 0.0))).drifting
    for _ in range(12):
        report = mon.update(_stream(rng, 200))
    assert not report.drifting


def test_drift_onset_is_a_stable_episode_id(mon_cls):
    mon = _monitor(mon_cls)
    rng = np.random.default_rng(11)
    assert mon.update(_stream(rng, 200)).onset is None
    reports = [mon.update(_stream(rng, 200, mean=(9.8, 0.0, 0.0))) for _ in range(6)]
    assert reports[0].onset is None and not reports[0].drifting
    drifting = [r for r in reports if r.drifting]
    assert drifting and drifting[0].onset == drifting[0].n_samples
    assert {r.onset for r in drifting} == {drifting[0].onset}
    for _ in range(12):
        r = mon.update(_stream(rng, 200))
    assert not r.drifting and r.onset is None


def test_debounce_drift_reset_redrift(mon_cls):
    mon = _monitor(mon_cls)
    rng = np.random.default_rng(12)
    mon.update(_stream(rng, 200))
    assert not mon.update(_stream(rng, 200, mean=(9.8, 0.0, 0.0))).drifting
    r = mon.update(_stream(rng, 200, mean=(9.8, 0.0, 0.0)))
    assert r.drifting and r.onset == 600
    mon.reset()
    r = mon.update(_stream(rng, 200))
    assert not r.drifting and r.onset is None and r.n_samples == 200
    assert r.generation == 1
    assert not mon.update(_stream(rng, 200, mean=(9.8, 0.0, 0.0))).drifting
    r = mon.update(_stream(rng, 200, mean=(9.8, 0.0, 0.0)))
    assert r.drifting and r.onset == 600


def test_from_windows_and_from_model_stats(mon_cls):
    rng = np.random.default_rng(4)
    windows = rng.normal(size=(32, 200, 3)).astype(np.float32) * 2.0 + 1.0
    mon = mon_cls.from_windows(windows)
    np.testing.assert_allclose(mon.ref_mean, [1.0] * 3, atol=0.1)
    np.testing.assert_allclose(mon.ref_std, [2.0] * 3, atol=0.1)

    class _Scaler:
        mean = np.full((200, 3), 1.0, np.float32)
        std = np.full((200, 3), 2.0, np.float32)

    class _Model:
        scaler = _Scaler()

    mon2 = mon_cls.from_model(_Model())
    np.testing.assert_allclose(mon2.ref_mean, [1.0] * 3)
    np.testing.assert_allclose(mon2.ref_std, [2.0] * 3)
    with pytest.raises(ValueError, match="scaler"):
        mon_cls.from_model(object())


def test_validation(mon_cls):
    with pytest.raises(ValueError, match="expected"):
        _monitor(mon_cls).update(np.zeros((5, 2)))
    with pytest.raises(ValueError, match="halflife"):
        mon_cls([0.0], [1.0], halflife=0)
    with pytest.raises(ValueError, match="equal shape"):
        mon_cls([0.0, 1.0], [1.0])


def _report_fields(report):
    return (report.drifting, report.location_z.tobytes(), report.scale_log_ratio.tobytes(),
            report.n_samples, report.onset, report.generation)


def test_reports_bit_equal_to_jax():
    """The same chunks, in and out of distribution, through both
    packages' monitors: every report field equal, the float arrays bit
    for bit; then state() → from_state() continues identically."""
    rng = np.random.default_rng(21)
    chunks = [_stream(rng, int(n), mean=m, std=s) for n, m, s in [
        (37, (0, 0, 9.8), (1, 1, 1)), (200, (9.8, 0, 0), (1, 1, 1)),
        (1, (9.8, 0, 0), (1, 1, 1)), (150, (9.8, 0, 0), (1, 1, 1)),
        (90, (0, 0, 9.8), (3, 3, 3)), (400, (0, 0, 9.8), (1, 1, 1))]]
    port, ref = _monitor(monitoring.DriftMonitor), _monitor(jax_monitoring.DriftMonitor)
    for i, chunk in enumerate(chunks):
        assert _report_fields(port.update(chunk)) == _report_fields(ref.update(chunk))
        if i == 2:
            port.reset()
            ref.reset()
    assert port.state() == ref.state()
    port2 = monitoring.DriftMonitor.from_state(json.loads(json.dumps(port.state())))
    ref2 = jax_monitoring.DriftMonitor.from_state(ref.state())
    extra = _stream(rng, 64, mean=(9.8, 0, 0))
    assert _report_fields(port2.update(extra)) == _report_fields(ref2.update(extra))


def test_update_many_equals_sequential_and_jax():
    rng = np.random.default_rng(22)
    block = np.stack([_stream(rng, 50, mean=(9.8 * (i % 2), 0, 9.8)) for i in range(4)])

    def monitors(pkg):
        return [_monitor(pkg.DriftMonitor, halflife=50.0 + 25 * i) if i != 2 else None
                for i in range(4)]

    batched = monitoring.DriftMonitor.update_many(monitors(monitoring), block)
    seq = monitors(monitoring)
    ref = jax_monitoring.DriftMonitor.update_many(monitors(jax_monitoring), block)
    assert batched[2] is None and ref[2] is None
    for i in (0, 1, 3):
        want = _report_fields(seq[i].update(block[i]))
        assert _report_fields(batched[i]) == want == _report_fields(ref[i])


class _Stub:
    num_classes = 2

    def transform(self, x):
        p = np.tile([[0.8, 0.2]], (len(x), 1))
        return Predictions.from_raw(np.log(p), p)


def test_single_push_drifted_recording_flags_events():
    rng = np.random.default_rng(7)
    rec = np.concatenate([_stream(rng, 600), _stream(rng, 1400, mean=(9.8, 0.0, 0.0))])
    sc = StreamingClassifier(_Stub(), window=50, hop=50, smoothing="none",
                             monitor=_monitor(monitoring.DriftMonitor))
    events = sc.push(rec)
    assert len(events) == 40
    assert not events[0].drift and events[-1].drift
    first_flag = next(i for i, e in enumerate(events) if e.drift)
    assert events[first_flag].t_index > 600


def test_streaming_integration_stamps_events():
    rng = np.random.default_rng(5)
    sc = StreamingClassifier(_Stub(), window=50, hop=50, smoothing="none",
                             monitor=_monitor(monitoring.DriftMonitor))
    assert all(not e.drift for e in sc.push(_stream(rng, 400)))
    shifted = []
    for _ in range(6):
        shifted.extend(sc.push(_stream(rng, 400, mean=(9.8, 0.0, 0.0))))
    assert shifted[-1].drift
    assert sc.drift_report is not None and sc.drift_report.drifting
    sc.reset()
    assert sc.drift_report is None
    assert not sc.push(_stream(rng, 50))[0].drift


@pytest.fixture(scope="module")
def saved_pair(tmp_path_factory):
    """One CNN1D at T = 200 saved by each package: the port's params.npz
    and har_tpu's orbax checkpoint, the same parameters and scaler."""
    from har_tpu.checkpoint import save_model as jax_save_model
    from har_tpu_torch import checkpoint

    base = tmp_path_factory.mktemp("monitor_ckpts")
    port, jax_model, kwargs = random_pair("cnn1d", window=200, classes=6, seed=3)
    # the scaler of a model trained on the calibrated generator's windows
    from har_tpu_torch.data.raw_windows import synthetic_raw_stream
    from har_tpu_torch.features.scaler import StandardScaler

    fitted = StandardScaler().fit(synthetic_raw_stream(n_windows=256, seed=1).windows)
    port = type(port)(port.inner, fitted, port.num_classes)
    jax_model = type(jax_model)(jax_model.inner, type(jax_model.scaler)(
        mean=fitted.mean, std=fitted.std), jax_model.num_classes)
    port_path = checkpoint.save_model(str(base / "port"), port, "cnn1d", kwargs,
                                      input_shape=(200, 3))
    jax_kwargs = {k: (list(v) if isinstance(v, tuple) else v) for k, v in kwargs.items()}
    jax_path = jax_save_model(str(base / "jax"), jax_model, "cnn1d", jax_kwargs,
                              input_shape=(200, 3))
    return port_path, jax_path, base


def _cli_json(main, argv, capsys):
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("drifted", [False, True])
def test_cli_stream_monitor_matches_jax(saved_pair, capsys, drifted):
    """`stream --monitor` of both packages, the demo recording or a wildly
    out-of-distribution one: the drift blocks are equal."""
    from har_tpu.cli import main as jax_main
    from har_tpu_torch.cli import main

    port_path, jax_path, base = saved_pair
    extra = []
    if drifted:
        rec = np.random.default_rng(8).normal(size=(1200, 3)) * 30.0 + 50.0
        rec_csv = str(base / "drifted.csv")
        np.savetxt(rec_csv, rec, delimiter=",", fmt="%.4f")
        extra = ["--input", rec_csv]
    got = _cli_json(main, ["stream", "--checkpoint", port_path, "--device", "cpu",
                           "--hop", "100", "--monitor", *extra], capsys)
    want = _cli_json(jax_main, ["stream", "--checkpoint", jax_path, "--hop", "100",
                                "--monitor", *extra], capsys)
    assert got["drift"] == want["drift"]
    assert got["drift"]["drifting"] is drifted
    assert len(got["drift"]["location_z"]) == 3
    if drifted:
        assert got["drift"]["events_flagged"] > 0
    assert got["timeline"] == want["timeline"]


def test_cli_monitor_without_scaler_is_a_clean_error(tmp_path):
    from har_tpu_torch import checkpoint
    from har_tpu_torch.cli import main

    port, _, kwargs = random_pair("cnn1d", window=200)
    port = type(port)(port.inner, None, port.num_classes)
    ckpt = checkpoint.save_model(str(tmp_path / "ckpt"), port, "cnn1d", kwargs,
                                 input_shape=(200, 3))
    with pytest.raises(SystemExit, match="standardize=False"):
        main(["stream", "--checkpoint", ckpt, "--device", "cpu", "--monitor"])
