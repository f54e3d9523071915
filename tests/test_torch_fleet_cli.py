"""`serve` of the port's CLI (har_tpu_torch.cli) on the CPU.

The JAX package's CLI pins (tests/test_fleet_serving.py) on the port, then:
the summary JSON has har_tpu's keys (both CLIs on the same arguments);
a narrow transformer checkpoint (1 layer, embed 16, float32) served
plain, pipelined and fused, at the int8 tier, and through a journal with
a hard kill and a resume that loses and repeats nothing; the serving
mesh flags (``--mesh``, ``--mesh-shape``, their messages, and the
``--autoscale`` mesh rung); the fleet cluster (``--workers``, ``--net``,
``--kill-worker``) and ``--trace``'s refusal of it.  The drift loop (``--adapt``, its
journaled kill and ``--resume --adapt --registry``) and the churn fleet
(``--trace`` with ``--autoscale``) run on the analytic model and the
transformer, with har_tpu's summary keys.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from har_tpu_torch import checkpoint, cli
from tests.test_torch_serving import random_pair

torch.set_num_threads(1)


def test_cli_serve_thousand_sessions(capsys):
    """Acceptance: `har_tpu serve --sessions 1000` on the CPU mesh —
    zero dropped windows at nominal load, every window scored."""
    from har_tpu_torch.cli import main

    rc = main(["serve", "--device", "cpu", "--sessions", "1000"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["sessions"] == 1000
    assert out["dropped"] == 0
    assert out["scored"] == out["enqueued"] == 2000
    assert out["n_events"] == 2000
    assert out["event_p99_ms"] is not None
    assert out["stats"]["accounting"]["balanced"]
    assert out["windows_per_sec"] > 0


def test_cli_serve_pipeline_depth(capsys):
    """`serve --pipeline-depth 2`: zero drops, every window scored once,
    and the pipeline fields surfaced in the summary (the analytic demo
    model is host-side, so the dispatch backend is host scoring)."""
    from har_tpu_torch.cli import main

    rc = main(["serve", "--device", "cpu", "--sessions", "64", "--pipeline-depth", "2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pipeline_depth"] == 2
    assert out["dropped"] == 0
    assert out["scored"] == out["enqueued"]
    assert out["stats"]["accounting"]["balanced"]
    assert out["stats"]["dispatch_backend"] == "host"


def _cnn_checkpoint(tmp_path) -> str:
    """A CNN1D checkpoint of 128-sample windows, one epoch on synthetic
    windows."""
    from har_tpu_torch.checkpoint import save_model
    from har_tpu_torch.data.raw_windows import synthetic_raw_stream
    from har_tpu_torch.features.wisdm_pipeline import FeatureSet
    from har_tpu_torch.models.neural_classifier import NeuralClassifier
    from har_tpu_torch.train.trainer import TrainerConfig

    raw = synthetic_raw_stream(n_windows=64, seed=0, window=128)
    model = NeuralClassifier(
        "cnn1d",
        config=TrainerConfig(batch_size=64, epochs=1, learning_rate=1e-3,
                             seed=0),
        model_kwargs={"channels": (8,)},
        device="cpu",
    ).fit(FeatureSet(features=raw.windows,
                     label=raw.labels.astype(np.int32)))
    ckpt = str(tmp_path / "ckpt")
    save_model(ckpt, model, "cnn1d", model_kwargs={"channels": (8,)},
               input_shape=(128, 3))
    return ckpt


def test_cli_serve_honors_checkpoint_geometry(tmp_path, capsys):
    """serve --checkpoint adopts the checkpoint's recorded input_shape
    (the from_checkpoint guard, fleet edition): a 128-sample-window
    model is served 128-sample windows, not the default 200."""
    import json

    from har_tpu_torch.cli import main

    ckpt = _cnn_checkpoint(tmp_path)
    rc = main(
        ["serve", "--device", "cpu", "--sessions", "4", "--checkpoint", ckpt,
         "--hop", "128"]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # 4 sessions x 2 windows of 128 samples each, all scored: the
    # engine ran at the checkpoint's geometry (at window=200 a 256-
    # sample recording would complete only ONE window per session)
    assert out["scored"] == 8
    assert out["dropped"] == 0


def test_cli_serve_with_monitor_and_faults(capsys):
    from har_tpu_torch.cli import main

    rc = main(
        [
            "serve", "--device", "cpu", "--sessions", "32", "--monitor",
            "--inject-drop", "0.1", "--inject-delay", "0.1",
            "--inject-stall-every", "3", "--inject-stall-ms", "1",
        ]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["sessions"] == 32
    assert out["load"]["dropped_deliveries"] >= 0
    assert out["stats"]["accounting"]["balanced"]
    assert "drift_events" in out


def _summary(capsys, argv):
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_serve_summary_keys_equal_jax(capsys):
    """Both CLIs on the same arguments: the same summary keys, stats
    keys and load keys, and the same counts (the analytic model is
    row-independent numpy on both sides)."""
    import har_tpu.cli as jax_cli

    argv = ["serve", "--sessions", "16", "--monitor", "--profile-host"]
    ours = _summary(capsys, argv + ["--device", "cpu"])
    assert jax_cli.main(argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ours) == set(theirs)
    assert set(ours["stats"]) == set(theirs["stats"])
    assert set(ours["load"]) == set(theirs["load"])
    assert set(ours["host_profile"]) == set(theirs["host_profile"])
    for key in ("n_events", "enqueued", "scored", "dropped", "drift_events",
                "lost_in_crash", "recoveries", "devices", "pipeline_depth"):
        assert ours[key] == theirs[key], key
    assert ours["load"]["samples_delivered"] == theirs["load"]["samples_delivered"]


@pytest.fixture(scope="module")
def transformer_checkpoint(tmp_path_factory):
    port, _, kwargs = random_pair(
        "transformer", window=200, classes=6, seed=4,
        kwargs=dict(embed_dim=16, num_heads=2, num_layers=1),
    )
    path = str(tmp_path_factory.mktemp("fleet_ckpt") / "transformer")
    return checkpoint.save_model(path, port, "transformer", kwargs,
                                 input_shape=(200, 3))


@pytest.mark.parametrize("extra, backend, fused", [
    ([], "device", False),
    (["--pipeline-depth", "3", "--fused", "--smoothing", "vote"], "device", True),
    (["--tier", "int8"], "device", False),
    (["--calibrate-device"], "device", False),
], ids=["plain", "pipelined_fused_vote", "int8", "calibrate"])
def test_cli_serve_transformer_checkpoint(capsys, transformer_checkpoint,
                                          extra, backend, fused):
    out = _summary(capsys, ["serve", "--device", "cpu", "--sessions", "24",
                            "--checkpoint", transformer_checkpoint, *extra])
    acct = out["stats"]["accounting"]
    assert out["n_events"] == out["scored"] == out["enqueued"] == 48
    assert out["dropped"] == 0 and acct["balanced"] and acct["pending"] == 0
    assert out["stats"]["dispatch_backend"] == backend
    assert out["stats"]["fused"] is fused
    if "--calibrate-device" in extra:
        # the smallest shape and every padded shape dispatched (which
        # ones depends on the deadline's wall clock)
        sizes = {int(b) for b in out["stats"]["device_ms"]}
        assert 1 in sizes and all(b & (b - 1) == 0 and b <= 64 for b in sizes)
        assert out["stats"]["dispatch_p99_attribution"]["device_p50_ms"] > 0


def test_cli_serve_transformer_journal_kill_and_resume(tmp_path, capsys,
                                                      transformer_checkpoint):
    """A hard kill mid-run (exit 17) and a ``--resume``: the resumed run
    recovers from the journal, and across the two processes every
    window is scored once — no (session, t_index) twice, none lost."""
    jdir = str(tmp_path / "wal")
    args = ["--device", "cpu", "--sessions", "12", "--windows-per-session", "3",
            "--checkpoint", transformer_checkpoint, "--journal", jdir,
            "--journal-flush-every", "4", "--max-delay-ms", "0"]
    proc = subprocess.run(
        [sys.executable, "-m", "har_tpu_torch.cli", "serve", *args,
         "--kill-after-polls", "2"],
        capture_output=True, text=True, env=dict(os.environ),
    )
    assert proc.returncode == 17, proc.stderr[-500:]
    out = _summary(capsys, ["serve", *args, "--resume"])
    assert out["resumed"] is True and out["recoveries"] == 1
    assert out["lost_in_crash"] == 0 and out["dropped"] == 0
    assert out["enqueued"] == out["scored"] == 36
    assert out["stats"]["accounting"]["balanced"]
    assert out["stats"]["accounting"]["pending"] == 0
    # the resumed run emitted only what the first never acked
    assert 0 < out["n_events"] < 36


@pytest.mark.parametrize("flags, item", [
    # ids kept: every flag here was refused until its part was ported.
    # item None runs the flag on one server, "cluster" runs a fleet
    # cluster, "exit" is har_tpu's SystemExit for --trace with a cluster
    pytest.param(["--adapt", "--mesh", "2", "--inject-drift", "0.5",
                  "--windows-per-session", "6", "--max-delay-ms", "0"], None,
                 id="--adapt-13"),
    pytest.param(["--mesh", "8", "--pipeline-depth", "2", "--fused",
                  "--smoothing", "vote"], None, id="--mesh-14"),
    pytest.param(["--mesh-shape", "2x4", "--tier", "int8"], None, id="--mesh-shape-14"),
    pytest.param(["--workers", "2"], "cluster", id="--workers-15"),
    pytest.param(["--workers", "2", "--net"], "cluster", id="--net-15"),
    pytest.param(["--workers", "3", "--kill-worker", "w1"], "cluster",
                 id="--kill-worker-15"),
    pytest.param(["--trace", "diurnal", "--workers", "2"], "exit", id="--trace-15"),
    pytest.param(["--trace", "storm", "--autoscale", "--net"], "exit",
                 id="--autoscale-15"),
], ids=lambda v: v[0] if isinstance(v, list) else str(v))
def test_cli_serve_waiting_flags_name_their_item(flags, item, monkeypatch, capsys):
    """Each of these flags runs: ``--mesh 8`` shards the demo MLP's
    batches over the CPU repeated 8 times, ``--mesh-shape 2x4`` places
    its int8 tier model-parallel, ``--adapt`` runs its loop over a mesh,
    ``--workers`` serves a fleet cluster (in-process, or ``--net`` over
    two ``serve-worker`` processes) and ``--kill-worker w1`` fails
    ``w1``'s partition over.  ``--trace`` refuses a cluster with
    har_tpu's SystemExit before any session is built."""
    if item is None:
        out = _summary(capsys, ["serve", "--device", "cpu", "--sessions", "8", *flags])
        assert out["dropped"] == 0 and out["scored"] == out["enqueued"] > 0
        assert out["stats"]["accounting"]["balanced"]
        if "--adapt" not in flags:
            stats = out["stats"]
            assert (stats["devices"], stats["model_axis_shards"], stats["dispatch_backend"]) == (
                (8, 1, "sharded") if "--mesh" in flags else (2, 4, "model_parallel"))
        return
    if item == "cluster":
        argv = ["serve", "--device", "cpu", "--sessions", "8", *flags]
        if "--net" in flags:
            # worker subprocesses: niced, one file's at a time
            from tests.test_torch_net import _run_cli_niced

            out = _run_cli_niced(argv)
        else:
            out = _summary(capsys, argv)
        assert out["balanced"] and out["pending"] == 0 and out["dropped"] == 0
        assert out["scored"] == out["enqueued"] == out["n_events"] == 16
        assert out.get("transport") == ("tcp" if "--net" in flags else None)
        if "--kill-worker" in flags:
            assert out["killed_worker"] == "w1" and out["retired"] == ["w1"]
            assert out["failovers"] == 1 and out["workers"] == 2
        else:
            assert out["failovers"] == 0 and out["workers"] == 2
        return
    import har_tpu_torch.serve.loadgen as loadgen

    def never(*a, **k):
        raise AssertionError("sessions were built before the refusal")

    monkeypatch.setattr(loadgen, "synthetic_sessions", never)
    with pytest.raises(SystemExit, match="--trace drives its own churn"):
        cli.main(["serve", "--device", "cpu", "--sessions", "4", *flags])


def test_cli_serve_mesh_shape_2d(capsys):
    """``serve --mesh-shape 2x4`` with the analytic demo model: a host
    model cannot shard, so the dispatch falls back to host scoring — the
    flag is honored, not a crash (``har_tpu``'s contract)."""
    out = _summary(capsys, ["serve", "--device", "cpu", "--sessions", "32",
                            "--mesh-shape", "2x4"])
    assert out["dropped"] == 0 and out["scored"] == out["enqueued"]
    assert out["stats"]["accounting"]["balanced"]
    assert out["stats"]["dispatch_backend"] == "host"


def test_cli_serve_mesh_exceeding_devices_exits_with_hint(monkeypatch):
    """More devices than the visible cards: ``har_tpu``'s message with
    the port's hint (``--device cpu`` for a dry-run mesh), before any
    session is built."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match=r"--mesh 4096 needs 4096 devices but only 1 are "
                                         r"visible; on a CPU host pass --device cpu"):
        cli.main(["serve", "--sessions", "2", "--mesh", "4096"])
    with pytest.raises(SystemExit, match=r"--mesh-shape 64x64 needs 4096 devices"):
        cli.main(["serve", "--sessions", "2", "--mesh-shape", "64x64"])


def test_cli_serve_mesh_shape_rejects_malformed_and_mesh_combo():
    with pytest.raises(SystemExit, match="not BxM"):
        cli.main(["serve", "--device", "cpu", "--sessions", "2", "--mesh-shape", "2x"])
    with pytest.raises(SystemExit, match="pass one"):
        cli.main(["serve", "--device", "cpu", "--sessions", "2", "--mesh", "4",
                  "--mesh-shape", "2x2"])


def test_cli_serve_mesh_shape_refuses_a_family_without_tensor_parallelism(tmp_path, capsys):
    """A CNN1D checkpoint serves on a model axis (``--mesh-shape 2x2``,
    model-parallel) and on data axes (``--mesh 2``); a checkpoint the port
    still has no tensor-parallel forward for — a sequence-sharded
    transformer — makes ``--mesh-shape 2x2`` exit with a message instead
    of serving it on fewer devices."""
    from har_tpu_torch.models.neural import build_model
    from har_tpu_torch.models.neural_classifier import NeuralClassifierModel
    from har_tpu_torch.train.trainer import NeuralModel

    ckpt = _cnn_checkpoint(tmp_path)
    argv = ["serve", "--device", "cpu", "--sessions", "4", "--checkpoint", ckpt,
            "--hop", "128"]
    out = _summary(capsys, argv + ["--mesh-shape", "2x2"])
    assert out["stats"]["dispatch_backend"] == "model_parallel"
    assert out["scored"] == out["enqueued"] > 0
    assert cli.main(argv + ["--mesh", "2"]) == 0
    capsys.readouterr()
    kwargs = dict(embed_dim=16, num_heads=2, num_layers=1, sp_axis="sp", dtype="float32")
    module = build_model("transformer", 6, in_features=3, **kwargs).eval()
    ring = checkpoint.save_model(
        str(tmp_path / "ring"), NeuralClassifierModel(NeuralModel(module=module, num_classes=6),
                                                      None, 6),
        "transformer", kwargs, input_shape=(200, 3))
    with pytest.raises(SystemExit, match=r"--mesh-shape 2x2: a sequence-sharded transformer "
                                         r"has no tensor-parallel forward.*--mesh N"):
        cli.main(["serve", "--device", "cpu", "--sessions", "4", "--checkpoint", ring,
                  "--mesh-shape", "2x2"])


def _jax_summary(capsys, argv):
    import har_tpu.cli as jax_cli

    assert jax_cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_serve_adapt_summary_keys_equal_jax(tmp_path, capsys):
    """``serve --adapt --inject-drift 0.5`` in both CLIs: the loop closes
    in each (one retrain, one swap, no rollback, nothing dropped), and
    the summary, stats and ``adapt`` status keys are har_tpu's."""
    argv = ["serve", "--sessions", "24", "--windows-per-session", "6",
            "--adapt", "--inject-drift", "0.5"]
    ours = _summary(capsys, argv + ["--device", "cpu", "--registry",
                                    str(tmp_path / "reg_port")])
    theirs = _jax_summary(capsys, argv + ["--registry", str(tmp_path / "reg_jax")])
    assert set(ours) == set(theirs)
    assert set(ours["stats"]) == set(theirs["stats"])
    for out in (ours, theirs):
        adapt = out["adapt"]
        assert adapt["retrain_jobs"] == 1 and adapt["swaps"] == 1
        assert adapt["rollbacks"] == 0 and adapt["serving_version"] == "v0000002"
        assert out["dropped"] == 0 and out["stats"]["accounting"]["balanced"]
    assert set(ours["adapt"]) <= set(theirs["adapt"]) | {"shadow", "probation_shadow"}
    for key in ("enqueued", "scored", "sessions"):
        assert ours[key] == theirs[key], key


def test_cli_serve_adapt_transformer_checkpoint_closes_the_loop(
        tmp_path, capsys, transformer_checkpoint):
    """The drift loop over the narrow transformer on the device plane,
    one dispatch a poll: the demo retrainer's candidate shadows, swaps,
    serves and passes probation; no shadow batch raised, nothing
    dropped."""
    out = _summary(capsys, [
        "serve", "--device", "cpu", "--sessions", "24",
        "--windows-per-session", "12", "--max-delay-ms", "0",
        "--checkpoint", transformer_checkpoint,
        "--adapt", "--inject-drift", "0.5", "--registry", str(tmp_path / "reg")])
    adapt, snap = out["adapt"], out["stats"]
    assert adapt["swaps"] == 1 and adapt["rollbacks"] == 0
    assert adapt["state"] == "serving" and adapt["serving_version"] == "v0000002"
    assert adapt["retrain_errors"] == adapt["registry_errors"] == 0
    assert snap["shadow_errors"] == 0 and snap["shadow_batches"] > 0
    assert snap["dispatch_backend"] == "device"
    assert out["dropped"] == 0 and snap["accounting"]["balanced"]
    assert set(snap["scored_by_version"]) == {"v0000001", "v0000002"}
    assert sum(snap["scored_by_version"].values()) == out["scored"] == 288


def test_cli_serve_adapt_raises_when_shadow_scoring_fails(tmp_path, monkeypatch):
    """A candidate whose scoring raises (a device-path fault) is counted
    by the engine, as in har_tpu, but ``serve`` then ends with an error
    instead of a summary."""
    from har_tpu_torch.adapt import shadow

    def broken(self, *a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(shadow.ShadowEvaluator, "__call__", broken)
    with pytest.raises(RuntimeError, match="shadow-scored batch"):
        cli.main(["serve", "--device", "cpu", "--sessions", "24",
                  "--windows-per-session", "6", "--adapt", "--inject-drift", "0.5",
                  "--registry", str(tmp_path / "reg")])


def test_cli_serve_resume_adapt_needs_a_registry(tmp_path):
    with pytest.raises(SystemExit, match="--registry"):
        cli.main(["serve", "--device", "cpu", "--sessions", "4", "--adapt",
                  "--journal", str(tmp_path / "wal"), "--resume"])


@pytest.mark.parametrize("kill_after", [3, 5])
def test_cli_serve_adapt_journal_kill_and_resume(tmp_path, capsys, kill_after):
    """A journaled ``--adapt`` run killed hard (exit 17) before the
    trigger fires (3 polls) and while a candidate shadows (5), then
    ``--resume --adapt --registry``: the resumed fleet serves the
    registry's CURRENT, a promoted candidate, every window is scored
    once across the two processes — and har_tpu's CLI, killed and
    resumed the same way, ends in the same versions and counts."""
    from har_tpu_torch.adapt import ModelRegistry

    def run(module, root):
        args = ["--sessions", "24", "--windows-per-session", "6", "--adapt",
                "--inject-drift", "0.5", "--registry", str(root / "reg"),
                "--journal", str(root / "wal"), "--journal-flush-every", "4",
                "--max-delay-ms", "0"]
        if module == "har_tpu_torch.cli":
            args += ["--device", "cpu"]
        proc = subprocess.run(
            [sys.executable, "-m", module, "serve", *args,
             "--kill-after-polls", str(kill_after)],
            capture_output=True, text=True, env=dict(os.environ),
        )
        assert proc.returncode == 17, proc.stderr[-500:]
        if module == "har_tpu_torch.cli":
            return _summary(capsys, ["serve", *args, "--resume"])
        return _jax_summary(capsys, ["serve", *args, "--resume"])

    out = run("har_tpu_torch.cli", tmp_path / "port")
    acct = out["stats"]["accounting"]
    assert out["resumed"] is True and out["recoveries"] == 1
    assert out["lost_in_crash"] == 0 and out["dropped"] == 0
    assert out["enqueued"] == out["scored"] == 144
    assert acct["balanced"] and acct["pending"] == 0
    assert 0 < out["n_events"] < 144
    current = ModelRegistry(str(tmp_path / "port" / "reg")).current()
    assert out["adapt"]["serving_version"] == current.name
    assert current.version >= 2 and out["adapt"]["rollbacks"] == 0
    theirs = run("har_tpu.cli", tmp_path / "jax")
    for key in ("n_events", "enqueued", "scored", "recoveries"):
        assert out[key] == theirs[key], key
    for key in ("state", "serving_version", "swaps", "retrain_jobs",
                "rejected_candidates"):
        assert out["adapt"][key] == theirs["adapt"][key], key
    assert out["stats"]["scored_by_version"] == theirs["stats"]["scored_by_version"]


def test_cli_serve_trace_summary_keys_equal_jax(capsys):
    """``serve --trace diurnal --autoscale`` in both CLIs: the same keys,
    the same schedule and counts (the analytic model's scores do not
    depend on batching), zero undeclared drops, and a controller that
    walks up and back down."""
    argv = ["serve", "--sessions", "48", "--trace", "diurnal",
            "--trace-rounds", "32", "--autoscale"]
    ours = _summary(capsys, argv + ["--device", "cpu"])
    theirs = _jax_summary(capsys, argv)
    assert set(ours) == set(theirs)
    assert set(ours["autoscale"]) == set(theirs["autoscale"])
    for key in ("trace_spec", "rounds", "peak_active", "trough_active",
                "connects", "disconnects", "storm_disconnects", "slow_stalls",
                "enqueued", "scored", "n_events", "undeclared_drops", "balanced"):
        assert ours[key] == theirs[key], key
    assert ours["undeclared_drops"] == 0 and ours["balanced"]
    assert ours["scale_ups"] >= 1 and ours["scale_downs"] >= 1


@pytest.mark.parametrize("trace", ["diurnal", "bursty", "storm"])
def test_cli_serve_trace_autoscale_transformer(capsys, transformer_checkpoint, trace):
    """Each trace kind over the narrow transformer on the device plane,
    autoscaled: every window scored, nothing undeclared dropped."""
    out = _summary(capsys, ["serve", "--device", "cpu", "--sessions", "32",
                            "--trace", trace, "--trace-rounds", "24", "--autoscale",
                            "--checkpoint", transformer_checkpoint])
    assert out["undeclared_drops"] == 0 and out["balanced"]
    assert out["scored"] == out["enqueued"] == out["n_events"] > 0
    assert out["resizes"] >= 1


def test_cli_serve_trace_refusals(capsys):
    """``--trace`` refuses the steady-load modes and a cluster
    (har_tpu's SystemExit); ``--autoscale --mesh N`` runs, its ladder
    ending on the mesh rung (N devices, the CPU repeated)."""
    base = ["serve", "--device", "cpu", "--sessions", "8", "--trace", "diurnal"]
    for flags in (["--adapt"], ["--resume"], ["--kill-after-polls", "2"],
                  ["--monitor"], ["--inject-drift", "0.5"], ["--inject-drop", "0.1"],
                  ["--inject-delay", "0.1"], ["--calibrate-device"]):
        with pytest.raises(SystemExit, match="--trace drives its own churn"):
            cli.main(base + flags)
    for flags in (["--workers", "2"], ["--net"]):
        with pytest.raises(SystemExit, match="--trace drives its own churn"):
            cli.main(base + flags)
    out = _summary(capsys, ["serve", "--device", "cpu", "--sessions", "64", "--trace",
                            "diurnal", "--trace-rounds", "24", "--autoscale", "--mesh", "2",
                            "--target-batch", "16", "--fused", "--smoothing", "vote"])
    assert out["undeclared_drops"] == 0 and out["scored"] == out["enqueued"] > 0
    # floor = ceiling = 16: the ladder's rungs are the depth, then the mesh
    assert out["scale_ups"] == 2
    assert out["autoscale"]["last_action"]["knob"] == "mesh"
    assert out["autoscale"]["last_action"]["to"] == 2


def test_cli_serve_runs_on_cuda_by_default(monkeypatch):
    """Without --device the fleet asks for the card, and says so where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--adapt"], ["--trace", "diurnal", "--autoscale"]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["serve", "--sessions", "4", *extra])


@pytest.mark.parametrize("family, kwargs, tier", [
    ("cnn1d", dict(channels=(8, 8)), "f32"),
    ("cnn1d", dict(channels=(8, 8)), "int8"),
    ("bilstm", dict(hidden=16), "int8"),
], ids=["cnn1d", "cnn1d-int8", "bilstm-int8"])
def test_cli_serve_mesh_shape_serves_cnn_and_bilstm(capsys, tmp_path, family, kwargs, tier):
    """``serve --mesh-shape 2x2`` of a saved CNN1D or BiLSTM, float32 or
    the int8 tier, serves model-parallel (it used to end in SystemExit):
    every window scored, two model-axis shards."""
    port, _, saved = random_pair(family, window=200, classes=6, seed=4, kwargs=kwargs)
    path = checkpoint.save_model(str(tmp_path / family), port, family, saved,
                                 input_shape=(200, 3))
    out = _summary(capsys, ["serve", "--device", "cpu", "--sessions", "8",
                            "--checkpoint", path, "--mesh-shape", "2x2", "--tier", tier])
    assert out["dropped"] == 0 and out["scored"] == out["enqueued"] > 0
    stats = out["stats"]
    assert stats["dispatch_backend"] == "model_parallel"
    assert stats["model_axis_shards"] == 2 and stats["devices"] == 2
