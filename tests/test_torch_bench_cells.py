"""The port's bench cells against ``har_tpu``'s on the same seeded inputs.

Each cell of ``har_tpu_torch.bench``'s lanes — the pipeline and
model-parallel grid cells (``serve/loadgen.py``), the recovery benchmark
(``serve/recover.py``), the cluster failover benchmark
(``serve/cluster/smoke.py``) and the elastic traffic benchmark
(``serve/traffic/smoke.py``) — runs in both packages at a small size:
the same row keys and verdict fields, the deterministic fields equal
(dropped windows, balanced accounting, dispatches, migrated sessions,
resizes, fake-clock latencies, parameter bytes), and timing fields
checked for type and sign only.  The wire lanes (``serve/net/smoke.py``)
run in ``tests/test_torch_net.py``'s pin.  ``WideTransformerDemoModel``:
the port's probabilities equal the JAX model's within 1e-5 at a narrow
width, labels equal, and its tensor-parallel forward on a ``1x2`` CPU
mesh equals one device's within 1e-6.

The grid cells' subprocess wrappers start processes: they run under the
lock ``tests/_torch_ranks.py``'s rank groups take, with its child
environment and priority.
"""

import importlib

import numpy as np
import pytest
import torch

from tests._torch_ranks import _one_at_a_time, child_hygiene

torch.set_num_threads(1)


def _loadgen(pkg):
    return importlib.import_module(f"{pkg}.serve.loadgen")


def _both(fn_name, module, *args, **kwargs):
    """``module.fn_name(*args, **kwargs)`` in the port (on the CPU where
    it takes a device) and in ``har_tpu``."""
    ours = getattr(importlib.import_module(f"har_tpu_torch.{module}"), fn_name)
    theirs = getattr(importlib.import_module(f"har_tpu.{module}"), fn_name)
    port_kwargs = dict(kwargs)
    if module == "serve.loadgen":
        port_kwargs["device"] = "cpu"
    return ours(*args, **port_kwargs), theirs(*args, **kwargs)


def _is_time(v):
    return isinstance(v, float) and v >= 0


# (pipeline depth, devices, extra kwargs): the grid's cells at a small
# fleet, the link RTT at 0 so nothing sleeps
PIPELINE_CELLS = {
    "1x1": (1, 1, {}),
    "2x1": (2, 1, {}),
    "3x1_fused": (3, 1, dict(fused=True, smoothing="vote")),
    "3x1_fused_int8": (3, 1, dict(fused=True, smoothing="vote", tier="int8")),
    # the JAX package's mesh takes every visible device (its tests' 8)
    "3x8_fused": (3, 8, dict(fused=True, smoothing="vote")),
}
PIPELINE_COMMON = dict(n_sessions=24, target_batch=8, tunnel_rtt_ms=0.0, n_runs=2, seed=3)
# fields of a pipeline cell that the schedule alone decides
PIPELINE_EQUAL = ("pipeline_depth", "devices", "target_batch", "fused", "tier", "smoothing",
                  "dispatch_backend", "dispatches", "fused_dispatches", "fetch_bytes_per_window",
                  "fetch_bytes_saved", "dropped_windows", "accounting_balanced")


@pytest.mark.parametrize("cell", sorted(PIPELINE_CELLS))
def test_pipeline_cell_matches_jax(cell):
    depth, devices, extra = PIPELINE_CELLS[cell]
    ours, theirs = _both("run_pipeline_cell", "serve.loadgen", depth, devices,
                         collect_labels=True, **PIPELINE_COMMON, **extra)
    assert set(ours) == set(theirs)
    for key in PIPELINE_EQUAL:
        assert ours[key] == theirs[key], key
    assert ours["dropped_windows"] == 0 and ours["accounting_balanced"] is True
    # the label stream: same sessions, windows and labels
    assert ours["labels"] == theirs["labels"]
    for key in ("windows_per_sec_median", "windows_per_sec_std", "event_p99_ms_median"):
        assert _is_time(ours[key]), key
    assert ours["windows_per_sec_median"] > 0
    assert set(ours["device_ms"]) == set(theirs["device_ms"])
    assert all(_is_time(v) for v in ours["device_ms"].values())
    assert sum(ours["device_windows"].values()) == sum(theirs["device_windows"].values())
    assert (ours["overlap_pct"] is None) == (theirs["overlap_pct"] is None)


def test_fused_grid_cells_and_int8_agreement_match_jax():
    common = {k: v for k, v in PIPELINE_COMMON.items() if k != "target_batch"}
    (ours, ours_agree) = _loadgen("har_tpu_torch").run_fused_grid_cells(
        4, dict(common, device="cpu"))
    (theirs, theirs_agree) = _loadgen("har_tpu").run_fused_grid_cells(4, common)
    assert set(ours) == set(theirs) == {"3x1_fused", "3x1_fused_int8"}
    for name in ours:
        assert "labels" not in ours[name]
        assert set(ours[name]) == set(theirs[name])
        for key in PIPELINE_EQUAL:
            assert ours[name][key] == theirs[name][key], (name, key)
    assert ours_agree == theirs_agree
    assert ours_agree is not None and ours_agree >= 0.95


def test_pipeline_cell_refuses_more_cards_than_visible(monkeypatch):
    """On CUDA a cell's mesh takes distinct visible cards, and a cell that
    needs more is refused by the mesh, not emulated; the subprocess
    wrappers refuse it before a child starts."""
    import subprocess

    from har_tpu_torch.parallel import mesh

    lg = _loadgen("har_tpu_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: pytest.fail("a child started"))
    refused = "needs 8 devices but only 1 are visible"
    with pytest.raises(ValueError, match=refused):
        mesh.serving_devices(8, "cuda")
    with pytest.raises(ValueError, match=refused):
        lg.run_model_parallel_cell(8, 1, device="cuda")
    with pytest.raises(ValueError, match=refused):
        lg.run_model_parallel_cell_subprocess(2, 4, {"device": "cuda"})
    with pytest.raises(ValueError, match=refused):
        lg.run_pipeline_cell_subprocess(3, 8, {})  # the device defaults to cuda


# (dp, tp, kwargs) of the model-parallel grid at a small fleet
MP_CELLS = {
    "1x1": (1, 1, {}),
    "4x1": (4, 1, {}),
    "2x2": (2, 2, {}),
    "1x2_wide_transformer": (1, 2, dict(n_sessions=3, windows_per_session=1, target_batch=4,
                                        model="wide_transformer",
                                        check_single_device=True)),
}
MP_COMMON = dict(n_sessions=16, target_batch=8, tunnel_rtt_ms=0.0, n_runs=1, seed=3)
MP_EQUAL = ("mesh", "dp", "tp", "devices", "model", "pipeline_depth", "target_batch", "scorer",
            "model_axis_shards", "params_bytes_total", "params_bytes_per_device",
            "dropped_windows", "accounting_balanced", "single_device_equivalent")


@pytest.mark.parametrize("cell", sorted(MP_CELLS))
def test_model_parallel_cell_matches_jax(cell):
    dp, tp, extra = MP_CELLS[cell]
    ours, theirs = _both("run_model_parallel_cell", "serve.loadgen", dp, tp,
                         **{**MP_COMMON, **extra})
    assert set(ours) == set(theirs)
    for key in MP_EQUAL:
        assert ours.get(key) == theirs.get(key), key
    assert ours["dropped_windows"] == 0 and ours["accounting_balanced"] is True
    assert _is_time(ours["windows_per_sec_median"]) and ours["windows_per_sec_median"] > 0
    if "wide" in cell:
        assert ours["single_device_equivalent"] is True
        assert ours["params_bytes_per_device"] < ours["params_bytes_total"]


def test_cell_subprocesses_run_the_port():
    """The subprocess wrappers run the cell in a fresh interpreter (the
    port's launchers' environment and priority) and return its row; a
    failing cell raises with the child's error."""
    lg = _loadgen("har_tpu_torch")
    with _one_at_a_time(), child_hygiene():
        row = lg.run_pipeline_cell_subprocess(
            2, 2, dict(PIPELINE_COMMON, n_runs=1, device="cpu"), timeout_s=240)
        mp = lg.run_model_parallel_cell_subprocess(
            1, 2, dict(MP_COMMON, device="cpu"), timeout_s=240)
        with pytest.raises(RuntimeError, match="unknown model"):
            lg.run_model_parallel_cell_subprocess(
                1, 1, dict(MP_COMMON, model="nope", device="cpu"), timeout_s=240)
    assert row["devices"] == 2 and row["dispatch_backend"] == "sharded"
    assert row["dropped_windows"] == 0 and row["accounting_balanced"] is True
    assert mp["scorer"] == "ModelParallelScorer" and mp["model_axis_shards"] == 2


def test_wide_transformer_matches_jax_at_a_narrow_width():
    narrow = dict(embed_dim=64, num_layers=2, num_heads=4)
    ours = _loadgen("har_tpu_torch").WideTransformerDemoModel(**narrow, device="cpu")
    theirs = _loadgen("har_tpu").WideTransformerDemoModel(**narrow)
    # the same numpy draws: every kernel equal to JAX's, transposed
    for i, block in enumerate(ours.module.blocks):
        jax_block = theirs.params[f"EncoderBlock_{i}"]
        for port_name, jax_name in (("qkv", "qkv"), ("proj", "proj"),
                                    ("mlp_in", "Dense_0"), ("mlp_out", "Dense_1")):
            np.testing.assert_array_equal(
                getattr(block, port_name).weight.numpy().T,
                np.asarray(jax_block[jax_name]["kernel"]))
    x = np.random.default_rng(0).normal(size=(7, 200, 3)).astype(np.float32)
    p_ours, p_theirs = ours.transform(x), theirs.transform(x)
    np.testing.assert_allclose(p_ours.probability, np.asarray(p_theirs.probability),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(p_ours.prediction, np.asarray(p_theirs.prediction))


def test_wide_transformer_tensor_parallel_forward_equals_one_device():
    from har_tpu_torch.parallel.mesh import create_serving_mesh
    from har_tpu_torch.parallel.rules import TRANSFORMER_RULES, rules_for_params
    from har_tpu_torch.serve.dispatch import ModelParallelScorer, make_scorer

    model = _loadgen("har_tpu_torch").WideTransformerDemoModel(
        embed_dim=64, num_layers=2, num_heads=4, device="cpu")
    assert rules_for_params(dict(model.module.named_parameters())) is TRANSFORMER_RULES
    mesh = create_serving_mesh(1, 2, devices=[torch.device("cpu")] * 2)
    scorer = make_scorer(model, mesh=mesh)
    assert isinstance(scorer, ModelParallelScorer)
    x = np.random.default_rng(1).normal(size=(6, 200, 3)).astype(np.float32)
    one = model.transform(x)
    probs = scorer.fetch(scorer.launch(scorer.pad(x)), len(x))
    np.testing.assert_allclose(probs, one.probability, atol=1e-6, rtol=0)
    pb = scorer.params_bytes()
    assert pb["per_device"] < pb["total"]


def test_recovery_benchmark_matches_jax():
    ours, theirs = _both("recovery_benchmark", "serve.recover", [8, 16], n_runs=2)
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for key in ("n_sessions", "windows", "contract_ok"):
            assert a[key] == b[key], key
        assert a["contract_ok"] is True
        assert a["journal_mb"] > 0
        assert len(a["recovery_ms_runs"]) == 2
        assert all(_is_time(v) for v in a["recovery_ms_runs"])
        assert _is_time(a["recovery_ms_median"]) and _is_time(a["recovery_ms_std"])
    s_ours, s_theirs = _both("recovery_benchmark_summary", "serve.recover", ours, 2)
    assert set(s_ours) == set(s_theirs)
    assert s_ours["contract_ok"] is True and s_ours["n_runs"] == s_theirs["n_runs"] == 2


def test_failover_benchmark_matches_jax():
    ours, theirs = _both("failover_benchmark", "serve.cluster.smoke", [12, 24], n_runs=2)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for key in ("n_sessions", "workers", "migrated_sessions", "contract_ok"):
            assert a[key] == b[key], key
        assert a["contract_ok"] is True and a["migrated_sessions"] > 0
        for key in ("failover_ms_median", "failover_ms_std", "migration_ms_median"):
            assert _is_time(a[key]), key


def test_elastic_traffic_benchmark_matches_jax():
    ours, theirs = _both("elastic_traffic_benchmark", "serve.traffic.smoke",
                         n_runs=2, smoke=True)
    assert set(ours) == set(theirs)
    # the trace, the cost model and every fake-clock number are equal
    for key in ("trace", "swing", "dispatch_cost_model", "best_static_p99_ms",
                "best_static_shed_rate", "parity_floor", "parity_checked",
                "beats_static", "contract_ok"):
        assert ours[key] == theirs[key], key
    assert set(ours["configs"]) == set(theirs["configs"])
    for name, row in ours["configs"].items():
        other = theirs["configs"][name]
        assert set(row) == set(other)
        for key in ("target_batch", "autoscale", "n_runs", "p99_ms_median",
                    "shed_rate_median", "resizes", "contract_ok"):
            assert row[key] == other[key], (name, key)
        assert _is_time(row["windows_per_sec_median"]) and row["windows_per_sec_median"] > 0
    assert ours["beats_static"] is True and ours["contract_ok"] is True
    assert ours["configs"]["autoscaled"]["resizes"] >= 2
