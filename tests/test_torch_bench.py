"""The port's bench (``har_tpu_torch/bench.py``, ``cli bench``) end to
end on the CPU, and its pieces.

``test_bench_smoke_end_to_end`` runs the whole bench in smoke mode
through ``python -m har_tpu_torch.cli bench --device cpu``'s entry point
with a small budget (the expensive lanes deadline-skip; their markers are
part of the assembly under test) and holds every contract that the JAX
package's ``tests/test_bench_e2e.py::test_bench_smoke_end_to_end``
asserts of ``bench.main()``'s line, plus the port's own: it writes only
where it is pointed, never under ``artifacts/``.  Its lanes may start
worker and cell processes, so it runs under the lock
``tests/_torch_ranks.py``'s rank groups take, with its child environment
and priority.  No wall-clock assert.
"""

import json
import os
import pathlib
import time

import pytest
import torch

from tests._torch_ranks import _one_at_a_time, child_hygiene

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _tree_state(path: pathlib.Path) -> dict:
    return {p.relative_to(path).as_posix(): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in path.rglob("*") if p.is_file()}


def test_bench_smoke_end_to_end(tmp_path, monkeypatch, capsys):
    from har_tpu_torch import cli

    art = tmp_path / "art"
    monkeypatch.setenv("HAR_TPU_BENCH_SMOKE", "1")
    monkeypatch.setenv("HAR_TPU_BENCH_ARTIFACT_DIR", str(art))
    monkeypatch.setenv("HAR_TPU_BENCH_BUDGET_S", "60")
    monkeypatch.setenv("HAR_TPU_WISDM_CSV", "/nonexistent")
    # hermetic real-data lanes: no ./data, no ~/data, no env roots
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("HAR_TPU_UCIHAR_ROOT", raising=False)
    monkeypatch.delenv("HAR_TPU_WISDM_RAW", raising=False)
    before = _tree_state(ROOT / "artifacts")
    with _one_at_a_time(), child_hygiene():
        rc = cli.main(["bench", "--device", "cpu"])
    assert rc == 0
    assert _tree_state(ROOT / "artifacts") == before

    captured = capsys.readouterr()
    line = captured.out.strip().splitlines()[-1]
    result = json.loads(line)

    # the line's contract: one JSON object with these keys
    assert result["metric"] == "wisdm_mlp_train_throughput"
    assert result["unit"] == "windows/s"
    assert result["value"] > 0
    assert result["vs_baseline"] > 0
    assert result["smoke_mode"] is True

    extra = result["extra"]
    assert extra["backend"] == "cpu" and extra["chip_peak_tflops"] is None
    # every lane is present (ran or carried a skip/error marker)
    assert set(extra["lanes"]) == {
        "mlp", "cnn1d", "bilstm", "transformer", "saturation_transformer",
        "fleet_serving", "fleet_pipeline_grid", "model_parallel_grid",
        "adaptive_serving", "fleet_recovery", "cluster_failover",
        "wire_failover", "journal_ship", "wire_ingest", "gateway_ha",
        "elastic_traffic", "host_plane_scaling",
    }
    for name, stats in extra["lanes"].items():
        assert "error" not in stats, (name, stats)
    # the unguarded core lanes always run
    assert extra["lanes"]["mlp"]["n_runs"] == 3
    assert extra["mlp_epochs"] == 1
    assert extra["tree_kernel_work"]["gbdt_rounds"] == 15
    fleet = extra["lanes"]["fleet_serving"]
    if "skipped" not in fleet:
        assert fleet["n_runs"] >= 3
        assert fleet["windows_per_sec_median"] > 0
        assert fleet["event_p99_ms_median"] >= 0
        assert fleet["dropped_windows"] == 0
        assert "chip_state_probe" in fleet
        assert extra["fleet_event_p99_ms"] == fleet["event_p99_ms_median"]
    grid_lane = extra["lanes"]["fleet_pipeline_grid"]
    if "skipped" not in grid_lane:
        grid = grid_lane["grid"]
        assert "1x1" in grid and "2x1" in grid
        assert "3x1_fused" in grid and "3x1_fused_int8" in grid
        assert grid_lane["emulated_tunnel_rtt_ms"] > 0
        for cell in grid.values():
            if "error" in cell:
                continue
            assert cell["dropped_windows"] == 0
            assert cell["accounting_balanced"] is True
            assert cell["windows_per_sec_median"] > 0
        assert grid["1x1"]["pipeline_depth"] == 1
        assert grid["1x1"]["fused"] is False
        for name in ("3x1_fused", "3x1_fused_int8"):
            cell = grid[name]
            assert cell["pipeline_depth"] == 3
            assert cell["fused"] is True
            assert cell["fused_dispatches"] == cell["dispatches"] > 0
            assert cell["fetch_bytes_saved"] > 0
        assert grid["3x1_fused_int8"]["tier"] == "int8"
        assert extra["int8_agreement"] == grid_lane["int8_agreement"]
        if grid_lane["int8_agreement"] is not None:
            assert grid_lane["int8_agreement"] >= 0.95
        mesh_cell = grid[grid_lane["mesh_cell"]]
        if mesh_cell["devices"] > 1:
            assert mesh_cell["dispatch_backend"] == "sharded"
            assert mesh_cell["overlap_pct"] is not None
            assert extra["fleet_pipeline_overlap_pct"] == mesh_cell["overlap_pct"]
        assert extra["fleet_pipeline_speedup"] == grid_lane["speedup_vs_sync_single"]
        assert extra["fleet_fused_speedup"] == grid_lane["fused_speedup_vs_sync_single"]
        assert "chip_state_probe" in grid_lane
    mp_lane = extra["lanes"]["model_parallel_grid"]
    if "skipped" not in mp_lane:
        mp_grid = mp_lane["grid"]
        assert "1x1" in mp_grid and "8x1" in mp_grid
        assert "2x4" in mp_grid and "2x4_wide_transformer" in mp_grid
        for cell in mp_grid.values():
            if "error" in cell:
                continue
            assert cell["dropped_windows"] == 0
            assert cell["accounting_balanced"] is True
            assert cell["windows_per_sec_median"] > 0
        if "error" not in mp_grid["2x4"]:
            assert mp_grid["2x4"]["scorer"] == "ModelParallelScorer"
            assert mp_grid["2x4"]["model_axis_shards"] == 4
            assert (mp_grid["2x4"]["params_bytes_per_device"]
                    < mp_grid["2x4"]["params_bytes_total"])
        wide = mp_grid["2x4_wide_transformer"]
        if "error" not in wide:
            assert wide["single_device_equivalent"] is True
            assert wide["params_bytes_total"] > mp_lane["emulated_device_budget_bytes"]
            assert mp_lane["fits_one_device"] is False
            assert mp_lane["wide_served_within_budget"] is True
            assert extra["fits_one_device"] == mp_lane["fits_one_device"]
        assert extra["model_parallel_speedup"] == mp_lane["model_parallel_speedup"]
        assert mp_lane["baseline_cell"] == "8x1"
        assert "chip_state_probe" in mp_lane
    adaptive = extra["lanes"]["adaptive_serving"]
    if "skipped" not in adaptive:
        assert adaptive["n_runs"] >= 3
        assert adaptive["windows_per_sec_median"] > 0
        assert adaptive["dropped_windows"] == 0
        assert adaptive["swap_contract_ok"] is True
        assert set(adaptive["scored_by_version"]) == {"v1", "v2"}
        assert "chip_state_probe" in adaptive
        assert extra["adaptive_event_p99_ms"] == adaptive["event_p99_ms_median"]
    recovery = extra["lanes"]["fleet_recovery"]
    if "skipped" not in recovery:
        assert recovery["n_runs"] >= 3
        assert recovery["contract_ok"] is True
        assert recovery["recovery_ms_median"] > 0
        assert recovery["rows"]
        for row in recovery["rows"]:
            assert row["recovery_ms_median"] > 0
            assert "recovery_ms_std" in row
        assert "chip_state_probe" in recovery
        assert extra["fleet_recovery_ms_median"] == recovery["recovery_ms_median"]
        assert extra["fleet_recovery_contract_ok"] is True
    failover = extra["lanes"]["cluster_failover"]
    if "skipped" not in failover:
        assert failover["n_runs"] >= 3
        assert failover["contract_ok"] is True
        assert failover["failover_ms_median"] > 0
        for row in failover["rows"]:
            assert row["workers"] == 3
            assert row["migrated_sessions"] > 0
            assert row["failover_ms_median"] > 0
        assert "chip_state_probe" in failover
        assert extra["cluster_failover_ms_median"] == failover["failover_ms_median"]
        assert extra["cluster_failover_contract_ok"] is True
    wire = extra["lanes"]["wire_failover"]
    if "skipped" not in wire:
        assert wire["transport"] == "tcp"
        assert wire["contract_ok"] is True
        assert wire["failover_ms_median"] > 0
        assert wire["rpc_rtt_p50_ms"] is not None
        for row in wire["rows"]:
            assert row["workers"] == 3
            assert row["migrated_sessions"] > 0
            assert row["contract_ok"] is True
        assert "chip_state_probe" in wire
        assert extra["wire_failover_ms_median"] == wire["failover_ms_median"]
        assert extra["wire_failover_contract_ok"] is True
    ship = extra["lanes"]["journal_ship"]
    if "skipped" not in ship:
        assert ship["transport"] == "tcp"
        assert ship["private_dirs"] is True
        assert ship["contract_ok"] is True
        assert ship["ship_ms_median"] > 0
        assert ship["failover_ms_median"] > 0
        assert ship["baseline_failover_ms_median"] > 0
        for row in ship["rows"]:
            assert row["workers"] == 3
            assert row["shipped_bytes"] > 0
            assert row["chunks"] >= 1
            assert row["contract_ok"] is True
            assert row["replicated_failover_path_bytes"] == 0
        assert "chip_state_probe" in ship
        assert extra["journal_ship_ms_median"] == ship["ship_ms_median"]
        assert extra["journal_ship_contract_ok"] is True
        assert ship["replicated_failover_ms_median"] > 0
        assert ship["replicated_failover_path_bytes"] == 0
        assert ship["replicated_steady_lag_records"] >= 0
        assert extra["replicated_failover_ms_median"] == ship["replicated_failover_ms_median"]
        assert extra["replicated_failover_path_bytes"] == 0
        assert (extra["replicated_steady_lag_records"]
                == ship["replicated_steady_lag_records"])
    ingest = extra["lanes"]["wire_ingest"]
    if "skipped" not in ingest:
        assert ingest["transport"] == "tcp"
        assert ingest["contract_ok"] is True
        assert ingest["windows_per_sec_median"] > 0
        assert ingest["inproc_windows_per_sec_median"] > 0
        assert ingest["event_p99_ms"] >= 0
        assert ingest["ack_coalesce_ratio"] <= 0.5
        for row in ingest["rows"]:
            assert row["frames"] > 0
            assert row["ack_bytes_per_window"] > 0
            assert row["ack_bytes_per_window"] < row["per_record_bytes_per_window"]
            assert row["contract_ok"] is True
        assert "chip_state_probe" in ingest
        assert extra["wire_ingest_ack_coalesce_ratio"] == ingest["ack_coalesce_ratio"]
        assert extra["wire_ingest_contract_ok"] is True
    ha = extra["lanes"]["gateway_ha"]
    if "skipped" not in ha:
        assert ha["transport"] == "tcp"
        assert ha["gateways"] == 2
        assert ha["contract_ok"] is True
        assert ha["failover_ms_median"] > 0
        assert ha["resumed_sessions"] >= 1
        for row in ha["rows"]:
            assert row["gateways"] == 2
            assert row["failover_ms_median"] > 0
            assert row["reconnects"] + row["moved_receipts"] >= 1
            assert row["resumed_sessions"] >= 1
            assert row["contract_ok"] is True
        assert "chip_state_probe" in ha
        assert extra["gateway_ha_failover_ms_median"] == ha["failover_ms_median"]
        assert extra["gateway_ha_resumed_sessions"] == ha["resumed_sessions"]
        assert extra["gateway_ha_contract_ok"] is True
    elastic = extra["lanes"]["elastic_traffic"]
    if "skipped" not in elastic:
        assert elastic["n_runs"] >= 3
        assert set(elastic["configs"]) == {"static_floor", "static_ceiling", "autoscaled"}
        for cfg in elastic["configs"].values():
            assert cfg["windows_per_sec_median"] > 0
            assert cfg["contract_ok"] is True
        assert elastic["configs"]["autoscaled"]["resizes"] >= 2
        assert elastic["swing"] >= 8.0
        assert elastic["beats_static"] is True
        assert elastic["contract_ok"] is True
        assert "chip_state_probe" in elastic
        assert (extra["elastic_p99_ms_median"]
                == elastic["configs"]["autoscaled"]["p99_ms_median"])
        assert extra["elastic_beats_static"] is True
        assert extra["elastic_contract_ok"] is True
    host_plane = extra["lanes"]["host_plane_scaling"]
    if "skipped" not in host_plane:
        assert host_plane["n_runs"] >= 2
        assert host_plane["contract_ok"] is True
        assert host_plane["rows"]
        for row in host_plane["rows"]:
            assert row["windows_per_sec_median"] > 0
            assert row["host_ms_per_poll_median"] > 0
            assert row["accounting_balanced"] is True
        assert extra["host_ms_per_poll"] == host_plane["host_ms_per_poll"]
        assert "host_sessions_ceiling" in extra
        assert extra["host_plane_contract_ok"] is True
    # parity keys exist even on the synthetic fallback (null, not absent)
    for key in ("lr_parity_test_accuracy", "rf_parity_test_accuracy",
                "lr_cv_mllib_objective_test_accuracy"):
        assert key in extra and extra[key] is None
    assert "dt_parity_test_accuracy" in extra
    assert "serving_latency_ms" in extra
    assert "north_star" in extra
    assert result["headline_tpu"]["metric"] == "raw_cnn_train_throughput"
    assert result["headline_tpu"]["target_windows_per_sec"] > 0
    assert ("skipped" in extra["wisdm_raw_parity"]
            or "accuracy" in extra["wisdm_raw_parity"])
    # the real-data lanes stay loud: a skip is announced on stderr too
    assert extra["ucihar_parity"].get("skipped")
    assert "ucihar_parity lane skipped" in captured.err
    assert "wisdm_raw_parity lane skipped" in captured.err
    # smoke draws are throwaway: no healthy-state cross-reference
    assert "healthy_state_reference" not in extra
    stored = json.loads((art / "bench_latest.json").read_text())
    assert stored["value"] == result["value"]
    assert not (art / "bench_healthy.json").exists()


def test_bench_without_cuda_fails_with_the_zero_line(monkeypatch, capsys):
    """Asked for the card (the default) where there is none, the bench
    prints the zero-value line with the error and exits 1; it never goes
    on on the CPU."""
    from har_tpu_torch import bench, cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bench.run([]), lambda: cli.main(["bench"])):
        assert call() == 1
        out = capsys.readouterr().out.strip().splitlines()[-1]
        line = json.loads(out)
        assert line["value"] == 0 and line["vs_baseline"] == 0
        assert line["metric"] == "wisdm_mlp_train_throughput"
        assert "torch.cuda.is_available() is False" in line["error"]


def test_make_deadline_skips_a_lane_past_the_budget(capsys):
    from har_tpu_torch.bench import make_deadline

    t0 = time.perf_counter()
    time_left, deadline_lane = make_deadline(100.0, t0=t0)
    assert 0 < time_left() <= 100.0
    assert deadline_lane("cheap", 1.0, lambda: ("ran", {"n": 1})) == ("ran", {"n": 1})
    model, stats = deadline_lane("dear", 1e6, lambda: pytest.fail("must not run"))
    assert model is None and stats["skipped"].startswith("deadline:")
    assert "skipping dear lane" in capsys.readouterr().err


def test_healthy_reference_refreshed_only_by_a_healthy_draw(tmp_path):
    from har_tpu_torch.bench import HEALTHY_CHIP_PCT, update_healthy_reference

    path = tmp_path / "bench_healthy.json"
    lanes = {"mlp": {"windows_per_sec_best": 5.0, "n_runs": 3}}
    healthy = {"metric": "m", "value": 5.0, "chip_pct_of_peak": HEALTHY_CHIP_PCT,
               "degraded_chip_state": False, "extra": {"lanes": lanes}}
    update_healthy_reference(healthy, path)
    assert json.loads(path.read_text())["value"] == 5.0
    ref = healthy["extra"]["healthy_state_reference"]
    assert ref["lanes"] == {"mlp": {"windows_per_sec_best": 5.0}}
    low = {"metric": "m", "value": 1.0, "chip_pct_of_peak": HEALTHY_CHIP_PCT / 10,
           "degraded_chip_state": True, "extra": {}}
    update_healthy_reference(low, path)
    assert json.loads(path.read_text())["value"] == 5.0  # not overwritten
    assert low["extra"]["healthy_state_reference"]["value"] == 5.0
    assert low["extra"]["chip_state_log"] is None


def test_bench_module_runs_as_a_script():
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "har_tpu_torch.bench", "--help"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0 and "--device" in out.stdout
