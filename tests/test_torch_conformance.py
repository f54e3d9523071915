"""The JAX package's framework-free tests, run against the port.

Each file named in ``FILES`` imports neither jax nor flax: it drives
``har_tpu`` through its public surface alone.  The harness writes each
into ``tmp_path/tests`` with ``har_tpu`` renamed to ``har_tpu_torch``,
beside the JAX package's ``tests/conftest.py`` (renamed likewise) and a
shim that resolves the port's default device ``cuda`` to the CPU, and
runs them with pytest in a subprocess (``-m 'not slow'``, as tier 1 runs
them).  Every case must pass, or skip where the original skips (those
ids are run again on ``har_tpu`` and must skip there too), or be in
``DIVERGENCES``: the cases where the port differs on purpose, each with
the port's own test that holds the difference.

Left out of ``FILES``, though they import no jax: ``test_bench_e2e.py``
(the root ``bench.py``; the port's bench has
``tests/test_torch_bench.py``), ``test_chip_probe.py`` and
``test_release_gate.py`` (``scripts/`` and the JAX gate's artifacts),
``test_native_loader.py`` (``data.native_loader``, not ported),
``test_notebook.py`` (the JAX notebook; the port's has
``test_torch_notebook.py``) and the wire files ``test_net.py``,
``test_ship.py``, ``test_gateway_ha.py`` (their ported copies are
``test_torch_{net,ship,gateway}.py``, which start their children at low
priority).

Slow: the subprocess runs 34 files.  Run it with
``python -m pytest tests/test_torch_conformance.py -m slow -q``.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent

FILES = (
    # the library, the models and the reports
    "test_backoff.py",
    "test_breeze_optimize.py",
    "test_calibration.py",
    "test_data.py",
    "test_durable.py",
    "test_ensemble.py",
    "test_export.py",
    "test_features.py",
    "test_gbdt.py",
    "test_golden_report.py",
    "test_mllib_lr.py",
    "test_mllib_rf.py",
    "test_model_store.py",
    "test_monitoring.py",
    "test_quantize.py",
    "test_raw_loader.py",
    "test_raw_models.py",
    "test_report.py",
    "test_reporting.py",
    "test_spark_split.py",
    "test_sweep.py",
    "test_tuning.py",
    "test_ucihar.py",
    "test_wisdm_raw_lane.py",
    # the fleet
    "test_serving.py",
    "test_adapt.py",
    "test_host_plane.py",
    "test_pending_soa.py",
    "test_ingest.py",
    "test_traffic.py",
    "test_cluster.py",
    "test_recovery.py",
    "test_tail.py",
    "test_bench_healthy.py",
)

# test id -> why the port differs, and the port's test that holds it
DIVERGENCES = {
    "test_reporting.py::test_run_with_partial_device_mesh":
        "a training mesh is one process a rank (torch.distributed), not a "
        "sub-mesh of one process's devices; the port's mesh runs are "
        "tests/test_torch_parallel.py",
    "test_quantize.py::test_quantized_export_shrinks_artifact":
        "the port's artifact is predict.pt2 (torch.export) with the int8 "
        "weights inside it, not predict.stablehlo + weights.npz; "
        "tests/test_torch_quantize.py holds its size",
    "test_quantize.py::test_cli_export_quantized":
        "expects weights.npz beside the program; the port writes "
        "predict.pt2 (tests/test_torch_quantize.py)",
    "test_quantize.py::test_quantize_serving_wraps_any_jitted_model":
        "checks _split_predict(q)[1] is q.inner; the port's dispatch "
        "unwraps a model to a DeviceProgram (serve/dispatch.py, "
        "tests/test_torch_fleet_dispatch.py)",
    "test_cluster.py::test_cli_serve_workers_kill_worker":
        "starts `python -m har_tpu_torch.cli serve` in a subprocess the "
        "device shim does not reach: the port's CLI asks for cuda unless "
        "--device cpu is given (tests/test_torch_cluster.py runs it so)",
    "test_recovery.py::test_cli_serve_journal_kill_and_resume":
        "a `serve` subprocess without --device cpu asks for cuda "
        "(tests/test_torch_fleet_cli.py runs it with --device cpu)",
    "test_data.py::TestNativeFallback::test_broken_native_loader_warns_and_falls_back":
        "patches data.native_loader, the JAX package's C++ CSV parser, "
        "which the port leaves out: it parses the 5,418-row CSV in Python "
        "(tests/test_torch_api.py names the exclusion)",
    "test_bench_healthy.py::test_repo_seed_artifact_is_consistent":
        "reads the JAX package's own artifacts/bench_healthy.json beside "
        "the test file, which the copy in tmp_path does not have; the "
        "port writes no seed artifact",
}

_SHIM = '''

# The port's entry points default to cuda; this run is on the CPU.
import torch as _torch
import har_tpu_torch.device as _device

_resolve = _device.resolve_device


def _resolve_cpu(name="cuda"):
    if _torch.device(name).type == "cuda":
        return _torch.device("cpu")
    return _resolve(name)


_device.resolve_device = _resolve_cpu
'''

_INI = """[pytest]
markers =
    slow: long-running tests
"""


def _renamed(text: str) -> str:
    return re.sub(r"\bhar_tpu\b", "har_tpu_torch", text)


def _junit(path: Path) -> dict[str, str]:
    """test id (file::[Class::]name[params]) -> passed / failed / skipped."""
    out = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        # classname "tests.<module>[.<Class>]"
        _, module, *classes = case.get("classname", "").split(".")
        test_id = "::".join([f"{module}.py", *classes, case.get("name")])
        if case.find("skipped") is not None:
            out[test_id] = "skipped"
        elif case.find("failure") is not None or case.find("error") is not None:
            out[test_id] = "failed"
        else:
            out[test_id] = "passed"
    return out


def _pytest(args: list[str], cwd: Path, xml: Path, timeout: int) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-m", "not slow", f"--junitxml={xml}", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout,
    )


def test_divergences_name_listed_files():
    for test_id in DIVERGENCES:
        name = test_id.split("::")[0]
        assert name in FILES, test_id
        assert f"def {test_id.split('::')[-1]}(" in (TESTS / name).read_text()


def test_files_are_framework_free():
    for name in FILES:
        text = (TESTS / name).read_text()
        assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|orbax)\b", text, re.M), name


@pytest.mark.slow
def test_jax_package_tests_run_on_the_port(tmp_path):
    tests = tmp_path / "tests"
    tests.mkdir()
    (tmp_path / "pytest.ini").write_text(_INI)
    (tests / "conftest.py").write_text(_renamed((TESTS / "conftest.py").read_text()) + _SHIM)
    for name in FILES:
        (tests / name).write_text(_renamed((TESTS / name).read_text()))
    workers = ["-p", "xdist", "-n", "4", "--dist", "loadfile"]
    run = _pytest([*workers, "tests"], tmp_path, tmp_path / "port.xml", 2400)
    outcomes = _junit(tmp_path / "port.xml")
    summary = run.stdout.strip().splitlines()[-1:] if run.stdout.strip() else []
    print("port:", summary)

    assert {k.split("::")[0] for k in outcomes} >= set(FILES), run.stdout[-4000:]
    failed = sorted(k for k, v in outcomes.items() if v == "failed" and k not in DIVERGENCES)
    assert not failed, (failed, run.stdout[-6000:])
    # a divergence that now passes, or is gone, leaves the dict
    stale = sorted(k for k in DIVERGENCES if outcomes.get(k) != "failed")
    assert not stale, stale

    skipped = sorted(k for k, v in outcomes.items() if v == "skipped")
    if skipped:
        ref = _pytest([f"tests/{k}" for k in skipped], ROOT, tmp_path / "ref.xml", 1200)
        reference = _junit(tmp_path / "ref.xml")
        not_skipped = [k for k in skipped if reference.get(k) != "skipped"]
        assert not not_skipped, (not_skipped, ref.stdout[-4000:])
    counts = {s: sum(v == s for v in outcomes.values()) for s in ("passed", "skipped", "failed")}
    print("conformance:", counts, "divergent:", sorted(k for k in DIVERGENCES if k in outcomes))
