"""The port's release gate (har_tpu_torch.release_gate).

Its order and refusals with the steps stubbed in-process, its smoke
runner on real subprocesses of tiny helper modules, its log against the
JAX gate's committed log (``artifacts/test_gate.json``), the real lint
step, and the promise that a gate run touches neither ``artifacts/`` nor
README.  No wall clock is asserted here: the lint budget is the gate's
own check.
"""

import hashlib
import json
from pathlib import Path

import pytest
import torch

import har_tpu_torch.release_gate as gate

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
JAX_LOG = REPO / "artifacts" / "test_gate.json"
_LINT_OK = {"ok": True, "rules_run": [f"HL00{i}" for i in range(1, 9)], "findings": 0,
            "per_rule": {}, "suppressed": 0, "lint_ms": 1.0, "budget_ms": 8000}

_HELPERS = '''
def ok(device=None):
    return {"ok": True, "device": device}

def boom(device=None):
    raise RuntimeError("smoke crashed")

def scalar(device=None):
    return 3

def noisy(device=None):
    print("not json")
    return {"ok": True}
'''


@pytest.fixture
def helpers(tmp_path, monkeypatch):
    """A module of tiny smokes the gate's subprocesses can import."""
    (tmp_path / "gate_helpers.py").write_text(_HELPERS)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    return "gate_helpers"


def _all(module, func):
    return tuple((key, module, func, takes) for key, _, _, takes in gate.SMOKES)


def test_red_lint_refuses_before_the_suite(monkeypatch, tmp_path):
    def never(*a, **k):
        raise AssertionError("ran after a red lint")

    monkeypatch.setattr(gate, "_harlint", lambda: {"ok": False, "findings": 1})
    monkeypatch.setattr(gate, "_suite", never)
    monkeypatch.setattr(gate, "_run_smoke", never)
    log = tmp_path / "gate.json"
    assert gate.main(["--device", "cpu", "--log", str(log)]) == 1
    assert not log.exists()


def test_missing_jax_is_red_without_skip_suite(monkeypatch, tmp_path):
    real = gate.importlib.util.find_spec
    monkeypatch.setattr(gate.importlib.util, "find_spec",
                        lambda name, *a: None if name == "jax" else real(name, *a))
    out = gate._suite()
    assert out["ok"] is False and "jax is not installed" in out["error"]
    monkeypatch.setattr(gate, "_harlint", lambda: dict(_LINT_OK))
    monkeypatch.setattr(gate, "_run_smoke", lambda *a, **k: pytest.fail("smoke ran"))
    assert gate.main(["--device", "cpu", "--log", str(tmp_path / "g.json")]) == 1


@pytest.mark.parametrize("func,error", [
    ("boom", "crashed"), ("scalar", "not a verdict"), ("noisy", None),
])
def test_smoke_runner_verdicts(helpers, func, error):
    """A crash or a non-dict is RED; the verdict is the last stdout line,
    so a smoke's own prints ahead of it do not matter."""
    out = gate._run_smoke(helpers, func, {"device": "cpu"})
    if error is None:
        assert out["ok"] is True and "seconds" in out
    else:
        assert out["ok"] is False and error in out["error"]


def test_crashing_smoke_refuses_the_run(helpers, monkeypatch, tmp_path):
    smokes = list(_all(helpers, "ok"))
    smokes[3] = (smokes[3][0], helpers, "boom", False)
    monkeypatch.setattr(gate, "SMOKES", tuple(smokes))
    monkeypatch.setattr(gate, "_harlint", lambda: dict(_LINT_OK))
    log = tmp_path / "gate.json"
    assert gate.main(["--skip-suite", "--device", "cpu", "--log", str(log)]) == 1
    assert not log.exists()


def test_skip_suite_is_recorded_and_the_log_has_the_jax_gate_keys(
        helpers, monkeypatch, tmp_path):
    monkeypatch.setattr(gate, "SMOKES", _all(helpers, "ok"))
    monkeypatch.setattr(gate, "_harlint", lambda: dict(_LINT_OK))
    log = tmp_path / "sub" / "gate.json"
    assert gate.main(["--skip-suite", "--device", "cpu", "--log", str(log)]) == 0
    out = json.loads(log.read_text())
    assert out["suite"]["skipped"] is True
    assert "--skip-suite" in out["suite"]["reason"] and "jax" in out["suite"]["reason"]
    assert out["smoke_count"] is None and out["total_count"] is None
    jax_log = json.loads(JAX_LOG.read_text())
    assert set(jax_log) <= set(out)
    assert set(out) - set(jax_log) == {"device", "duration_s"}
    assert set(jax_log["suite"]) <= set(out["suite"])
    # the device reaches exactly the smokes that take one
    for key, _, _, takes_device in gate.SMOKES:
        assert out[key]["device"] == ("cpu" if takes_device else None), key


def test_smoke_table_is_the_jax_gates():
    """The same verdicts, in the JAX gate's order (its committed log)."""
    jax_keys = [k for k, v in json.loads(JAX_LOG.read_text()).items()
                if isinstance(v, dict) and k not in ("suite", "harlint")]
    assert [key for key, *_ in gate.SMOKES] == jax_keys


@pytest.mark.parametrize("key", ["fleet_slo", "model_parallel", "fleet_pipeline",
                                 "host_plane"])
def test_real_smoke_verdict_has_the_jax_keys(key):
    """A real port smoke, run as the gate runs it, carries every key of
    the JAX gate's verdict (the wire and elastic smokes start worker
    processes and run in the gate itself)."""
    _, module, func, takes_device = next(s for s in gate.SMOKES if s[0] == key)
    out = gate._run_smoke(module, func, {"device": "cpu"} if takes_device else {})
    assert out["ok"] is True, out
    assert set(json.loads(JAX_LOG.read_text())[key]) <= set(out)
    if key == "model_parallel":
        assert out["mesh_shape"] == out["mesh"] == "2x4" and out["cards"] == 1


def test_mesh_laid_over_the_visible_cards(monkeypatch):
    assert gate._cards(8, "cpu") == [torch.device("cpu")] * 8
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert [str(d) for d in gate._cards(4, "cuda")] == ["cuda:0", "cuda:1", "cuda:0",
                                                        "cuda:1"]


def _tree_digest(root: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file():
            h.update(p.relative_to(root).as_posix().encode() + p.read_bytes())
    return h.hexdigest()


def test_gate_run_leaves_artifacts_and_readme_alone(helpers, monkeypatch, tmp_path):
    """The real lint step (its stamp and budget fields) and a gate run:
    ``artifacts/`` and README byte for byte as they were, only the log
    written."""
    before = (_tree_digest(REPO / "artifacts"), (REPO / "README.md").read_bytes())
    lint = gate._harlint()
    assert lint["ok"] is True, lint
    assert lint["budget_ms"] == gate.LINT_BUDGET_MS == 8000
    for k in ("rules_run", "findings", "per_rule", "suppressed", "lint_ms"):
        assert k in lint
    assert "findings_list" not in lint
    monkeypatch.setattr(gate, "SMOKES", _all(helpers, "ok"))
    monkeypatch.setattr(gate, "_harlint", lambda: lint)
    log = tmp_path / "gate.json"
    assert gate.main(["--skip-suite", "--device", "cpu", "--log", str(log)]) == 0
    assert json.loads(log.read_text())["harlint"]["findings"] == 0
    assert (_tree_digest(REPO / "artifacts"), (REPO / "README.md").read_bytes()) == before
    assert gate.DEFAULT_LOG.is_relative_to(REPO / "har_tpu_torch" / "_build")
