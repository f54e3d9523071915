"""Release gate of the port: no tree ships red.

    python -m har_tpu_torch.release_gate                 # lint, suite, smokes on cuda
    python -m har_tpu_torch.release_gate --device cpu    # the same on the CPU
    python -m har_tpu_torch.release_gate --skip-suite    # a machine without jax
    python -m har_tpu_torch.release_gate --log gate.json

It follows ``scripts/release_gate.py`` step for step, over the port:

  1. **lint.**  ``python -m har_tpu_torch.cli lint --check --json`` in a
     fresh interpreter, under the JAX package's 8,000 ms budget
     (``LINT_BUDGET_MS``, fresh-interpreter wall clock, imports
     included).  ``{rules_run, findings, per_rule, suppressed,
     lint_ms}`` is stamped.  A finding or a slow lint refuses the run
     before anything else.
  2. **the suite.**  The port's tier, ``pytest tests/test_torch_*.py -m
     "not slow"``.  Those tests hold the port against ``har_tpu``, so
     they need jax: without it the suite is RED, never a quiet skip.
     ``--skip-suite`` skips the step in so many words (the card's
     machine has no jax) and the log records why.
  3. **the smokes.**  Each in a fresh interpreter: ``fleet_slo_smoke``,
     ``fleet_pipeline_smoke``, ``model_parallel_smoke``,
     ``adapt_smoke``, ``recovery_smoke``, ``cluster_failover_smoke``,
     ``elastic_smoke``, ``host_plane_smoke`` and the five wire smokes
     (``wire_failover``, ``journal_ship``, ``wire_ingest``,
     ``replication``, ``gateway_ha``).  The smokes that take a device
     run on ``--device`` (default ``cuda``); the others serve host
     models.  The mesh smokes lay their meshes over the visible cards
     in turn (a 2x4 mesh repeats ``cuda:0`` on a one-card machine), and
     the log stamps the shape and the cards used.  A crash, a timeout
     or output that cannot be parsed is RED, and the first red smoke
     refuses the run.
  4. **the log.**  The JAX gate's keys for each verdict, written to
     ``--log`` (default ``har_tpu_torch/_build/gate/test_gate.json``).

Intended divergences from the JAX gate: it never writes
``artifacts/test_gate.json`` and never rewrites README's count lines
(those are the JAX package's); ``smoke_count`` / ``total_count`` come
from the suite's own summary line, and are null with ``--skip-suite``.

This module imports no torch: the gate's own process stays light, and
each smoke pays for its own interpreter.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DEFAULT_LOG = REPO / "har_tpu_torch" / "_build" / "gate" / "test_gate.json"

# fresh-interpreter wall clock of the lint, import included: the JAX
# gate's budget, so a rule that doubles its cost trips the gate
LINT_BUDGET_MS = 8000
# one smoke's wall clock before it counts as hung (RED)
SMOKE_TIMEOUT_S = 900

# (log key, module, function, takes a device): the JAX gate's verdicts,
# in its order
SMOKES = (
    ("fleet_slo", "har_tpu_torch.serve.slo", "fleet_slo_smoke", False),
    ("fleet_pipeline", "har_tpu_torch.release_gate", "pipeline_on_cards",
     True),
    ("model_parallel", "har_tpu_torch.release_gate",
     "model_parallel_on_cards", True),
    ("adapt_smoke", "har_tpu_torch.adapt.smoke", "adapt_smoke", False),
    ("recovery_smoke", "har_tpu_torch.serve.recover", "recovery_smoke",
     False),
    ("cluster_failover", "har_tpu_torch.serve.cluster.smoke",
     "cluster_failover_smoke", False),
    ("elastic_smoke", "har_tpu_torch.serve.traffic.smoke", "elastic_smoke",
     True),
    ("host_plane", "har_tpu_torch.serve.slo", "host_plane_smoke", False),
    ("wire_failover", "har_tpu_torch.serve.net.smoke",
     "wire_failover_smoke", False),
    ("journal_ship", "har_tpu_torch.serve.net.smoke", "journal_ship_smoke",
     False),
    ("wire_ingest", "har_tpu_torch.serve.net.smoke", "wire_ingest_smoke",
     False),
    ("replication", "har_tpu_torch.serve.net.smoke", "replication_smoke",
     False),
    ("gateway_ha", "har_tpu_torch.serve.net.smoke", "gateway_ha_smoke",
     False),
)

SKIP_SUITE_REASON = (
    "--skip-suite: the port's tests hold it against har_tpu and need jax, "
    "which this machine does not run; the suite runs on the CPU"
)


def _cards(n: int, device: str) -> list:
    """``n`` devices over the visible cards in turn (``cuda:0`` repeated
    on a one-card machine), or the CPU repeated."""
    import torch

    if torch.device(device).type != "cuda":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def pipeline_on_cards(device: str) -> dict:
    """``fleet_pipeline_smoke`` on ``device``: depth 3, fused, batch-sharded
    over the distinct visible cards when there are several (one card
    otherwise), stamped with the device and the cards it used."""
    import torch

    from har_tpu_torch.serve import fleet_pipeline_smoke

    out = fleet_pipeline_smoke(device=device)
    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
    return dict(out, device=device, cards_visible=cards)


def model_parallel_on_cards(device: str, dp: int = 2, tp: int = 4) -> dict:
    """``model_parallel_smoke`` on a ``dp x tp`` mesh laid over the visible
    cards in turn, stamped with the mesh shape and the distinct cards."""
    from har_tpu_torch.parallel.mesh import create_serving_mesh
    from har_tpu_torch.serve import model_parallel_smoke

    devices = _cards(dp * tp, device)
    mesh = create_serving_mesh(dp=dp, tp=tp, devices=devices)
    out = model_parallel_smoke(device=device, mesh=mesh, dp=dp, tp=tp)
    return dict(out, device=device, mesh_shape=f"{dp}x{tp}",
                cards=len({str(d) for d in devices}))


def _run_smoke(module: str, func: str, kwargs: dict | None = None,
               timeout_s: float = SMOKE_TIMEOUT_S) -> dict:
    """``func(**kwargs)`` of ``module`` in a fresh interpreter; its last
    stdout line is the verdict.  A crash, a timeout or output that is
    not JSON is a red verdict, never a pass."""
    code = (
        f"import json; from {module} import {func}; "
        f"print(json.dumps({func}(**{dict(kwargs or {})!r})))"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH", "")) if p
    )
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True,
            text=True, env=env, timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        return {"ok": False, "error": f"{func} ran past {timeout_s} s",
                "seconds": round(time.perf_counter() - t0, 1)}
    seconds = round(time.perf_counter() - t0, 1)
    if proc.returncode != 0:
        return {"ok": False, "seconds": seconds,
                "error": f"{func} crashed (rc={proc.returncode}): "
                         f"{proc.stderr[-500:]}"}
    try:
        out = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"ok": False, "seconds": seconds,
                "error": f"unparseable {func} output: {proc.stdout[-500:]}"}
    if not isinstance(out, dict):
        return {"ok": False, "seconds": seconds,
                "error": f"{func} returned {type(out).__name__}, not a verdict"}
    return dict(out, seconds=seconds)


def _harlint() -> dict:
    """The lint verdict: the port's eight rules, zero findings outside
    its baseline, inside ``LINT_BUDGET_MS`` of fresh-interpreter wall
    clock (imports and parsing are real cost, so the subprocess's wall
    clock replaces the report's in-process ``lint_ms``)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "har_tpu_torch.cli", "lint", "--check",
         "--json"],
        cwd=REPO, capture_output=True, text=True,
    )
    lint_ms = round((time.perf_counter() - t0) * 1e3, 1)
    try:
        out = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"ok": False, "lint_ms": lint_ms,
                "error": f"unparseable lint output (rc={proc.returncode}): "
                         f"{(proc.stdout + proc.stderr)[-500:]}"}
    out.pop("findings_list", None)  # the log carries counts, not bodies
    out["lint_ms"] = lint_ms
    out["budget_ms"] = LINT_BUDGET_MS
    out["ok"] = (bool(out.get("ok")) and proc.returncode == 0
                 and lint_ms <= LINT_BUDGET_MS)
    if lint_ms > LINT_BUDGET_MS:
        out["error"] = (
            f"lint took {lint_ms:.0f} ms > {LINT_BUDGET_MS} ms budget "
            "(fresh interpreter); `lint --stats` names the slow rule"
        )
    return out


_SUMMARY_RE = re.compile(
    r"(\d+) (passed|failed|errors?|skipped|xfailed|xpassed|deselected)"
)


def _suite() -> dict:
    """The port's tier: ``pytest tests/test_torch_*.py -m "not slow"``.
    A machine without jax is RED here (the tests import ``har_tpu``);
    the counts come from pytest's own summary line."""
    if importlib.util.find_spec("jax") is None:
        return {"ok": False, "rc": None, "error": (
            "jax is not installed: the port's tests hold it against "
            "har_tpu; run the suite where jax is, or pass --skip-suite")}
    files = sorted(glob.glob(str(REPO / "tests" / "test_torch_*.py")))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", *files, "-q", "-m", "not slow",
         "-p", "no:cacheprovider"],
        cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    counts: dict[str, int] = {}
    lines = proc.stdout.strip().splitlines()
    for n, what in _SUMMARY_RE.findall(lines[-1] if lines else ""):
        counts["errors" if what.startswith("error") else what] = int(n)
    run = sum(v for k, v in counts.items() if k != "deselected")
    return {
        "ok": proc.returncode == 0,
        "rc": proc.returncode,
        "duration_s": round(time.perf_counter() - t0, 1),
        "files": len(files),
        "counts": counts,
        "smoke_count": run,
        "total_count": run + counts.get("deselected", 0),
        **({} if proc.returncode == 0
           else {"error": (proc.stdout + proc.stderr)[-500:]}),
    }


def _git_head() -> str:
    try:
        head = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=REPO, capture_output=True, text=True,
        ).stdout.strip()
    except OSError:
        head = ""
    return head or "unknown"


def _refuse(what: str, verdict: dict) -> int:
    print(f"\nrelease_gate: RED {what} ({json.dumps(verdict)[:600]}) — "
          "run refused", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the device-taking smokes run (default cuda)")
    ap.add_argument("--skip-suite", action="store_true",
                    help="skip the port's test tier (it needs jax); the "
                         "log records the skip and its reason")
    ap.add_argument("--log", default=str(DEFAULT_LOG),
                    help="where the gate log goes (default "
                         "har_tpu_torch/_build/gate/test_gate.json)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    # lint first: a structural fault refuses the run before the suite
    # spends minutes proving it another way
    harlint = _harlint()
    if not harlint.get("ok"):
        return _refuse("harlint", harlint)
    if args.skip_suite:
        suite = {"ok": True, "skipped": True, "reason": SKIP_SUITE_REASON,
                 "rc": None, "duration_s": 0.0}
    else:
        suite = _suite()
        if not suite.get("ok"):
            return _refuse("suite", suite)
    verdicts = {}
    for key, module, func, takes_device in SMOKES:
        kwargs = {"device": args.device} if takes_device else {}
        verdict = _run_smoke(module, func, kwargs)
        verdicts[key] = verdict
        print(f"release_gate: {key} ok={bool(verdict.get('ok'))} "
              f"{verdict.get('seconds')} s", file=sys.stderr)
        if not verdict.get("ok"):
            return _refuse(key, verdict)

    log = {
        "smoke_count": suite.get("smoke_count"),
        "total_count": suite.get("total_count"),
        "suite": suite,
        "harlint": harlint,
        **verdicts,
        "device": args.device,
        "duration_s": round(time.perf_counter() - t0, 1),
        "git_head": _git_head(),
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    path = Path(args.log)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(log, indent=1) + "\n")
    summary = {
        "ok": True,
        "device": args.device,
        "suite": "skipped" if args.skip_suite else suite["rc"],
        "harlint_ok": harlint["ok"],
        "lint_ms": harlint["lint_ms"],
        **{f"{key}_ok": v["ok"] for key, v in verdicts.items()},
        "duration_s": log["duration_s"],
        "log": str(path),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
