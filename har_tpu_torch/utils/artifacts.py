"""One place that knows where measurement artifacts live.

The repo's perf evidence (hist_bench.json, cv_scaling.json,
long_context_bench.json, …) is written by scripts/ and read by bench.py
and library auto-policies; every reader resolving the path its own way
is how lookups drift apart.

Copied from ``har_tpu/utils/artifacts.py``.  The files under
``artifacts/`` were measured for the JAX package on a TPU: nothing in
the port reads one of them as a policy.
"""

from __future__ import annotations

import json
import os

ARTIFACTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    ))),
    "artifacts",
)


def artifact_path(name: str) -> str:
    return os.path.join(ARTIFACTS_DIR, name)


def load_artifact(name: str) -> dict | None:
    """Parsed artifact JSON, or None when absent/unreadable/corrupt."""
    try:
        with open(artifact_path(name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
