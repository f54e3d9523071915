"""The elastic run's loss verdict: which drops the engine declares.

Port of the engine-side part of ``har_tpu/serve/traffic/smoke.py``.
``DECLARED_SHEDS`` and ``undeclared_drops`` are copied (the CLI's
``serve --trace`` summary reads them).  The JAX package's
``elastic_smoke`` also scales a cluster's workers, which waits for
ROADMAP.md Queue 1 item 15, and its ``elastic_traffic_benchmark`` is a
bench lane (item 16): both raise NotImplementedError here.
"""

from __future__ import annotations

# shed reasons the SLO ladder / bounded queues DECLARE: a drop under
# one of these is the engine degrading as designed.  Anything else
# (dispatch_failed, session_removed) is a lost window the elastic run
# must not produce.
DECLARED_SHEDS = ("slo_shed", "backpressure", "session_queue")


def undeclared_drops(stats_snapshot: dict) -> int:
    by_reason = stats_snapshot["dropped_by_reason"]
    return sum(
        n for reason, n in by_reason.items()
        if reason not in DECLARED_SHEDS
    )


def elastic_smoke(seed: int = 0) -> dict:
    """The JAX package's elastic-traffic gate: its engine phase walks a
    mesh rung and its second phase scales a fleet cluster's workers."""
    raise NotImplementedError(
        "elastic_smoke scales a fleet cluster's workers, which is not "
        "ported yet: ROADMAP.md Queue 1 item 15"
    )


def elastic_traffic_benchmark(
    n_runs: int = 3, smoke: bool = False, seed: int = 0
) -> dict:
    """The JAX package's ``elastic_traffic`` bench lane."""
    raise NotImplementedError(
        "the elastic_traffic bench lane is not ported yet: ROADMAP.md "
        "Queue 1 item 16"
    )
