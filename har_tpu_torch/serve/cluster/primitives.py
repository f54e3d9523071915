"""DrJAX-style MapReduce primitives over cluster workers.

DrJAX (arXiv 2403.07128, PAPERS.md) expresses federated/parallel-
across-clients computation as three building blocks — ``broadcast`` a
value to every client, ``map_fn`` a function over clients, ``reduce``
the per-client results — and lowers them onto JAX sharding so the same
program runs on one host or a mesh.  The cluster controller speaks the
same algebra over WORKERS: fleet-stats aggregation is a map+reduce,
drift-evidence collection is a map, config pushes are a broadcast.

This module is the host-side reference lowering (plain Python over the
in-process worker list — the control plane runs at heartbeat cadence,
thousands of times below the dispatch rate, so a device lowering would
be measurement noise here).  Keeping the controller's aggregation
BEHIND these three names is the point: a future multi-host transport
(or an actual DrJAX lowering for million-session fleets) replaces this
module, not the controller.

``reduce_sum`` is numpy-aware and dict-recursive so a list of
``FleetStats.accounting()`` dicts reduces key-wise in one call —
that is the cross-worker conservation law's summation.

Port of ``har_tpu/serve/cluster/primitives.py`` (numpy, copied).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def broadcast(value, workers: Sequence) -> list:
    """One value, every worker — the controller→worker config/model
    push shape.  Returns the per-worker list ``map_fn`` consumes."""
    return [value for _ in workers]


def map_fn(fn: Callable, workers: Sequence) -> list:
    """Apply ``fn`` to every worker, in membership order (the order is
    part of the contract: zip-able with the worker list)."""
    return [fn(w) for w in workers]


def reduce_sum(values: Sequence):
    """Key-wise / element-wise sum of per-worker results.

    Dicts reduce recursively over the UNION of keys (a worker that has
    never failed over simply contributes 0 to ``worker_failovers``);
    numbers and arrays sum directly; booleans AND (so reducing
    ``accounting()`` dicts keeps ``balanced`` honest: the global law
    holds only if every worker's does AND the sums agree — the caller
    re-derives the global balance from the summed fields)."""
    values = list(values)
    if not values:
        return 0
    head = values[0]
    if isinstance(head, dict):
        keys: list = []
        for v in values:
            for k in v:
                if k not in keys:
                    keys.append(k)
        return {
            k: reduce_sum([v[k] for v in values if k in v]) for k in keys
        }
    if isinstance(head, bool):
        return all(values)
    if isinstance(head, np.ndarray):
        return np.sum(np.stack(values), axis=0)
    return sum(values)


def reduce_mean(values: Sequence):
    """Mean over workers (scalar/array leaves only)."""
    values = list(values)
    if not values:
        return 0.0
    if isinstance(values[0], np.ndarray):
        return np.mean(np.stack(values), axis=0)
    return sum(values) / len(values)
