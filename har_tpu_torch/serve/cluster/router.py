"""Consistent-hash session router: which worker owns which session.

Partitioning the fleet by ``hash(session_id)`` alone would reshuffle
nearly every session whenever a worker joins or dies — a full-fleet
migration storm for a one-worker event.  The classic fix is a
consistent-hash ring with virtual nodes: each worker owns many small
arcs of the hash circle, a session maps to the first worker clockwise
of its own hash, and removing a worker reassigns ONLY that worker's
arcs (about 1/N of the sessions) to the survivors.

The hash is ``blake2b`` over the stringified key — deterministic across
processes and runs (no process-seeded ``hash()``, harlint HL004), so
every router replica computes the same ownership table from the same
membership.

The ring decides PLACEMENT (where a new session is admitted, where a
dead worker's sessions fail over to); the controller keeps the live
``session → worker`` map on top of it, because a migrated session stays
pinned to its adopter even if the ring would hash it elsewhere — see
``har_tpu_torch.serve.cluster.controller``.

Port of ``har_tpu/serve/cluster/router.py`` (stdlib, copied): the hash
and the ring are the JAX package's, so both packages place every
session on the same worker.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Hashable


def stable_hash(key: Hashable) -> int:
    """64-bit deterministic hash of a session/worker key (blake2b —
    stable across processes, unlike Python's seeded ``hash``)."""
    digest = hashlib.blake2b(
        repr(key).encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big")


class ConsistentHashRouter:
    """Virtual-node consistent-hash ring over worker ids."""

    def __init__(self, replicas: int = 64):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.replicas = int(replicas)
        self._points: list[int] = []  # sorted ring positions
        self._owners: list[str] = []  # worker id per ring position
        self._workers: list = []

    @property
    def workers(self) -> tuple:
        return tuple(self._workers)

    def add_worker(self, worker_id) -> None:
        if worker_id in self._workers:
            raise ValueError(f"worker {worker_id!r} already on the ring")
        for r in range(self.replicas):
            point = stable_hash((worker_id, r))
            i = bisect.bisect_left(self._points, point)
            self._points.insert(i, point)
            self._owners.insert(i, worker_id)
        self._workers.append(worker_id)

    def remove_worker(self, worker_id) -> None:
        if worker_id not in self._workers:
            raise ValueError(f"worker {worker_id!r} not on the ring")
        keep = [
            (p, w)
            for p, w in zip(self._points, self._owners)
            if w != worker_id
        ]
        self._points = [p for p, _ in keep]
        self._owners = [w for _, w in keep]
        self._workers.remove(worker_id)

    def owner(self, session_id: Hashable):
        """The worker whose arc covers this session's hash: first ring
        point clockwise (wrapping) of ``stable_hash(session_id)``."""
        if not self._points:
            raise ValueError("no workers on the ring")
        i = bisect.bisect_right(self._points, stable_hash(session_id))
        return self._owners[i % len(self._points)]

    def partition(self, session_ids) -> dict:
        """``{worker_id: [session_ids...]}`` for a batch of sessions —
        every live worker appears, even with an empty share."""
        out = {w: [] for w in self._workers}
        for sid in session_ids:
            out[self.owner(sid)].append(sid)
        return out
