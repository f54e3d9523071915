"""Replicated controller: wall-clock lease election over shared disk.

The in-process control plane has ONE controller; if it dies
mid-migration, ``FleetCluster.takeover`` can finish the job — but
something has to RUN takeover, and without this module that something
is a test harness.  This module closes the loop: N ``ControllerReplica``
processes watch one lease file; exactly one holds the lease and drives
the cluster; when it stops renewing, a standby campaigns, fences the
old generation, and completes the takeover — the orphaned failover
finishes via the protocol alone.

The lease is a FILE on the cluster root (the same shared filesystem
the journals already require), written atomically
(``utils.durable.atomic_write``) and stamped with a WALL clock
(``time.time`` — monotonic clocks are not comparable across processes;
this is the transport layer's sanctioned wall-clock use):

    leader.json   {"leader": id, "gen": N, "expires": unix_seconds}
    election.lock O_CREAT|O_EXCL campaign mutex (stale-broken by age)

Election rules:

  1. the holder renews before ``expires``; a reader trusts an
     unexpired lease absolutely (standby);
  2. an expired (or absent) lease invites a campaign: take the lock,
     RE-READ the lease (the race loser sees the winner's fresh lease
     and stands down), write generation N+1 with your id, release;
  3. generations only grow — a deposed leader that wakes up sees a
     larger generation than its own and MUST resign (its renew is
     refused), so two processes never both believe they hold gen N+1;
  4. controller state is DERIVED, never trusted across generations:
     the winner rebuilds placement from actual worker ownership
     (``FleetCluster.takeover``), where a crashed hand-off's dual
     ownership resolves by the sessions' ``handoffs`` generation — the
     split-brain tie-break is per-session and journal-backed, not
     lease-math.

Clock skew bounds correctness the usual lease way: the lease must be
long relative to skew + write latency.  On loopback skew is zero;
multi-host deployments tune ``lease_s`` up.

Port of ``har_tpu/serve/net/election.py`` (copied): the lease and lock
files are the JAX package's byte for byte.
"""

from __future__ import annotations

import errno
import json
import os
import time

from har_tpu_torch.serve.cluster.controller import ClusterConfig
from har_tpu_torch.utils.durable import atomic_write

LEASE_FILE = "leader.json"
LOCK_FILE = "election.lock"
# a campaign lock older than this is a crashed campaigner, not a
# campaign in progress — broken by the next campaigner
STALE_LOCK_S = 10.0


class LeaderLease:
    """The lease file protocol: read / renew / campaign."""

    def __init__(self, root: str, *, lease_s: float = 1.0, wall=None):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.lease_s = float(lease_s)
        # injectable for tests; the default is the real wall clock —
        # cross-process comparability is the point
        self._wall = wall or time.time
        self._path = os.path.join(self.root, LEASE_FILE)
        self._lock = os.path.join(self.root, LOCK_FILE)

    def read(self) -> dict | None:
        try:
            with open(self._path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def holder(self) -> str | None:
        """The current leader id, None if the lease is expired/absent."""
        lease = self.read()
        if lease is None or self._wall() >= lease.get("expires", 0.0):
            return None
        return lease.get("leader")

    def renew(self, leader_id: str, generation: int) -> bool:
        """Extend the lease — refused (False) when the file no longer
        names this (leader, generation): a deposed leader MUST resign
        on a refused renew, never overwrite the successor."""
        lease = self.read()
        if lease is not None and (
            lease.get("gen", 0) > generation
            or (
                lease.get("gen", 0) == generation
                and lease.get("leader") != leader_id
            )
        ):
            return False
        atomic_write(
            self._path,
            json.dumps(
                {
                    "leader": leader_id,
                    "gen": int(generation),
                    "expires": self._wall() + self.lease_s,
                }
            ),
        )
        return True

    def release(self, leader_id: str, generation: int) -> bool:
        """Give the lease up EARLY — a draining holder expires its own
        lease (``expires = now``) instead of letting standbys wait out
        the full term, so a planned hand-off flips as fast as a crash
        detection, minus the detection.  Refused (False) under the same
        fencing as ``renew``: only the current (leader, generation) may
        release, a deposed holder's late release must not clip the
        successor's lease."""
        lease = self.read()
        if lease is not None and (
            lease.get("gen", 0) > generation
            or (
                lease.get("gen", 0) == generation
                and lease.get("leader") != leader_id
            )
        ):
            return False
        atomic_write(
            self._path,
            json.dumps(
                {
                    "leader": leader_id,
                    "gen": int(generation),
                    "expires": self._wall(),
                }
            ),
        )
        return True

    def campaign(self, leader_id: str) -> int | None:
        """Try to take an expired lease: lock, re-read, write gen+1.
        Returns the won generation, or None (lease alive, or another
        campaigner holds the lock)."""
        lease = self.read()
        if lease is not None and self._wall() < lease.get("expires", 0.0):
            return None  # alive: stand by
        if not self._acquire_lock():
            return None
        try:
            # re-read under the lock: the race loser sees the winner's
            # fresh lease and stands down
            lease = self.read()
            if lease is not None and self._wall() < lease.get(
                "expires", 0.0
            ):
                return None
            gen = int(lease.get("gen", 0)) + 1 if lease else 1
            atomic_write(
                self._path,
                json.dumps(
                    {
                        "leader": leader_id,
                        "gen": gen,
                        "expires": self._wall() + self.lease_s,
                    }
                ),
            )
            return gen
        finally:
            self._release_lock()

    def _acquire_lock(self) -> bool:
        try:
            fd = os.open(self._lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except OSError as exc:
            if exc.errno != errno.EEXIST:
                return False
            # stale-lock breaking: a campaigner that died with the lock
            # must not wedge elections forever
            try:
                age = self._wall() - os.path.getmtime(self._lock)
            except OSError:
                return False
            if age < STALE_LOCK_S:
                return False
            try:
                os.unlink(self._lock)
                fd = os.open(
                    self._lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY
                )
            except OSError:
                return False
        # identity check closes the stale-breaking TOCTOU: a peer that
        # read the OLD lock's age may unlink the lock WE just created
        # and mint its own — if the path no longer names our inode,
        # we did not win (only the holder whose fd and path agree did)
        try:
            st_fd = os.fstat(fd)
        finally:
            os.close(fd)
        try:
            st_path = os.stat(self._lock)
        except OSError:
            return False
        return (st_path.st_ino, st_path.st_dev) == (
            st_fd.st_ino, st_fd.st_dev,
        )

    def _release_lock(self) -> None:
        try:
            os.unlink(self._lock)
        except OSError:
            pass


class ControllerReplica:
    """One controller replica: ``step()`` it periodically (its process
    main loop) and it renews or campaigns as the lease dictates.

    On winning a campaign the replica connects to the worker addresses
    (``(worker_id, host, port, journal_dir)`` tuples), takes over the
    responsive ones and completes any orphaned failover —
    ``NetCluster.takeover`` is the inherited, idempotent machinery.
    Events the takeover drains accumulate on ``self.events`` for the
    replica's consumer.
    """

    def __init__(
        self,
        replica_id: str,
        model,
        root: str,
        worker_addrs,
        *,
        config: ClusterConfig | None = None,
        loader=None,
        lease_s: float = 1.0,
        deadline_s: float = 2.0,
        wall=None,
    ):
        self.replica_id = str(replica_id)
        self.model = model
        self.root = os.path.abspath(os.path.expanduser(root))
        self.worker_addrs = list(worker_addrs)
        self.config = config
        self.loader = loader
        self.deadline_s = float(deadline_s)
        self.lease = LeaderLease(root, lease_s=lease_s, wall=wall)
        self.generation = 0
        self.cluster = None
        self.events: list = []
        self.takeovers = 0
        # True between winning a campaign and a COMPLETED takeover: a
        # takeover that raises (a slow worker timing out mid-attach)
        # must not strand the held lease — the holder renews and
        # retries instead of standing by against its own lease
        self._holds_mandate = False

    @property
    def is_leader(self) -> bool:
        return self.cluster is not None

    def step(self, *, poll: bool = True) -> str:
        """One duty cycle: leader -> renew (+ poll the cluster);
        mandate-holder whose takeover failed -> renew and retry it;
        standby -> campaign if the lease ran out.  Returns the role
        after the step ("leader" / "campaigning" / "standby")."""
        if self.cluster is not None:
            if not self.lease.renew(self.replica_id, self.generation):
                # deposed: a larger generation exists — resign, never
                # issue another RPC under a stale mandate
                self.resign()
                return "standby"
            if poll:
                self.events.extend(self.cluster.poll(force=True))
            return "leader"
        if self._holds_mandate:
            if not self.lease.renew(self.replica_id, self.generation):
                self._holds_mandate = False
                return "standby"
            return self._try_take_over()
        gen = self.lease.campaign(self.replica_id)
        if gen is None:
            return "standby"
        self.generation = gen
        self._holds_mandate = True
        return self._try_take_over()

    def _try_take_over(self) -> str:
        """Attempt the takeover under the held mandate; a transient
        failure (slow worker, I/O) keeps the mandate and retries next
        step — the lease stays renewed, so no leadership gap opens."""
        try:
            self._take_over()
        except Exception:
            return "campaigning"
        return "leader"

    def _take_over(self) -> None:
        from har_tpu_torch.serve.net.client import NetWorker
        from har_tpu_torch.serve.net.controller import NetCluster

        from har_tpu_torch.serve.cluster.membership import (
            WorkerTimeout,
            WorkerUnavailable,
        )

        workers = []
        for wid, host, port, jdir in self.worker_addrs:
            w = NetWorker(
                wid, host, port, jdir, deadline_s=self.deadline_s
            )
            try:
                w.heartbeat()
            except WorkerTimeout:
                # SLOW, not dead — the no-strike rule applies to
                # takeover too: include the worker, never restore a
                # live worker's journal out from under it.  If it
                # stays unresponsive the takeover's own calls raise
                # and this replica simply retries next step().
                workers.append(w)
                continue
            except WorkerUnavailable:
                w.close()
                continue  # refused: dead — its journal dir is an
                #            orphan the takeover restores and migrates
            workers.append(w)
        self.cluster = NetCluster.takeover(
            self.model,
            self.root,
            workers,
            config=self.config,
            loader=self.loader,
        )
        self.takeovers += 1
        # the takeover's recovered-orphan drains deliver on the first
        # poll; collect them with this step
        self.events.extend(self.cluster.poll(force=True))

    def resign(self) -> None:
        """Stand down: drop the cluster attachment (sockets closed,
        worker processes untouched) and the mandate."""
        self._holds_mandate = False
        if self.cluster is not None:
            # fence only this controller's clients — never the workers
            for w in self.cluster._workers.values():
                w.close()
            self.cluster = None

    def close(self) -> None:
        self.resign()
