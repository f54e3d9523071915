"""The copy into the card: ``serve.dispatch.PinnedStaging``.

On a card, ``DeviceScorer._place`` and ``ShardedScorer._place`` copy the
host rows into a page-locked buffer and from there into the card with
``non_blocking=True``; a buffer is written again only after every copy
out of it has finished (a CUDA event recorded after each copy).  Here,
on the CPU:

  1. ``_place`` on a CPU device is what it was: the host array itself as
     a tensor (no copy), split by rows over the data shards;
  2. the pool's lifetime rule, through its own API, under the fleet's
     pipelined schedule at depths 1-3, bare and fused: fences that
     complete only when their ticket retires (the latest a copy can end)
     are injected, and no buffer is handed out while its fence is
     pending; the pool grows to the tickets in flight and the decisions
     equal the depth-1 run without the pool;
  3. ``put`` starts one copy a target and records one fence a device.
"""

import numpy as np
import pytest
import torch

from har_tpu_torch.parallel.mesh import create_serving_mesh
from har_tpu_torch.serve import (
    FakeClock,
    FleetConfig,
    FleetServer,
    JitDemoModel,
    drive_fleet,
    make_scorer,
    synthetic_sessions,
)
from har_tpu_torch.serve.dispatch import PinnedStaging

torch.set_num_threads(1)


def _mesh(dp, tp):
    return create_serving_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))


def test_place_on_the_cpu_is_the_host_array():
    """No staging on a CPU device: ``_place`` hands the forward the host
    array itself (the same memory, as the pageable ``.to(cpu)`` did), one
    block of rows a data shard."""
    x = np.random.default_rng(0).normal(size=(8, 200, 3)).astype(np.float32)
    single = make_scorer(JitDemoModel(device="cpu"))
    assert single._staging is None
    t = single._place(x)
    assert t.device.type == "cpu" and t.data_ptr() == x.ctypes.data
    np.testing.assert_array_equal(t.numpy(), x)
    sharded = make_scorer(JitDemoModel(device="cpu"), _mesh(2, 1))
    assert sharded._staging is None
    parts = sharded._place(x)
    assert [p.data_ptr() for p in parts] == [x[:4].ctypes.data, x[4:].ctypes.data]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    # a non-contiguous host batch is made contiguous first, as before
    t = single._place(x[::2])
    np.testing.assert_array_equal(t.numpy(), x[::2])


class _Fence:
    def __init__(self, device):
        self.device = device
        self.done = False

    def query(self):
        return self.done


def _run(depth, fused, staged, n=12):
    """The fleet over ``n`` sessions on a FakeClock; with ``staged``, the
    scorer's copies go through a PinnedStaging whose fences complete when
    their ticket retires (oldest first, as tickets retire).  Decisions by
    session, and what the pool saw."""
    model = JitDemoModel(device="cpu")
    recordings, _ = synthetic_sessions(n, windows_per_session=4, seed=5)
    server = FleetServer(
        model, window=200, hop=200, smoothing="none",
        config=FleetConfig(max_sessions=n, target_batch=4, pipeline_depth=depth,
                           fused=fused),
        clock=FakeClock(),
    )
    seen = dict(stale=0, acquired=0, max_in_flight=0)
    pool = None
    if staged:
        fences = []
        pool = PinnedStaging(pin=False, fence=lambda d: fences.append(_Fence(d)) or fences[-1])
        scorer = server.scorer
        scorer._staging = pool
        real_acquire = pool.acquire

        def acquire(shape):
            pending = {id(b) for b in pool.in_flight()}
            buf = real_acquire(shape)
            seen["acquired"] += 1
            seen["stale"] += id(buf) in pending
            return buf

        def retiring(fetch):
            def wrapped(handle, k):
                seen["max_in_flight"] = max(seen["max_in_flight"], len(pool.in_flight()))
                next(f for f in fences if not f.done).done = True
                return fetch(handle, k)
            return wrapped

        pool.acquire = acquire
        scorer.fetch = retiring(scorer.fetch)
        scorer.fetch_fused = retiring(scorer.fetch_fused)
    for i in range(n):
        server.add_session(i)
    events, _ = drive_fleet(server, recordings, seed=5)
    by_sid = {}
    for fe in events:
        ev = fe.event
        by_sid.setdefault(fe.session_id, []).append(
            (ev.t_index, ev.label, ev.raw_label, float(ev.probability[ev.label])))
    return server, by_sid, seen, pool


@pytest.mark.parametrize("fused", [False, True], ids=["bare", "fused"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_staging_pool_hands_out_no_buffer_in_flight(depth, fused):
    _, want, _, _ = _run(1, False, staged=False)
    server, got, seen, pool = _run(depth, fused, staged=True)
    assert seen["acquired"] == server.stats.dispatches > 0
    assert seen["stale"] == 0
    # one buffer a ticket in flight: the pool grows to the ring's depth
    # and no further, and reuses what retired
    assert seen["max_in_flight"] == depth
    assert pool.allocated <= depth * len(set(server.stats.batch_sizes))
    assert pool.allocated < seen["acquired"]
    if fused:
        assert server.stats_snapshot()["fused_dispatches"] == server.stats.dispatches
    assert got.keys() == want.keys()
    for sid in want:
        assert [e[:3] for e in got[sid]] == [e[:3] for e in want[sid]]
        np.testing.assert_allclose([e[3] for e in got[sid]], [e[3] for e in want[sid]],
                                   atol=1e-6)


def test_put_copies_each_target_and_fences_each_device():
    fences = []
    pool = PinnedStaging(pin=False, fence=lambda d: fences.append(_Fence(d)) or fences[-1])
    x = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    cpu = torch.device("cpu")
    parts = pool.put(x, [(slice(0, 2), cpu), (slice(2, 4), cpu)])
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    assert len(fences) == 1 and pool.allocated == 1 and len(pool.in_flight()) == 1
    # a second batch of the same shape while the first copy may still
    # read its buffer gets a buffer of its own
    pool.put(x + 1, [(slice(None), cpu)])
    assert pool.allocated == 2 and len(pool.in_flight()) == 2
    fences[0].done = True
    y = pool.put(x + 2, [(slice(None), cpu)])[0]
    assert pool.allocated == 2  # the first buffer, free again
    np.testing.assert_array_equal(y.numpy(), x + 2)
