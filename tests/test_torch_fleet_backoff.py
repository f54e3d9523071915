"""har_tpu_torch.utils.backoff — the shared retry-pacing policy (satellite of
the cluster control plane): cap, reset and determinism pinned, plus
the retry_call loop semantics both the dispatch retry path and the
cluster's heartbeat/hand-off retries ride."""

import pytest

from har_tpu_torch.utils.backoff import Backoff, BackoffPolicy, retry_call


def test_schedule_grows_exponentially_and_caps():
    b = Backoff(BackoffPolicy(base_ms=10, cap_ms=100, factor=2.0,
                              jitter=0.0))
    assert [b.next_ms() for _ in range(6)] == [10, 20, 40, 80, 100, 100]


def test_jitter_bounded_and_cap_is_a_promise():
    p = BackoffPolicy(base_ms=10, cap_ms=80, factor=2.0, jitter=0.5)
    b = Backoff(p, seed=7)
    prev_raw = 0.0
    for k in range(8):
        raw = min(p.cap_ms, p.base_ms * p.factor**k)
        d = b.next_ms()
        # within [raw, raw * (1 + jitter)], never above the cap
        assert raw <= d <= min(p.cap_ms, raw * 1.5) + 1e-9
        assert d <= p.cap_ms
        prev_raw = raw
    assert prev_raw == p.cap_ms


def test_determinism_same_seed_same_schedule():
    a = Backoff(seed=3)
    b = Backoff(seed=3)
    sa = [a.next_ms() for _ in range(5)]
    sb = [b.next_ms() for _ in range(5)]
    assert sa == sb
    # a different seed jitters differently (same envelope)
    c = Backoff(seed=4)
    assert [c.next_ms() for _ in range(5)] != sa


def test_reset_restarts_exponent_and_jitter_stream():
    b = Backoff(seed=11)
    first = [b.next_ms() for _ in range(4)]
    b.reset()
    assert b.attempt == 0
    assert [b.next_ms() for _ in range(4)] == first


def test_policy_validation():
    with pytest.raises(ValueError):
        BackoffPolicy(base_ms=0)
    with pytest.raises(ValueError):
        BackoffPolicy(base_ms=10, cap_ms=5)
    with pytest.raises(ValueError):
        BackoffPolicy(factor=0.5)
    with pytest.raises(ValueError):
        BackoffPolicy(jitter=1.5)


def test_retry_call_success_resets_shared_backoff():
    b = Backoff(BackoffPolicy(base_ms=10, cap_ms=100, jitter=0.0))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert retry_call(flaky, retries=5, backoff=b) == "ok"
    assert calls["n"] == 3
    # success reset the schedule: the next failure starts at base
    assert b.next_ms() == 10


def test_retry_call_exhaustion_reraises_last_error():
    b = Backoff()
    attempts = []

    def always_fails():
        raise RuntimeError(f"boom {len(attempts)}")

    with pytest.raises(RuntimeError, match="boom"):
        retry_call(
            always_fails,
            retries=2,
            backoff=b,
            on_retry=lambda a, e: attempts.append((a, str(e))),
        )
    # 1 initial + 2 retries; on_retry fired before each RE-attempt
    assert [a for a, _ in attempts] == [1, 2]


def test_retry_call_sleep_receives_backoff_delays():
    """The cluster side: with a sleep, the waits follow the schedule
    exactly (seconds = next_ms / 1e3); the dispatch hot path passes
    sleep=None and never blocks."""
    b = Backoff(BackoffPolicy(base_ms=10, cap_ms=100, factor=2.0,
                              jitter=0.0))
    slept = []
    state = {"n": 0}

    def fails_twice():
        state["n"] += 1
        if state["n"] <= 2:
            raise RuntimeError("x")
        return state["n"]

    out = retry_call(
        fails_twice, retries=3, backoff=b, sleep=slept.append
    )
    assert out == 3
    assert slept == [0.01, 0.02]


def test_retry_call_zero_retries_single_attempt():
    with pytest.raises(ValueError):
        retry_call(lambda: 1, retries=-1)
    calls = {"n": 0}

    def once():
        calls["n"] += 1
        raise RuntimeError("no budget")

    with pytest.raises(RuntimeError):
        retry_call(once, retries=0)
    assert calls["n"] == 1
