"""har_tpu_torch.data.prefetch against tests/test_prefetch.py's contract,
and the streamed trainer against the staged one.

On the CPU the default transfer is a plain copy (the pinned ring needs
CUDA; ``chip_smoke.py``'s ``stream_main`` drives it on the card).  The
streamed trainer (``scan=False``) ends with the staged run's parameters
and losses bit for bit: the same rows, the same schedule, the same draws.
"""

import numpy as np
import pytest
import torch

from har_tpu.data.prefetch import prefetch_to_device as jax_prefetch
from har_tpu_torch.data import prefetch_to_device

torch.set_num_threads(1)


def test_prefetch_preserves_order_and_values():
    items = [np.full((4,), i, np.float32) for i in range(7)]
    out = list(prefetch_to_device(iter(items), size=3, device="cpu"))
    assert len(out) == 7
    for i, a in enumerate(out):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), items[i])


def test_prefetch_custom_transfer_and_short_iterators():
    calls = []

    def transfer(x):
        calls.append(x)
        return x * 2

    assert list(prefetch_to_device(iter([1, 2]), size=4, transfer=transfer)) == [2, 4]
    assert calls == [1, 2]
    assert list(prefetch_to_device(iter([]), size=2, device="cpu")) == []


def test_prefetch_size_validation():
    with pytest.raises(ValueError, match=">= 1"):
        list(prefetch_to_device(iter([1]), size=0, device="cpu"))


@pytest.mark.parametrize("size", [1, 2, 5])
def test_transfers_stay_size_ahead_as_in_har_tpu(size):
    """The transfer runs ``size`` items ahead of the consumer, call for
    call as har_tpu's prefetch does."""
    logs = {}
    for name, fn in (("port", prefetch_to_device), ("jax", jax_prefetch)):
        log = []
        for item in fn(iter(range(6)), size=size, transfer=lambda x, log=log: log.append(
                ("put", x)) or x):
            log.append(("take", item))
        logs[name] = log
    assert logs["port"] == logs["jax"]


def test_cpu_default_is_a_copy_and_keeps_tuples():
    a = np.arange(6, dtype=np.float32)
    b = np.arange(3, dtype=np.int64)
    (got_a, got_b), = list(prefetch_to_device(iter([(a, b)]), device="cpu"))
    a[:] = -1
    np.testing.assert_array_equal(got_a.numpy(), np.arange(6))
    np.testing.assert_array_equal(got_b.numpy(), np.arange(3))


def test_source_rows_are_gathered():
    x = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    y = torch.arange(10) * 10
    batches = [np.array([3, 1, 4]), np.array([1, 5, 9])]
    out = list(prefetch_to_device(iter(batches), size=2, device="cpu", source=(x, y)))
    for idx, (xb, yb) in zip(batches, out):
        assert torch.equal(xb, x[idx]) and torch.equal(yb, y[idx])
    (only,) = list(prefetch_to_device(iter(batches[:1]), device="cpu", source=x))
    assert torch.equal(only, x[batches[0]])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        list(prefetch_to_device(iter([np.zeros(2)])))


def test_streaming_trainer_matches_scanned():
    """The prefetched streamed path trains the staged path's model: equal
    parameters and losses, bit for bit (har_tpu holds its two paths
    within 1e-4)."""
    from har_tpu_torch.models.neural import build_model
    from har_tpu_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(0)
    x = rng.normal(size=(96, 8)).astype(np.float32)
    w = rng.normal(size=(8, 4))
    y = (x @ w).argmax(1).astype(np.int32)
    cfg = TrainerConfig(batch_size=32, epochs=4, learning_rate=1e-2, seed=3)
    mk = lambda: build_model("mlp", 4, hidden=(16,), dropout_rate=0.0, in_features=8)  # noqa: E731
    scanned = Trainer(mk(), cfg, device="cpu", scan=True).fit(x, y)
    streamed = Trainer(mk(), cfg, device="cpu", scan=False).fit(x, y)
    assert scanned.history["loss"] == streamed.history["loss"]
    for (name, a), b in zip(scanned.module.state_dict().items(),
                            streamed.module.state_dict().values()):
        assert torch.equal(a, b), name
