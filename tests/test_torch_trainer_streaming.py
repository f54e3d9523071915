"""The streamed trainer (``Trainer(scan=False)``): tests/test_trainer_streaming.py's
augmentation, early-stop and checkpoint-resume cases on the port, and
each streamed run against the staged run of the same config, bit for bit
(parameters, losses, validation accuracies).  The ``tp`` case waits for
the parallel layer (ROADMAP.md Queue 1 item 14).
"""

import numpy as np
import pytest
import torch

from har_tpu_torch.checkpoint import TrainCheckpointer
from har_tpu_torch.data.augment import build_augment
from har_tpu_torch.models.neural import build_model
from har_tpu_torch.models.transformer import Transformer1D
from har_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


def _toy(n=256, d=8, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.abs(x[:, 0] * 2 + x[:, 1]) * classes % classes).astype(np.int32)
    return x, y


def _windows(n=48, t=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, 3)).astype(np.float32)
    return x, rng.integers(0, 3, n).astype(np.int32)


def _trainer(scan, cfg=None, augment=None, module=None):
    module = module or build_model("mlp", 3, hidden=(16,), in_features=8)
    return Trainer(module, config=cfg or TrainerConfig(batch_size=64, epochs=3),
                   device="cpu", scan=scan, augment=augment)


def _assert_same_model(a, b):
    assert a.history["loss"] == b.history["loss"]
    for (name, p), q in zip(a.module.state_dict().items(), b.module.state_dict().values()):
        assert torch.equal(p, q), name


def test_streaming_augment_runs():
    x, y = _toy()

    def augment(generator, xb):
        return xb + 0.01 * torch.randn(xb.shape, generator=generator)

    cfg = TrainerConfig(batch_size=64, epochs=2)
    model = _trainer(scan=False, cfg=cfg, augment=augment).fit(x, y, num_classes=3)
    assert len(model.history["loss"]) == 2
    _assert_same_model(model, _trainer(scan=True, cfg=cfg, augment=augment).fit(
        x, y, num_classes=3))


def test_streaming_early_stop_returns_best():
    x, y = _toy()
    cfg = TrainerConfig(batch_size=64, epochs=20, early_stop_patience=2,
                        validation_fraction=0.25)
    model = _trainer(scan=False, cfg=cfg).fit(x, y, num_classes=3)
    h = model.history
    assert "val_accuracy" in h and "best_epoch" in h
    assert h["stopped_epoch"] <= 20
    assert len(h["val_accuracy"]) == h["stopped_epoch"]
    staged = _trainer(scan=True, cfg=cfg).fit(x, y, num_classes=3)
    assert staged.history["val_accuracy"] == h["val_accuracy"]
    assert staged.history["best_epoch"] == h["best_epoch"]
    _assert_same_model(model, staged)


def test_streaming_checkpoint_resume(tmp_path):
    x, y = _toy()
    cfg = TrainerConfig(batch_size=64, epochs=4, checkpoint_dir=str(tmp_path),
                        save_every_epochs=2, seed=3)
    m1 = _trainer(scan=False, cfg=cfg).fit(x, y, num_classes=3)
    # resume: a fresh fit finds the completed snapshot and (having no
    # epochs left) serves it without retraining
    m2 = _trainer(scan=False, cfg=cfg).fit(x, y, num_classes=3)
    assert m2.history.get("resumed_from_epoch") == 4
    for a, b in zip(m1.module.state_dict().values(), m2.module.state_dict().values()):
        assert torch.equal(a, b)


def test_streaming_resume_mid_run_replays_the_host_schedule(tmp_path, monkeypatch):
    """Crash a streamed 6-epoch run after its first 2-epoch snapshot and
    resume it streamed: the host schedule is replayed to epoch 2, so the
    run equals the unbroken staged one bit for bit."""
    x, y = _toy(seed=2)
    cfg = dict(batch_size=64, epochs=6, learning_rate=1e-2, seed=7)
    straight = _trainer(scan=True, cfg=TrainerConfig(**cfg)).fit(x, y, num_classes=3)
    ck = TrainerConfig(**cfg, checkpoint_dir=str(tmp_path), save_every_epochs=2)
    orig = TrainCheckpointer.save

    def crashing_save(self, epoch, params, opt_state, extra=None):
        orig(self, epoch, params, opt_state, extra)
        raise RuntimeError("simulated crash")

    with monkeypatch.context() as m:
        m.setattr(TrainCheckpointer, "save", crashing_save)
        with pytest.raises(RuntimeError, match="simulated crash"):
            _trainer(scan=False, cfg=ck).fit(x, y, num_classes=3)
    resumed = _trainer(scan=False, cfg=ck).fit(x, y, num_classes=3)
    assert resumed.history["resumed_from_epoch"] == 2
    assert resumed.history["loss"] == straight.history["loss"][2:]
    for (name, a), b in zip(straight.module.state_dict().items(),
                            resumed.module.state_dict().values()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", ["mlp_balanced", "transformer_augment", "packed"])
def test_streamed_equals_staged_bit_for_bit(case):
    if case == "mlp_balanced":
        x, y = _toy(n=200)
        make = lambda: build_model("mlp", 3, hidden=(32, 16), in_features=8)  # noqa: E731
        cfg = TrainerConfig(batch_size=48, epochs=3, class_weight="balanced", seed=5)
        augment = None
    else:
        x, y = _windows(n=40)
        pack = 4 if case == "packed" else 1
        make = lambda: Transformer1D(num_classes=3, embed_dim=16, num_heads=2,  # noqa: E731
                                     num_layers=2, dropout_rate=0.2, patch_size=4,
                                     window_pack=pack)
        cfg = TrainerConfig(batch_size=16, epochs=2, seed=1)
        augment = build_augment("raw_windows") if case == "transformer_augment" else None
    staged = Trainer(make(), cfg, device="cpu", augment=augment).fit(x, y, 3)
    streamed = Trainer(make(), cfg, device="cpu", augment=augment, scan=False).fit(x, y, 3)
    _assert_same_model(staged, streamed)
