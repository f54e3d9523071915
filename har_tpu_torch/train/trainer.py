"""Single-device neural trainer.

Port of the single-device scanned path of ``har_tpu/train/trainer.py``
(``TrainerConfig``, ``make_optimizer``, ``batch_iterator``, the step of
``make_scan_fit``, ``NeuralModel``, ``Trainer.fit``):

- the batch schedule is the JAX package's: every epoch's shuffled indices
  come from ``numpy.random.default_rng(seed)``, the last partial batch
  wrapped round to full size, all staged before training;
- the training data, the schedule and the model live on the device; the
  loop over steps is a Python loop (the JAX package compiles it into one
  ``lax.scan``);
- each step minimizes the weighted cross-entropy sum over the weight sum
  (weights 1, or ``class_weight="balanced"``), and ``history["loss"]``
  holds the last step's loss of each epoch;
- the optimizer is optax's ``adamw`` over ``warmup_cosine_decay_schedule``,
  computed as optax computes it (:class:`AdamW`): the schedule is read at
  the count before the step, so the first step has learning rate 0;
- an ``augment`` policy (``data/augment.py``) transforms each batch inside
  the step, before the forward, with draws from its own generator, seeded
  apart from the dropout generator (the JAX package folds the step key
  once more for it).

Checkpointing, early stopping, the ``dp``/``tp``/``zero1`` meshes and
``compute_flops`` are not ported yet; asking for them raises
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from har_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    batch_size: int = 512
    epochs: int = 60
    learning_rate: float = 3e-3
    weight_decay: float = 1e-4
    warmup_fraction: float = 0.1
    seed: int = 0
    log_every: int = 0  # 0 → silent
    checkpoint_dir: str | None = None
    save_every_epochs: int = 0
    early_stop_patience: int = 0
    validation_fraction: float = 0.1
    # None → every row weighs 1; "balanced" reweighs the loss by
    # n / (num_classes * count(class)) so minority classes pull equally
    class_weight: str | None = None
    compute_flops: bool = False


def _refuse_unported(cfg: TrainerConfig) -> None:
    unported = {
        "checkpoint_dir": cfg.checkpoint_dir is not None,
        "save_every_epochs": cfg.save_every_epochs != 0,
        "early_stop_patience": cfg.early_stop_patience != 0,
        "compute_flops": cfg.compute_flops,
    }
    asked = [name for name, on in unported.items() if on]
    if asked:
        raise NotImplementedError(
            f"trainer option(s) {asked} are not ported to har_tpu_torch yet: "
            "ROADMAP.md Queue 1 item 9 (neural training: checkpoints, early "
            "stopping, the FLOP count)"
        )


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
):
    """optax's ``warmup_cosine_decay_schedule`` in float32: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    to ``end_value`` over the remaining ``decay_steps - warmup_steps``."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(max(count, 0)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, cosine_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(cosine_steps)))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


class AdamW:
    """``optax.adamw(schedule, weight_decay=...)`` (b1 0.9, b2 0.999, eps
    1e-8) with optax's arithmetic: per step, with ``c`` the number of
    earlier steps,

        mu ← (1−b1)·g + b1·mu;   nu ← (1−b2)·g² + b2·nu
        u  ← (mu / (1−b1^(c+1))) / (√(nu / (1−b2^(c+1))) + eps) + wd·p
        p  ← p − schedule(c)·u

    Gradients are divided by ``grad_scale`` first (the step's weight sum).
    """

    def __init__(self, params, schedule, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = [p for p in params]
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, grad_scale: torch.Tensor | float = 1.0) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        bc1 = float(1 - np.float32(b1) ** np.float32(self.count))
        bc2 = float(1 - np.float32(b2) ** np.float32(self.count))
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad / grad_scale
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            update = update + self.weight_decay * p
            p.add_(-lr * update)


def make_optimizer(cfg: TrainerConfig, params, total_steps: int) -> AdamW:
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=cfg.learning_rate,
        warmup_steps=max(1, int(cfg.warmup_fraction * total_steps)),
        decay_steps=max(2, total_steps),
    )
    return AdamW(params, schedule, weight_decay=cfg.weight_decay)


def batch_iterator(
    n: int, batch_size: int, rng: np.random.Generator
) -> Iterator[np.ndarray]:
    """Shuffled fixed-size batch indices; the last partial batch is padded
    by wrapping (the JAX package's static shapes, kept so the batch
    schedule is the same)."""
    perm = rng.permutation(n)
    n_batches = max(1, -(-n // batch_size))
    padded = np.resize(perm, n_batches * batch_size)
    for i in range(n_batches):
        yield padded[i * batch_size : (i + 1) * batch_size]


@dataclasses.dataclass
class NeuralModel:
    """Trained model implementing the ClassifierModel protocol."""

    module: nn.Module
    num_classes: int
    history: dict | None = None

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @torch.no_grad()
    def predict_logits(self, x: np.ndarray, batch_size: int = 8192) -> np.ndarray:
        """Logits in chunks of ``batch_size`` rows; a last chunk shorter
        than the first is zero-padded to full size and sliced back."""
        self.module.eval()
        outs = []
        for start in range(0, len(x), batch_size):
            chunk = x[start : start + batch_size]
            pad = 0
            if len(chunk) < batch_size and start > 0:
                pad = batch_size - len(chunk)
                chunk = np.pad(chunk, [(0, pad)] + [(0, 0)] * (chunk.ndim - 1))
            logits = self.module(torch.from_numpy(chunk).to(self.device))
            logits = logits.cpu().numpy()
            outs.append(logits[: len(logits) - pad if pad else None])
        return np.concatenate(outs, axis=0)

    def transform(self, data):
        from har_tpu_torch.models.base import Predictions

        x = data.features if hasattr(data, "features") else data
        logits = self.predict_logits(np.ascontiguousarray(x, np.float32))
        probs = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
        return Predictions.from_raw(logits, probs)


# the augmentation generator's seed is the trainer seed plus this
_AUGMENT_SEED_OFFSET = 0x9E3779B9


class Trainer:
    """Fits a module on (x, y) arrays on one device; ``augment(generator,
    xb) -> xb`` transforms each training batch inside the step."""

    def __init__(self, module: nn.Module, config: TrainerConfig | None = None,
                 device: str | torch.device = "cuda",
                 augment: Callable | None = None):
        self.module = module
        self.config = config or TrainerConfig()
        self.device = resolve_device(device)
        self.augment = augment

    def fit(
        self,
        x: np.ndarray,
        y: np.ndarray,
        num_classes: int | None = None,
        init_params: dict | None = None,
    ) -> NeuralModel:
        """Train from the module's initial values for ``config.seed`` or,
        given ``init_params`` (a state_dict of the same shapes), from
        those."""
        cfg = self.config
        _refuse_unported(cfg)
        if cfg.class_weight not in (None, "balanced"):
            raise ValueError(
                f"class_weight={cfg.class_weight!r}; use None or 'balanced'"
            )
        device = self.device
        n = len(x)
        num_classes = num_classes or int(y.max()) + 1
        x = np.ascontiguousarray(x, np.float32)
        y = np.asarray(y, np.int32)
        steps_per_epoch = max(1, -(-n // cfg.batch_size))
        total_steps = steps_per_epoch * cfg.epochs

        module = self.module
        module.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        if init_params is not None:
            own = module.state_dict()
            if {k: tuple(v.shape) for k, v in own.items()} != {
                k: tuple(np.shape(v)) for k, v in init_params.items()
            }:
                raise ValueError("init_params do not match the module's parameter shapes")
            module.load_state_dict(
                {k: torch.as_tensor(np.asarray(v)) for k, v in init_params.items()}
            )
        module.to(device)
        optimizer = make_optimizer(cfg, module.parameters(), total_steps)

        weights = None
        if cfg.class_weight == "balanced":
            counts = np.bincount(y, minlength=num_classes).astype(np.float32)
            weights = torch.from_numpy(
                n / (num_classes * np.maximum(counts, 1.0))
            ).to(device)

        host_rng = np.random.default_rng(cfg.seed)
        batch_idx = np.stack(
            [
                idx
                for _ in range(cfg.epochs)
                for idx in batch_iterator(n, cfg.batch_size, host_rng)
            ]
        )
        x_dev = torch.from_numpy(x).to(device)
        y_dev = torch.from_numpy(y).long().to(device)
        idx_dev = torch.from_numpy(batch_idx).to(device)
        dropout_rng = torch.Generator(device=device).manual_seed(cfg.seed)
        augment_rng = torch.Generator(device=device).manual_seed(
            cfg.seed + _AUGMENT_SEED_OFFSET
        )

        epoch_losses = []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        module.train()
        for step in range(total_steps):
            idx = idx_dev[step]
            xb, yb = x_dev[idx], y_dev[idx]
            if self.augment is not None:
                xb = self.augment(augment_rng, xb)
            wb = (
                weights[yb] if weights is not None
                else torch.ones(yb.shape, device=device)
            )
            logits = module(xb, train=True, generator=dropout_rng)
            loss_sum = (F.cross_entropy(logits, yb, reduction="none") * wb).sum()
            count = wb.sum()
            optimizer.zero_grad()
            loss_sum.backward()
            optimizer.step(grad_scale=count)
            if (step + 1) % steps_per_epoch == 0:
                epoch_losses.append((loss_sum / count).detach())
        module.eval()
        history: dict[str, Any] = {
            "loss": torch.stack(epoch_losses).tolist() if epoch_losses else []
        }
        history["train_time_s"] = time.perf_counter() - t0
        history["windows_per_sec"] = (
            total_steps * cfg.batch_size / history["train_time_s"]
        )
        return NeuralModel(module=module, num_classes=num_classes, history=history)
