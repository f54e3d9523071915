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

With ``checkpoint_dir`` the run snapshots every ``save_every_epochs``
epochs (``checkpoint.TrainCheckpointer``) into a slot keyed by
:func:`_run_fingerprint` and resumes from the newest snapshot: the
parameters, AdamW's moments and step count (so the schedule goes on at the
global step) and the states of the dropout and augmentation generators
(the JAX package folds per-step keys from global step numbers; here the
generators are streams, so their states are saved), while the staged batch
schedule is sliced at the resume epoch.  A resumed run equals the unbroken
one bit for bit on the CPU.  ``early_stop_patience`` carves
``validation_fraction`` of the rows out of training (the JAX package's
draw), scores them after every epoch, stops after ``patience`` epochs
without improvement and returns the best epoch's parameters.

The ``dp``/``tp``/``zero1`` meshes and ``compute_flops`` are not ported
yet; asking for them raises NotImplementedError naming the ROADMAP item
that ports them.
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
    if cfg.compute_flops:
        raise NotImplementedError(
            "trainer option(s) ['compute_flops'] are not ported to "
            "har_tpu_torch yet: ROADMAP.md Queue 1 item 9 (neural training: "
            "the FLOP count)"
        )


def _module_signature(module: nn.Module) -> str:
    """The module's configuration: every submodule's type and its plain
    attributes (widths, rates, dtypes, pooling), which torch's repr
    leaves out."""
    plain = (int, float, str, bool, tuple, torch.dtype, type(None))
    return repr([
        (name, type(m).__name__,
         sorted((k, repr(v)) for k, v in vars(m).items()
                if not k.startswith("_") and isinstance(v, plain)))
        for name, m in module.named_modules()
    ])


def _run_fingerprint(
    cfg: TrainerConfig, x: np.ndarray, y: np.ndarray, module, augment=None,
    warm_start_digest=None, optimizer_tag=None,
) -> str:
    """Stable id for (model, data, schedule): the checkpoint-slot key.

    Hashes what the JAX package's fingerprint hashes, with the port's own
    encoding: the module's configuration and its parameters' names,
    shapes and dtypes, the data's shapes and first 64 rows, every config
    field that shapes the step sequence or the schedule, the augmentation
    policy, the class weighting, the early-stop settings, the warm
    start's values and the optimizer's tag (a freeze set).  Two fits
    resume each other's snapshots only when they would run alike.
    """
    import hashlib

    h = hashlib.sha1()
    h.update(_module_signature(module).encode())
    h.update(repr([(k, tuple(v.shape), str(v.dtype))
                   for k, v in module.state_dict().items()]).encode())
    h.update(repr((x.shape, y.shape, str(x.dtype))).encode())
    h.update(np.ascontiguousarray(x[:64]).tobytes())
    h.update(np.ascontiguousarray(y[:64]).tobytes())
    h.update(repr((cfg.batch_size, cfg.epochs, cfg.learning_rate,
                   cfg.weight_decay, cfg.warmup_fraction, cfg.seed)).encode())
    if augment is not None:
        h.update(repr(augment).encode())
    if cfg.class_weight is not None:
        h.update(repr(cfg.class_weight).encode())
    if cfg.early_stop_patience:
        # the early-stop loop snapshots other state (the best-iterate
        # carry) on another schedule than the plain chunked run
        h.update(repr(("early_stop", cfg.early_stop_patience,
                       cfg.validation_fraction)).encode())
    if warm_start_digest is not None:
        h.update(b"warm_start")
        h.update(warm_start_digest.encode())
    if optimizer_tag is not None:
        h.update(b"optimizer")
        h.update(optimizer_tag.encode())
    return h.hexdigest()[:16]


def _early_stop_template() -> dict:
    """The early-stopping carry before the first epoch, and the schema of
    the ``extra`` an early-stop snapshot saves and restores: the best
    epoch's parameters (host copies; set by the first epoch, which always
    improves on -1), its accuracy and number, and the epochs since."""
    return {"best_params": None, "best_acc": -1.0, "best_epoch": 0, "bad": 0}


def _should_snapshot(cfg: TrainerConfig, stopped: bool, epoch: int) -> bool:
    """Snapshot at chunk boundaries AND on stop/final-epoch exit (a
    completed run that isn't snapshotted would retrain its tail on the
    next invocation)."""
    return (
        stopped
        or epoch == cfg.epochs
        or epoch % (cfg.save_every_epochs or 1) == 0
    )


def _host(state: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in state.items()}


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

    def state_dict(self) -> dict:
        """Host copies of the moments and the step count."""
        return {
            "mu": [m.detach().cpu().clone() for m in self.mu],
            "nu": [v.detach().cpu().clone() for v in self.nu],
            "count": self.count,
        }

    def load_state_dict(self, state: dict) -> None:
        for own, saved in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            own.copy_(saved)
        self.count = int(state["count"])

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
    xb) -> xb`` transforms each training batch inside the step;
    ``optimizer_factory(cfg, module, total_steps) -> AdamW`` replaces
    :func:`make_optimizer` (``transfer.fine_tune`` leaves frozen
    parameters out of it), its ``fingerprint_tag`` keying the run's
    checkpoint slot."""

    def __init__(self, module: nn.Module, config: TrainerConfig | None = None,
                 device: str | torch.device = "cuda",
                 augment: Callable | None = None,
                 optimizer_factory: Callable | None = None):
        self.module = module
        self.config = config or TrainerConfig()
        self.device = resolve_device(device)
        self.augment = augment
        self.optimizer_factory = optimizer_factory

    def _open_checkpointer(self, cfg, x, y, warm_start_digest):
        """One slot derivation for the chunked and the early-stop run."""
        import os

        from har_tpu_torch.checkpoint import TrainCheckpointer

        tag = None
        if self.optimizer_factory is not None:
            tag = getattr(self.optimizer_factory, "fingerprint_tag",
                          getattr(self.optimizer_factory, "__qualname__", "custom"))
        return TrainCheckpointer(os.path.join(
            cfg.checkpoint_dir,
            _run_fingerprint(cfg, x, y, self.module, augment=self.augment,
                             warm_start_digest=warm_start_digest,
                             optimizer_tag=tag),
        ))

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

        x_val = y_val = None
        if cfg.early_stop_patience < 0:
            raise ValueError(
                f"early_stop_patience must be >= 0 "
                f"(got {cfg.early_stop_patience})"
            )
        if cfg.early_stop_patience:
            if not 0.0 < cfg.validation_fraction < 1.0:
                raise ValueError(
                    "early stopping needs 0 < validation_fraction < 1 "
                    f"(got {cfg.validation_fraction})"
                )
            val_n = max(1, int(round(n * cfg.validation_fraction)))
            if val_n >= n:
                raise ValueError(
                    f"validation_fraction={cfg.validation_fraction} leaves "
                    f"no training rows (n={n})"
                )
            perm = np.random.default_rng(cfg.seed).permutation(n)
            val_rows, train_rows = perm[:val_n], perm[val_n:]
            x_val, y_val = x[val_rows], y[val_rows]
            x, y = x[train_rows], y[train_rows]
            n = len(x)
        if cfg.save_every_epochs < 0:
            raise ValueError("save_every_epochs must be >= 0")
        if cfg.save_every_epochs and not cfg.checkpoint_dir:
            raise ValueError(
                "save_every_epochs is set but checkpoint_dir is not — "
                "snapshots have nowhere to go"
            )
        steps_per_epoch = max(1, -(-n // cfg.batch_size))
        total_steps = steps_per_epoch * cfg.epochs

        module = self.module
        # initial values drawn on the host, whatever device the module
        # was left on (a refit, a fine-tune of a loaded model)
        module.cpu()
        module.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        warm_start_digest = None
        if init_params is not None:
            import hashlib

            own = module.state_dict()
            if {k: tuple(v.shape) for k, v in own.items()} != {
                k: tuple(np.shape(v)) for k, v in init_params.items()
            }:
                raise ValueError("init_params do not match the module's parameter shapes")
            init = {k: torch.as_tensor(np.asarray(v)) for k, v in init_params.items()}
            module.load_state_dict(init)
            # warm starts share shapes with from-scratch runs: the values
            # key their checkpoint slot apart
            digest = hashlib.sha1()
            for value in init.values():
                digest.update(np.ascontiguousarray(value.numpy()).tobytes())
            warm_start_digest = digest.hexdigest()
        module.to(device)
        if self.optimizer_factory is not None:
            optimizer = self.optimizer_factory(cfg, module, total_steps)
        else:
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
        generators = {
            "dropout": torch.Generator(device=device).manual_seed(cfg.seed),
            "augment": torch.Generator(device=device).manual_seed(
                cfg.seed + _AUGMENT_SEED_OFFSET
            ),
        }

        def train_epochs(lo: int, hi: int) -> list:
            """Epochs [lo, hi): the last step's loss of each."""
            module.train()
            losses = []
            for step in range(lo * steps_per_epoch, hi * steps_per_epoch):
                idx = idx_dev[step]
                xb, yb = x_dev[idx], y_dev[idx]
                if self.augment is not None:
                    xb = self.augment(generators["augment"], xb)
                wb = (
                    weights[yb] if weights is not None
                    else torch.ones(yb.shape, device=device)
                )
                logits = module(xb, train=True, generator=generators["dropout"])
                loss_sum = (F.cross_entropy(logits, yb, reduction="none") * wb).sum()
                count = wb.sum()
                optimizer.zero_grad()
                loss_sum.backward()
                optimizer.step(grad_scale=count)
                if (step + 1) % steps_per_epoch == 0:
                    losses.append((loss_sum / count).detach())
            module.eval()
            return losses

        def train_state() -> dict:
            """What a snapshot holds beside the parameters."""
            return dict(optimizer.state_dict(), generators={
                name: g.get_state() for name, g in generators.items()
            })

        def resume(params, opt_state) -> None:
            module.load_state_dict(params)
            optimizer.load_state_dict(opt_state)
            for name, g in generators.items():
                g.set_state(opt_state["generators"][name])

        history: dict[str, Any] = {}
        epoch_losses: list = []
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        start_epoch, epoch = 0, cfg.epochs
        if cfg.checkpoint_dir and not cfg.early_stop_patience:
            # run in chunks of save_every_epochs, snapshot after each and
            # resume from the newest snapshot
            ckptr = self._open_checkpointer(cfg, x, y, warm_start_digest)
            try:
                restored = ckptr.restore()
                if restored is not None:
                    start_epoch, params, opt_state = restored
                    start_epoch = min(start_epoch, cfg.epochs)
                    resume(params, opt_state)
                epoch = start_epoch
                while epoch < cfg.epochs:
                    chunk = min(cfg.save_every_epochs or 1, cfg.epochs - epoch)
                    epoch_losses += train_epochs(epoch, epoch + chunk)
                    epoch += chunk
                    ckptr.save(epoch, _host(module.state_dict()), train_state())
            finally:
                ckptr.close()
            history["resumed_from_epoch"] = start_epoch
        elif cfg.early_stop_patience:
            # one epoch at a time: score the held-out rows, keep the best
            # epoch's parameters, stop after `patience` epochs without
            # improvement; with a checkpoint_dir the carry is snapshotted
            # too and the search resumes mid-way
            x_val_dev = torch.from_numpy(x_val).to(device)
            carry = _early_stop_template()
            val_accs: list[float] = []
            epoch = 0
            stopped = False
            ckptr = None
            if cfg.checkpoint_dir:
                ckptr = self._open_checkpointer(cfg, x, y, warm_start_digest)
                restored = ckptr.restore(with_extra=True)
                if restored is not None:
                    epoch, params, opt_state, extra = restored
                    epoch = min(epoch, cfg.epochs)
                    resume(params, opt_state)
                    carry.update(extra)
                    history["resumed_from_epoch"] = epoch
                    # a run that exhausted its patience is complete: it
                    # serves the stored best iterate and trains nothing
                    stopped = carry["bad"] >= cfg.early_stop_patience
            try:
                while not stopped and epoch < cfg.epochs:
                    epoch_losses += train_epochs(epoch, epoch + 1)
                    with torch.no_grad():
                        pred = module(x_val_dev).argmax(-1).cpu().numpy()
                    acc = float((pred == y_val).mean())
                    val_accs.append(acc)
                    epoch += 1
                    if acc > carry["best_acc"]:
                        carry.update(best_acc=acc, best_epoch=epoch, bad=0,
                                     best_params=_host(module.state_dict()))
                    else:
                        carry["bad"] += 1
                        stopped = carry["bad"] >= cfg.early_stop_patience
                    if ckptr is not None and _should_snapshot(cfg, stopped, epoch):
                        ckptr.save(epoch, _host(module.state_dict()), train_state(),
                                   extra=carry)
            finally:
                if ckptr is not None:
                    ckptr.close()
            if carry["best_params"] is not None:
                module.load_state_dict(carry["best_params"])
            history["val_accuracy"] = val_accs
            history["best_epoch"] = carry["best_epoch"]
            history["stopped_epoch"] = epoch
            start_epoch = epoch - len(val_accs)
        else:
            epoch_losses = train_epochs(0, cfg.epochs)
        module.eval()
        history["loss"] = torch.stack(epoch_losses).tolist() if epoch_losses else []
        history["train_time_s"] = time.perf_counter() - t0
        steps_run = (epoch - start_epoch) * steps_per_epoch
        history["windows_per_sec"] = (
            steps_run * cfg.batch_size / history["train_time_s"]
        )
        return NeuralModel(module=module, num_classes=num_classes, history=history)
