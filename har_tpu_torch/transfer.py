"""Transfer learning: fine-tune a saved checkpoint on new data.

Port of ``har_tpu/transfer.py``.  ``fine_tune``:

  - warm-starts the trainer from the checkpoint's parameters (the module's
    fresh initial values are the shape template, so an architecture
    mismatch fails loudly);
  - keeps the checkpoint's own scaler: refitting statistics on a small
    adaptation set would shift the input under the pretrained features;
  - optionally freezes parameter subtrees, named as flax names them
    (``freeze=("ConvBlock_0",)``; ``convert.flax_module_prefixes`` maps
    each to the port's parameters).  Frozen parameters are left out of
    the optimizer, so they get exactly zero update: no gradient step, no
    Adam moments, no decoupled weight decay, as the JAX package's two
    ``optax.masked`` wrappers give.

Everything else is the ordinary ``train.Trainer``: the schedule, the
checkpoint slot (keyed by the warm start's values and the freeze set) and
the device.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from har_tpu_torch.convert import flax_module_prefixes
from har_tpu_torch.models.neural import MODEL_REGISTRY


def model_family(module) -> str:
    """The registry name of a neural module's family."""
    for name, cls in MODEL_REGISTRY.items():
        if isinstance(module, cls):
            return name
    raise TypeError(f"{type(module).__name__} is not a neural model of the registry")


def freeze_mask(module, freeze: tuple[str, ...]) -> dict[str, bool]:
    """Per-parameter trainability (``named_parameters`` names): False
    under any flax top-level module named in ``freeze``, True elsewhere."""
    table = flax_module_prefixes(model_family(module), module)
    unknown = set(freeze) - set(table)
    if unknown:
        raise ValueError(
            f"freeze names {sorted(unknown)} not in params "
            f"(top-level modules: {sorted(table)})"
        )
    frozen = tuple(p for name in freeze for p in table[name])
    return {
        name: not any(name == p or name.startswith(p + ".") for p in frozen)
        for name, _ in module.named_parameters()
    }


def fine_tune(
    checkpoint_path: str,
    data,
    config=None,
    *,
    freeze: tuple[str, ...] = (),
    model=None,
    device: str | torch.device = "cuda",
):
    """Fine-tuned ``NeuralClassifierModel`` from a saved checkpoint.

    ``data`` is a FeatureSet (or an (x, y) pair) of new examples in the
    checkpoint's input space; ``config`` the adaptation run's
    TrainerConfig (default: 20 epochs at lr 3e-4).  ``model``, where the
    caller already loaded the checkpoint, is left as it was.
    """
    from har_tpu_torch.checkpoint import load_model
    from har_tpu_torch.models.neural_classifier import NeuralClassifierModel
    from har_tpu_torch.train.trainer import Trainer, TrainerConfig, make_optimizer

    if model is None:
        model = load_model(checkpoint_path, device)
    if config is None:
        config = TrainerConfig(epochs=20, learning_rate=3e-4)

    x = np.asarray(
        data.features if hasattr(data, "features") else data[0], np.float32
    )
    y = np.asarray(data.label if hasattr(data, "label") else data[1], np.int32)
    if len(y) and (y.max() >= model.num_classes or y.min() < 0):
        # an out-of-range label would train toward a class the head lacks
        raise ValueError(
            f"adaptation labels span [{y.min()}, {y.max()}] but the "
            f"checkpoint has {model.num_classes} classes"
        )
    if model.scaler is not None:
        x = model.scaler.transform(x)

    module = copy.deepcopy(model.inner.module)
    optimizer_factory = None
    if freeze:
        mask = freeze_mask(module, tuple(freeze))

        def optimizer_factory(cfg, module, total_steps):
            trainable = [p for name, p in module.named_parameters() if mask[name]]
            return make_optimizer(cfg, trainable, total_steps)

        # runs with other freeze sets must not resume each other's snapshots
        optimizer_factory.fingerprint_tag = f"freeze:{sorted(freeze)}"

    trained = Trainer(
        module, config, device=device, optimizer_factory=optimizer_factory,
    ).fit(
        x, y,
        num_classes=model.num_classes,
        init_params={k: v.cpu() for k, v in model.inner.module.state_dict().items()},
    )
    return NeuralClassifierModel(
        inner=trained, scaler=model.scaler, num_classes=model.num_classes
    )
