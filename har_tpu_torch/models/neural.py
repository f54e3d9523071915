"""The neural families by name: port of ``har_tpu/models/neural.py``'s
``MODEL_REGISTRY`` / ``build_model``.

Only the transformer is ported.  MLP, CNN1D and BiLSTM raise
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from torch import nn

from har_tpu_torch.models.transformer import Transformer1D

_NOT_PORTED = ("mlp", "cnn1d", "bilstm")

MODEL_REGISTRY = {"transformer": Transformer1D}


def build_model(name: str, num_classes: int, **kwargs) -> nn.Module:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported to har_tpu_torch yet: ROADMAP.md Queue 1 "
            "item 9 (neural training: MLP, CNN1D, BiLSTM)"
        )
    try:
        cls = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown neural model {name!r}; have {sorted(MODEL_REGISTRY)}"
        ) from None
    return cls(num_classes=num_classes, **kwargs)
