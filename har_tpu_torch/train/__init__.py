"""Neural training of the port."""

from har_tpu_torch.train.trainer import (
    NeuralModel,
    Trainer,
    TrainerConfig,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "NeuralModel",
    "Trainer",
    "TrainerConfig",
    "make_optimizer",
    "make_train_step",
]
