"""Training: step functions, the trainer loop, classifier heads."""

from repro_torch.train.train_step import make_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig", "make_train_state", "make_train_step"]
