"""Training (PyTorch port of ``repro.train``): the microbatched train step
and the fault-tolerant loop."""
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["init_train_state", "make_train_step", "Trainer", "TrainerConfig"]
