"""Training of the port: state, optimizer, step factories, the trainer loop."""

from imm_tpu_torch.train.loop import Trainer, TrainerOptions
from imm_tpu_torch.train.state import TrainState, create_train_state, make_optimizer
from imm_tpu_torch.train.steps import (
    make_eval_coords_fn,
    make_synthetic_train_step,
    make_train_step,
)

__all__ = [
    "Trainer",
    "TrainerOptions",
    "TrainState",
    "create_train_state",
    "make_optimizer",
    "make_train_step",
    "make_synthetic_train_step",
    "make_eval_coords_fn",
]
