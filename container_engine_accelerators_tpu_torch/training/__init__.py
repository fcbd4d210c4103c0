"""Training on one device: the step, the loop, AdamW and the data."""

from container_engine_accelerators_tpu_torch.training.train import (
    TrainState,
    fit,
    loss_fn,
    make_optimizer,
    make_train_step,
    train_loop,
)

__all__ = [
    "TrainState",
    "fit",
    "loss_fn",
    "make_optimizer",
    "make_train_step",
    "train_loop",
]
