"""Training on one device or across the ranks of a mesh: the step, the
loop, checkpoints, AdamW and the data."""

from container_engine_accelerators_tpu_torch.training.train import (
    TrainState,
    evaluate,
    fit,
    loss_fn,
    make_optimizer,
    make_train_step,
    train_loop,
)

__all__ = [
    "TrainState",
    "evaluate",
    "fit",
    "loss_fn",
    "make_optimizer",
    "make_train_step",
    "train_loop",
]
