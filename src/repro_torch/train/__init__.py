"""Training substrate: the train step and checkpointing."""
from repro_torch.train.checkpoint import (
    install_preemption_handler,
    latest_step,
    preempted,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.step import (
    TrainState,
    init_train_state,
    loss_and_grads,
    make_serve_step,
    make_train_step,
)

__all__ = [
    "TrainState",
    "init_train_state",
    "install_preemption_handler",
    "latest_step",
    "loss_and_grads",
    "make_serve_step",
    "make_train_step",
    "preempted",
    "restore_checkpoint",
    "save_checkpoint",
]
