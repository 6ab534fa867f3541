"""Training on one device (counterpart of ``ppgs_tpu.train``)."""

from .core import (
    checkpoint_state,
    evaluate_partition,
    latest_checkpoint,
    load_checkpoint,
    loss,
    make_optimizer,
    make_train_step,
    train,
)
