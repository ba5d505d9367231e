"""Training substrate: optimizer, train step, data pipeline, checkpointing.

Port of `repro.train`."""
from .optimizer import AdamW, cosine_schedule
from .train_step import TrainState, init_state, make_train_step

__all__ = ["AdamW", "cosine_schedule", "TrainState", "make_train_step", "init_state"]
