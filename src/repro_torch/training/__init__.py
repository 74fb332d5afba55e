"""Training substrate: AdamW, synthetic data, train step, checkpoints.

The port of the JAX package's ``training/``; checkpoints cross between the
two packages in both directions."""

from repro_torch.training import adamw, checkpoint, data
from repro_torch.training.train_loop import cross_entropy, make_loss_fn, make_train_step

__all__ = [
    "adamw", "checkpoint", "cross_entropy", "data",
    "make_loss_fn", "make_train_step",
]
