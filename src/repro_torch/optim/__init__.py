"""Optimizers and schedules (hand-rolled, as in the JAX package): the step
counter and the learning rate live on the host."""

from repro_torch.optim import adamw, schedule, sgd

__all__ = ["adamw", "schedule", "sgd"]
