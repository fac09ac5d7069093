"""Schedules of the port (host-side, float32)."""
from .schedules import constant, decay_weight, paper_mnist_schedule, step_decay

__all__ = ["constant", "step_decay", "paper_mnist_schedule", "decay_weight"]
