"""Inner optimizers and LR schedules of the port (host-side schedules,
optimizers over trees of tensors)."""
from .optimizers import adam, apply_updates, clip_by_global_norm, global_norm, momentum, sgd
from .schedules import (
    constant, cosine, decay_weight, paper_cifar_schedule, paper_mnist_schedule, step_decay,
    warmup_cosine,
)

__all__ = [
    "sgd", "momentum", "adam", "apply_updates", "global_norm", "clip_by_global_norm",
    "constant", "step_decay", "cosine", "warmup_cosine",
    "paper_mnist_schedule", "paper_cifar_schedule", "decay_weight",
]
