"""Training state (``pytorch_distributed_tpu/train/state.py``): what a
step mutates. The JAX state is an immutable pytree a step replaces; here
the model and the optimizer are updated in place and the step returns the
same object. ``lr_schedule`` stands where optax keeps the schedule inside
the optimizer: the step calls it with ``step`` before each update."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    step: int = 0

    def param_count(self) -> int:
        return sum(p.numel() for p in self.model.parameters())
