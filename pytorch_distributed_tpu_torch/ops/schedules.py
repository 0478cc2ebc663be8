"""Learning-rate schedules as pure functions of the step
(``pytorch_distributed_tpu/ops/schedules.py``).

optax calls the schedule with the update count BEFORE the update, so the
first step runs at ``schedule(0)`` (0 under warmup). The port's train step
calls the schedule itself with its own step counter and sets the optimizer
group's lr before each ``optimizer.step()``; ``LambdaLR``, which steps
after the update, would be one step off.
"""

from __future__ import annotations

import math
from typing import Callable


def step_lr(base_lr: float, steps_per_epoch: int, step_size_epochs: int = 30,
            gamma: float = 0.1) -> Callable[[int], float]:
    """``base_lr · gamma^floor(epoch / step_size_epochs)`` with ``epoch =
    step // steps_per_epoch``: torch's ``StepLR(step_size, gamma)`` stepped
    once per epoch, as a function of the step."""

    def schedule(step: int) -> float:
        epoch = int(step) // max(int(steps_per_epoch), 1)
        return base_lr * gamma ** (epoch // step_size_epochs)

    return schedule


def warmup_cosine(base_lr: float, total_steps: int, warmup_steps: int = 0,
                  final_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warmup from 0 to ``base_lr`` over ``warmup_steps``, then a
    cosine from ``base_lr`` to ``final_lr`` at ``total_steps``."""

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(float(warmup_steps), 1.0)
        progress = (step - warmup_steps) / max(float(total_steps - warmup_steps), 1.0)
        progress = min(max(progress, 0.0), 1.0)
        return final_lr + 0.5 * (base_lr - final_lr) * (1.0 + math.cos(math.pi * progress))

    return schedule
