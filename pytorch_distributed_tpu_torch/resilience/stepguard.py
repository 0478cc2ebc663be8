"""Step guard: skip a non-finite update
(``pytorch_distributed_tpu/resilience/stepguard.py``, ``finite_ok``:42
and ``guard_state``:53).

A non-finite loss or gradient keeps the pre-step parameters and optimizer
moments, while the trainer's step counter still advances (a skip is a
consumed batch, as with torch's GradScaler). The JAX step selects old or
new state inside the compiled program; here the optimizer step is skipped
outright, which needs the verdict on the host: one device read per step,
and only when the guard is on. The host-side streak counter and rollback
(``StepGuard``) come with the checkpoint slice.
"""

from __future__ import annotations

from typing import Iterable

import torch


def finite_ok(loss: torch.Tensor, grads: Iterable[torch.Tensor] = ()) -> torch.Tensor:
    """0-dim bool tensor on the loss's device: the loss and every float
    gradient are finite."""
    good = torch.isfinite(loss).all()
    for g in grads:
        if g.is_floating_point():
            good = good & torch.isfinite(g).all()
    return good


def guarded_step(good: torch.Tensor, optimizer: torch.optim.Optimizer) -> bool:
    """``optimizer.step()`` when ``good``; otherwise nothing changes, the
    moments and the optimizer's own step count included (the JAX guard
    restores both). Returns the verdict."""
    ok = bool(good)
    if ok:
        optimizer.step()
    return ok
