"""Step guard: skip a non-finite update, roll back after K in a row
(``pytorch_distributed_tpu/resilience/stepguard.py``: ``finite_ok``:42,
``guard_state``:53, ``RollbackRequested``:71, ``StepGuard``:83).

In the step (``finite_ok`` + ``guarded_step``): a non-finite loss or
gradient keeps the pre-step parameters and optimizer moments, while the
trainer's step counter still advances (a skip is a consumed batch, as
with torch's GradScaler). The JAX step selects old or new state inside
the compiled program; here the optimizer step is skipped outright, which
needs the verdict on the host: one device read per step, and only when
the guard is on. The step reports it as the ``step_good`` metric.

On the host (``StepGuard``): the trainer hands each step's ``step_good``
to ``observe``, which reads the one ``lag`` steps old, counts bad steps in
a row and raises ``RollbackRequested`` at ``max_bad_steps`` of them (0:
skip only). The trainers catch it, restore the newest restorable
checkpoint and go on from its epoch and step. ``step_good`` is the same
on every rank (the step's min over the group), so every rank raises at
the same step.
"""

from __future__ import annotations

from typing import Iterable, Optional

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


class RollbackRequested(RuntimeError):
    """``max_bad_steps`` steps in a row were skipped: the trainer restores
    the last good checkpoint."""

    def __init__(self, bad_steps: int):
        super().__init__(f"{bad_steps} consecutive non-finite train steps; rolling back "
                         "to the last good checkpoint")
        self.bad_steps = bad_steps


class StepGuard:
    """Skip accounting and the rollback trigger. ``observe(step_good)``
    queues the flag and reads the one ``lag`` steps old; ``flush()``
    drains the queue (epoch end). Counters: ``bad_total`` (skipped steps
    this run), ``bad_consecutive`` (the current streak), ``rollbacks``."""

    def __init__(self, max_bad_steps: int = 0, lag: int = 1):
        if lag < 0:
            raise ValueError(f"lag must be >= 0, got {lag}")
        self.max_bad_steps = int(max_bad_steps)
        self.lag = int(lag)
        self._pending: list = []
        self.bad_total = 0
        self.bad_consecutive = 0
        self.rollbacks = 0

    def _ingest(self, value) -> None:
        if float(value) > 0.0:
            self.bad_consecutive = 0
            return
        self.bad_total += 1
        self.bad_consecutive += 1
        if self.max_bad_steps and self.bad_consecutive >= self.max_bad_steps:
            self.rollbacks += 1
            bad, self.bad_consecutive = self.bad_consecutive, 0
            self._pending.clear()  # the flags of the condemned run go with it
            raise RollbackRequested(bad)

    def observe(self, step_good: Optional[torch.Tensor]) -> None:
        """Feed one step's ``step_good``; raises ``RollbackRequested`` when
        the streak reaches the limit."""
        if step_good is None:
            return
        self._pending.append(step_good)
        while len(self._pending) > self.lag:
            self._ingest(self._pending.pop(0))

    def flush(self) -> None:
        """Drain the lag window (epoch end, before validation)."""
        while self._pending:
            self._ingest(self._pending.pop(0))

    def reset(self) -> None:
        """Forget the streak (after a rollback restored a good state)."""
        self._pending.clear()
        self.bad_consecutive = 0
