"""Resilience: deterministic fault injection (``faults``), the step guard
that skips a non-finite update and asks for a rollback after K in a row
(``stepguard``), the per-step and per-replica deadline watchdogs
(``watchdog``) and bounded retry (``retry``)."""

from pytorch_distributed_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    clear_plan,
    fault_point,
    install_plan,
    poison_batch,
)
from pytorch_distributed_tpu_torch.resilience.retry import retry_call, retrying
from pytorch_distributed_tpu_torch.resilience.stepguard import (
    RollbackRequested,
    StepGuard,
    finite_ok,
    guarded_step,
)
from pytorch_distributed_tpu_torch.resilience.watchdog import FleetWatchdog, Watchdog

__all__ = ["FaultPlan", "FaultSpec", "FleetWatchdog", "InjectedFault", "RollbackRequested",
           "StepGuard", "Watchdog", "clear_plan", "fault_point", "finite_ok", "guarded_step",
           "install_plan", "poison_batch", "retry_call", "retrying"]
