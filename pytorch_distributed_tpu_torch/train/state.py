"""Training state (``pytorch_distributed_tpu/train/state.py``): what a
step mutates. The JAX state is an immutable pytree a step replaces; here
the model (with its BatchNorm running statistics as buffers) and the
optimizer are updated in place and the step returns the same object.
``lr_schedule`` stands where optax keeps the schedule inside the
optimizer: the step calls it with ``updates``, the count of updates
applied (optax's count, which a skipped step does not advance), before
each update, while ``step`` counts every step. ``scaler`` is the loss
scaler: ``NoOpLossScaler`` for fp32 and bf16, ``DynamicLossScaler`` for
fp16."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.models.convert import (
    init_resnet_params,
    resnet_params_from_jax,
)
from pytorch_distributed_tpu_torch.ops.optim import sgd_with_weight_decay
from pytorch_distributed_tpu_torch.ops.precision import DynamicLossScaler, NoOpLossScaler


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    step: int = 0
    scaler: Union[NoOpLossScaler, DynamicLossScaler] = dataclasses.field(
        default_factory=NoOpLossScaler)
    updates: int = 0

    def param_count(self) -> int:
        return sum(p.numel() for p in self.model.parameters())


def create_resnet_state(model, *, lr_schedule: Callable[[int], float], momentum: float = 0.9,
                        weight_decay: float = 1e-4, seed: int = 0,
                        params: Optional[Dict[str, torch.Tensor]] = None,
                        device=None, scaler=None) -> TrainState:
    """``model`` (a ``models.ResNet``) on ``device`` (CUDA unless asked for
    the CPU) with ``params`` (a state dict, e.g. from
    ``resnet_params_from_jax``) or the flax-scale initialisation of
    ``seed``, its SGD (``ops.optim.sgd_with_weight_decay``) and ``scaler``
    (``NoOpLossScaler`` when None; a ``DynamicLossScaler`` moves to the
    device)."""
    dev = resolve_device(device)
    if params is None:
        params = resnet_params_from_jax(init_resnet_params(model, seed), fused=model.fused)
    model.load_state_dict(params)
    model.to(dev)
    return TrainState(model=model, optimizer=sgd_with_weight_decay(
        model.parameters(), momentum, weight_decay), lr_schedule=lr_schedule,
        scaler=(scaler or NoOpLossScaler()).to(dev))
