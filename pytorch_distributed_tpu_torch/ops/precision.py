"""Mixed-precision policy (``pytorch_distributed_tpu/ops/precision.py``).

``Policy`` names the dtype of each class of tensor: parameters fp32, the
compute (convs, matrix products, activations) fp32 or bf16, the logits and
loss fp32. bf16 keeps fp32's exponent range, so the bf16 path needs no loss
scaling: ``NoOpLossScaler`` keeps the scaler's interface and does nothing.
``DynamicLossScaler`` is torch ``GradScaler``'s algorithm for the fp16
recipe (``DynamicLossScaler``:85): scale the loss, unscale the gradients,
skip the update on a non-finite one and halve the scale, double it after
``growth_interval`` finite steps in a row. Its state is two 0-dim device
tensors and ``update`` is ``torch.where`` arithmetic in the JAX order, so
it reads nothing on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def _cast(self, tree: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
        return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tree.items()}

    def cast_to_compute(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self._cast(tree, self.compute_dtype)

    def cast_to_param(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self._cast(tree, self.param_dtype)


def fp32_policy() -> Policy:
    """The baseline recipes' fp32."""
    return Policy()


def bf16_policy() -> Policy:
    """bf16 compute on fp32 parameters."""
    return Policy(compute_dtype=torch.bfloat16)


def all_finite(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """0-dim bool tensor: every float tensor is finite (``all_finite``:71;
    True for none)."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return torch.stack(flags).all()


@dataclasses.dataclass(frozen=True)
class DynamicLossScaler:
    """``scale`` fp32 and ``growth_tracker`` int32, 0-dim tensors on the
    model's device; ``update`` returns the next scaler, as the JAX pytree
    does."""

    scale: torch.Tensor
    growth_tracker: torch.Tensor
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000

    @classmethod
    def create(cls, init_scale: float = 2.0 ** 16, device=None,
               **kwargs) -> "DynamicLossScaler":
        return cls(scale=torch.tensor(init_scale, dtype=torch.float32, device=device),
                   growth_tracker=torch.zeros((), dtype=torch.int32, device=device),
                   **kwargs)

    def to(self, device) -> "DynamicLossScaler":
        return dataclasses.replace(self, scale=self.scale.to(device),
                                   growth_tracker=self.growth_tracker.to(device))

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.scale.to(loss.dtype)

    def unscale_grads(self, grads):
        """Multiply each gradient in place by 1 / scale (fp32, then cast to
        the gradient's dtype); returns ``grads``."""
        inv = 1.0 / self.scale
        for g in grads:
            g.mul_(inv.to(g.dtype))
        return grads

    def update(self, grads_finite: torch.Tensor) -> "DynamicLossScaler":
        grew = self.growth_tracker + 1 >= self.growth_interval
        scale = torch.where(
            grads_finite, torch.where(grew, self.scale * self.growth_factor, self.scale),
            self.scale * self.backoff_factor)
        zero = torch.zeros_like(self.growth_tracker)
        tracker = torch.where(grads_finite,
                              torch.where(grew, zero, self.growth_tracker + 1), zero)
        return dataclasses.replace(self, scale=scale, growth_tracker=tracker)


class NoOpLossScaler:
    """The bf16 and fp32 scaler: the loss and the gradients pass unchanged
    and every step counts as finite."""

    scale = 1.0

    def to(self, device) -> "NoOpLossScaler":
        return self

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss

    def unscale_grads(self, grads):
        return grads

    def update(self, grads_finite) -> "NoOpLossScaler":
        return self
