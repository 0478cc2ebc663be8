"""Mixed-precision policy (``pytorch_distributed_tpu/ops/precision.py``).

``Policy`` names the dtype of each class of tensor: parameters fp32, the
compute (convs, matrix products, activations) fp32 or bf16, the logits and
loss fp32. bf16 keeps fp32's exponent range, so the bf16 path needs no loss
scaling: ``NoOpLossScaler`` keeps the scaler's interface and does nothing.
The fp16 ``DynamicLossScaler`` comes with the AMP recipe.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

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


class NoOpLossScaler:
    """The bf16 and fp32 scaler: the loss and the gradients pass unchanged
    and every step counts as finite."""

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss

    def unscale_grads(self, grads):
        return grads

    def update(self, grads_finite) -> "NoOpLossScaler":
        return self
