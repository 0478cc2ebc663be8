"""The LM's optimizer and gradient clipping
(``pytorch_distributed_tpu/ops/optim.py``).

``"adamw"`` is ``optax.adamw(lr, weight_decay=wd)`` (:143): b1 0.9, b2
0.999, ε 1e-8 outside the square root, decay on every parameter, and
``p ← p − lr·(m̂/(√v̂+ε) + wd·p)``. ``torch.optim.AdamW`` applies the same
rule (decay first as ``p·(1 − lr·wd)``, then the Adam step on the moments
of the raw gradient); the tests hold it against optax. Its lr is set per
step by the train step from the schedule.
"""

from __future__ import annotations

from typing import Iterable, List

import torch


def adamw(params: Iterable[torch.nn.Parameter],
          weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """The ``"adamw"`` entry over ``params``, lr 0 until the train step
    sets it (the JAX registry's other entry, SGD, comes with the ResNet
    slice)."""
    return torch.optim.AdamW(list(params), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every gradient, accumulated in fp32 (one card: the
    sharding-aware sums of the JAX version reduce to this)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))


def clip_grads_by_global_norm(grads: List[torch.Tensor],
                              max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)`` —
    identity under the threshold, never an up-scale, and no epsilon, as
    optax's ``clip_by_global_norm``. Returns the pre-clip norm."""
    norm = global_norm(grads)
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm
