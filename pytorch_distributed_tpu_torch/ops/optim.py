"""Optimizers and gradient clipping (``pytorch_distributed_tpu/ops/optim.py``).

``sgd_with_weight_decay`` (:115) is optax's ``add_decayed_weights(wd)`` →
``trace(momentum)`` → ``scale_by_learning_rate``: ``g ← g + wd·p``,
``buf ← momentum·buf + g`` (zero-initialised), ``p ← p − lr·buf``.
``torch.optim.SGD`` with dampening 0 and no Nesterov applies exactly that
(its first step sets ``buf = g``, which is the same value); it decays every
parameter it is given, BatchNorm's included, as the optax chain does.

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


def sgd_with_weight_decay(params: Iterable[torch.nn.Parameter], momentum: float = 0.9,
                          weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """SGD with momentum and weight decay in optax's order, lr 0 until the
    train step sets it from the schedule."""
    return torch.optim.SGD(list(params), lr=0.0, momentum=momentum, dampening=0.0,
                           weight_decay=weight_decay, nesterov=False)


def adamw(params: Iterable[torch.nn.Parameter],
          weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """The ``"adamw"`` entry over ``params``, lr 0 until the train step
    sets it."""
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
