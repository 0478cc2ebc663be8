"""Softmax cross-entropy over integer labels
(``pytorch_distributed_tpu/ops/losses.py``): ``log_softmax`` in fp32, so it
is safe on bf16-produced logits. The image trainers' loss and the unfused LM
loss tail."""

from __future__ import annotations

import torch


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smoothing: float = 0.0,
                       reduction: str = "mean") -> torch.Tensor:
    """``logits [N, K]``, ``labels [N]``; ``reduction`` 'mean', 'sum' or
    'none'. Label smoothing follows torch: ``(1 - eps) * one_hot + eps / K``."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    if label_smoothing > 0.0:
        k = logits.shape[-1]
        targets = torch.nn.functional.one_hot(labels.long(), k).float()
        targets = targets * (1.0 - label_smoothing) + label_smoothing / k
        per_example = -(targets * log_probs).sum(dim=-1)
    else:
        per_example = -log_probs.gather(-1, labels.long()[:, None])[:, 0]
    if reduction == "mean":
        return per_example.mean()
    if reduction == "sum":
        return per_example.sum()
    if reduction == "none":
        return per_example
    raise ValueError(f"unknown reduction {reduction!r}")
