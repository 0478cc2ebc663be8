"""Top-k accuracy metrics (``pytorch_distributed_tpu/ops/metrics.py``):
correct@1, correct@5, the loss sum and the count accumulated as fp32
tensors on the device, so the validation loop never waits for the host
until its summary."""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 ks: Sequence[int] = (1, 5)) -> Dict[str, torch.Tensor]:
    """Number of examples whose label is among the top-k logits, per k,
    as fp32 0-dim tensors; k past the class count always hits. Ties, and
    the NaN logits of a non-finite step, rank lower index first, as
    ``lax.top_k`` does (``torch.topk`` leaves their order open)."""
    num_classes = logits.shape[-1]
    max_k = min(max(ks), num_classes)
    pred = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :max_k]
    hit = pred == labels[:, None].to(pred.dtype)
    return {f"correct{k}": hit[:, :min(k, num_classes)].sum().float() for k in ks}


@dataclasses.dataclass
class ClassificationMetrics:
    """Running sums: loss, correct@1, correct@5, count (0-dim fp32)."""

    loss_sum: torch.Tensor
    correct1: torch.Tensor
    correct5: torch.Tensor
    count: torch.Tensor

    @classmethod
    def empty(cls, device=None) -> "ClassificationMetrics":
        return cls(*(torch.zeros((), dtype=torch.float32, device=device) for _ in range(4)))

    @classmethod
    def from_step(cls, loss_sum: torch.Tensor, logits: torch.Tensor,
                  labels: torch.Tensor) -> "ClassificationMetrics":
        correct = topk_correct(logits, labels, ks=(1, 5))
        return cls(loss_sum=loss_sum.float(), correct1=correct["correct1"],
                   correct5=correct["correct5"],
                   count=torch.tensor(float(logits.shape[0]), device=logits.device))

    def merge(self, other: "ClassificationMetrics") -> "ClassificationMetrics":
        return ClassificationMetrics(*(a + b for a, b in zip(dataclasses.astuple(self),
                                                              dataclasses.astuple(other))))

    def summary(self, num_batches: int | None = None) -> dict:
        """Host-side readout: mean loss, acc1 %, acc5 %, count."""
        count = float(self.count)
        loss_denom = num_batches if num_batches else max(count, 1.0)
        return {
            "loss": float(self.loss_sum) / max(loss_denom, 1.0),
            "acc1": 100.0 * float(self.correct1) / max(count, 1.0),
            "acc5": 100.0 * float(self.correct5) / max(count, 1.0),
            "count": count,
        }
