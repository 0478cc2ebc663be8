"""The image-classification train and eval steps on one card
(``pytorch_distributed_tpu/train/step.py``: ``prepare_image``:47,
``make_train_step``:63, ``make_eval_step``:231).

The JAX steps run under ``shard_map`` over the mesh's data axis; this is
their one-device case, where the gradient and batch-statistics ``pmean``
and the metrics ``psum`` are identities. What carries over exactly:

- the loss: mean softmax cross-entropy with optional label smoothing on
  fp32 logits, through the (no-op) loss scaler;
- the update: optional global-norm clipping, the lr from the schedule at
  the pre-update step, SGD with momentum and weight decay; with
  ``nan_guard`` a non-finite loss or gradient keeps the pre-step
  parameters, momenta and BatchNorm statistics while ``step`` still
  advances (``step_good`` metric);
- the metrics ``{loss, correct1, correct5, count, grads_finite}``: the
  un-smoothed cross-entropy mean and the top-k counts of the step's
  logits, as 0-dim device tensors (reading one waits for the step).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_tpu_torch.ops.metrics import ClassificationMetrics
from pytorch_distributed_tpu_torch.ops.optim import clip_grads_by_global_norm
from pytorch_distributed_tpu_torch.resilience.stepguard import finite_ok, guarded_step
from pytorch_distributed_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def prepare_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 pixels → ``(x / 255 − mean) / std`` in fp32 on the device (the
    host ``Normalize``'s math); float batches pass unchanged."""
    if image.dtype != torch.uint8:
        return image
    mean = torch.from_numpy(IMAGENET_MEAN).to(image.device)
    std = torch.from_numpy(IMAGENET_STD).to(image.device)
    return (image.float() / 255.0 - mean) / std


def make_train_step(label_smoothing: float = 0.0, grad_clip_norm: float = 0.0,
                    nan_guard: bool = False) -> Callable[[TrainState, Batch],
                                                         Tuple[TrainState, Batch]]:
    """``step(state, batch) -> (state, metrics)`` with ``batch``
    ``{"image" [B, H, W, 3], "label" [B]}`` on the model's device."""

    def step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        saved = [b.clone() for b in model.buffers()] if nan_guard else None
        logits = model(prepare_image(batch["image"]))
        loss = cross_entropy_loss(logits, batch["label"], label_smoothing=label_smoothing)
        state.scaler.scale_loss(loss).backward()
        grads = state.scaler.unscale_grads(
            [p.grad for p in model.parameters() if p.grad is not None])
        if grad_clip_norm:
            clip_grads_by_global_norm(grads, grad_clip_norm)
        lr = state.lr_schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        with torch.no_grad():
            m = ClassificationMetrics.from_step(
                cross_entropy_loss(logits, batch["label"], reduction="sum"), logits,
                batch["label"])
        metrics = {"loss": m.loss_sum / torch.clamp(m.count, min=1.0),
                   "correct1": m.correct1, "correct5": m.correct5, "count": m.count,
                   "grads_finite": torch.ones((), device=logits.device)}
        if nan_guard:
            good = finite_ok(metrics["loss"], grads)
            if not guarded_step(good, opt):
                with torch.no_grad():
                    for b, old in zip(model.buffers(), saved):
                        b.copy_(old)
            metrics["step_good"] = good.float()
        else:
            opt.step()
        state.step += 1
        return state, metrics

    return step


def make_eval_step() -> Callable[[TrainState, Batch, ClassificationMetrics],
                                 ClassificationMetrics]:
    """``eval_step(state, batch, metrics) -> metrics``: a forward on the
    running BatchNorm statistics, its loss sum and top-1/5 counts added
    to the device accumulator (``ClassificationMetrics.empty``)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch,
                  metrics: ClassificationMetrics) -> ClassificationMetrics:
        model = state.model
        model.eval()
        logits = model(prepare_image(batch["image"]))
        return metrics.merge(ClassificationMetrics.from_step(
            cross_entropy_loss(logits, batch["label"], reduction="sum"), logits,
            batch["label"]))

    return eval_step
