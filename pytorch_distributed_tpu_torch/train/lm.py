"""LM train and eval steps on one card (``pytorch_distributed_tpu/train/lm.py``).

The JAX steps run under ``shard_map`` over a (data, seq) mesh; this is
their one-device case: no mesh, FSDP, tensor, expert or pipeline
parallelism. What carries over exactly:

- the loss is Σ(w·ce)/max(Σw, 1) over the batch (``_lm_loss_sum``:391),
  by default through the fused linear cross-entropy on the post-ln_f
  hidden states;
- the update: optional global-norm clipping (the pre-clip norm is the
  ``grad_norm`` metric), the lr from the schedule at the pre-update step,
  AdamW, and with ``nan_guard`` a non-finite loss or gradient skips the
  update while ``step`` still advances (``step_good`` metric).

Parameters train in fp32 with ``config.dtype`` compute, as flax does:
``create_lm_state`` sets the config's ``param_dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax
from pytorch_distributed_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
)
from pytorch_distributed_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_tpu_torch.ops.optim import adamw, clip_grads_by_global_norm
from pytorch_distributed_tpu_torch.resilience.stepguard import finite_ok, guarded_step
from pytorch_distributed_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def shift_labels(tokens: np.ndarray, pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Next-token targets on the host: ``labels[t] = tokens[t + 1]``; the
    last position predicts ``pad_id`` and has weight 0."""
    labels = np.concatenate(
        [tokens[:, 1:], np.full((tokens.shape[0], 1), pad_id, tokens.dtype)], axis=1)
    weights = np.ones_like(tokens, np.float32)
    weights[:, -1] = 0.0
    return labels, weights


def create_lm_state(config: TransformerConfig, *, lr_schedule: Callable[[int], float],
                    weight_decay: float = 1e-4, seed: int = 0,
                    params: Optional[Dict[str, torch.Tensor]] = None,
                    device=None) -> TrainState:
    """A ``TransformerLM`` with fp32 parameters on ``device`` (CUDA unless
    asked for the CPU): ``params`` (a state dict, e.g. from
    ``params_from_jax``) or the flax-layout initialisation of ``seed``
    (``models.convert.init_params``), and its AdamW."""
    cfg = dataclasses.replace(config, param_dtype=torch.float32)
    dev = resolve_device(device)
    with torch.device(dev):
        model = TransformerLM(cfg)
    model.load_state_dict(params if params is not None
                          else params_from_jax(init_params(cfg, seed)))
    return TrainState(model=model, optimizer=adamw(model.parameters(), weight_decay),
                      lr_schedule=lr_schedule)


def lm_loss_sum(out: torch.Tensor, model: TransformerLM, batch: Batch,
                use_fused: bool) -> torch.Tensor:
    """Σ(w·ce) of one forward's output: hidden states through the fused
    CE with ``model.lm_head`` (the JAX steps' 512-row blocks), or full
    logits through the plain CE."""
    if use_fused:
        return fused_linear_cross_entropy(
            out, model.lm_head.weight, batch["labels"], batch["weights"],
            compute_dtype=model.cfg.dtype)
    per_tok = cross_entropy_loss(out.reshape(-1, out.shape[-1]),
                                 batch["labels"].reshape(-1), reduction="none")
    return (per_tok * batch["weights"].reshape(-1)).sum()


def make_lm_train_step(*, grad_clip_norm: float = 0.0, fused_ce: bool = True,
                       nan_guard: bool = False):
    """``step(state, batch) -> (state, metrics)`` with ``batch``
    ``{"tokens", "labels", "weights"}`` ``[B, L]`` on the model's device.
    Metrics are 0-dim device tensors (reading one waits for the step):
    ``loss``, ``tokens``, and ``grad_norm`` (with clipping) and
    ``step_good`` (with ``nan_guard``, which reads its verdict on the
    host every step)."""

    def step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        count = batch["weights"].sum()
        out = model(batch["tokens"], return_hidden=fused_ce)
        loss = lm_loss_sum(out, model, batch, fused_ce) / torch.clamp(count, min=1.0)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics = {"loss": loss.detach(), "tokens": count}
        if grad_clip_norm:
            metrics["grad_norm"] = clip_grads_by_global_norm(grads, grad_clip_norm)
        lr = state.lr_schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        if nan_guard:
            good = finite_ok(metrics["loss"], grads)
            guarded_step(good, opt)
            metrics["step_good"] = good.float()
        else:
            opt.step()
        state.step += 1
        return state, metrics

    return step


def make_lm_eval_step(*, fused_ce: bool = True):
    """``eval_step(state, batch, acc) -> acc``: adds the batch's weighted
    CE sum and token count to the device accumulator
    (``empty_lm_metrics``); perplexity is exp(loss_sum / tokens)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, acc: Batch) -> Batch:
        model = state.model
        model.eval()
        out = model(batch["tokens"], return_hidden=fused_ce)
        acc["loss_sum"] += lm_loss_sum(out, model, batch, fused_ce)
        acc["tokens"] += batch["weights"].sum()
        return acc

    return eval_step


def empty_lm_metrics(device=None) -> Batch:
    return {"loss_sum": torch.zeros((), dtype=torch.float32, device=device),
            "tokens": torch.zeros((), dtype=torch.float32, device=device)}
