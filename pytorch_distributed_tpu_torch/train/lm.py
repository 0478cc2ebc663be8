"""LM train and eval steps (``pytorch_distributed_tpu/train/lm.py``).

The JAX steps run under ``shard_map`` over a (data, seq) mesh. Here each
process is one rank of a ``parallel.mesh.Mesh`` (or, with ``mesh=None``,
the one device) and runs the JAX ``_local_step`` on its shard of the
batch: its data replica's rows, its sequence shard's columns. FSDP,
tensor, expert and pipeline parallelism are not ported. What carries over
exactly:

- the loss is Σ(w·ce)/max(Σw, 1) (``_lm_loss_sum``:391), by default
  through the fused linear cross-entropy on the post-ln_f hidden states,
  with Σw the token count all-reduced over data × seq, so each rank's
  local loss is its share of the global mean;
- gradients are summed over every rank (the JAX ``psum`` over data × seq),
  then clipped, then passed to AdamW; the ``loss`` metric is the sum of
  the local losses;
- the update: optional global-norm clipping (the pre-clip norm is the
  ``grad_norm`` metric), the lr from the schedule at ``state.updates``,
  the updates applied so far (optax's count inside ``opt_state``), AdamW,
  and with ``nan_guard`` a non-finite loss or gradient skips the update
  while ``step`` still advances and ``updates`` does not (``step_good``
  metric), every rank's verdict combined by a min as the JAX ``pmin``
  does;
- a seq-sharded mesh needs ring attention (``check_seq_parallel_attention``),
  and a zigzag shard's wpe positions follow the chunk map
  (``shard_positions``).

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
    RING_ATTENTIONS,
    TransformerConfig,
    TransformerLM,
)
from pytorch_distributed_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_tpu_torch.ops.optim import adamw, clip_grads_by_global_norm
from pytorch_distributed_tpu_torch.parallel.collectives import all_reduce_, all_reduce_grads
from pytorch_distributed_tpu_torch.parallel.mesh import Mesh
from pytorch_distributed_tpu_torch.parallel.sequence import zigzag_positions
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


def check_seq_parallel_attention(mesh: Optional[Mesh], config) -> None:
    """Refuse silently wrong sequence parallelism: on a seq-sharded mesh,
    dense or flash attention would attend within each shard only
    (``check_seq_parallel_attention``:368 of the JAX package)."""
    if mesh is not None and mesh.seq.size > 1 and config.attention not in RING_ATTENTIONS:
        raise ValueError(
            f"mesh shards the sequence axis 'seq' (size {mesh.seq.size}) but "
            f"config.attention={config.attention!r}: non-ring attention is "
            "shard-local under sequence parallelism and computes the wrong "
            "function. Use attention='ring'/'ring_flash' (or a seq-axis size of 1).")


def _over_mesh(mesh: Optional[Mesh], t: torch.Tensor,
               op=torch.distributed.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over every rank of ``mesh`` (the whole job);
    ``t`` itself without a mesh."""
    return t if mesh is None else all_reduce_(t, op)


def shard_positions(config, tokens: torch.Tensor, mesh: Optional[Mesh]):
    """The absolute positions of this shard's ``tokens [B, L]`` as
    ``(positions, offset)``: contiguous shards give ``(None, seq_index *
    L)``, zigzag shards the chunk-map position vector (on the tokens'
    device) and offset 0 (``_shard_positions``:345)."""
    lq = tokens.shape[1]
    if mesh is None:
        return None, 0
    if config.ring_layout == "zigzag":
        return zigzag_positions(lq, mesh.seq.size, mesh.seq.index).to(tokens.device), 0
    return None, mesh.seq.index * lq


def make_lm_train_step(*, grad_clip_norm: float = 0.0, fused_ce: bool = True,
                       nan_guard: bool = False, mesh: Optional[Mesh] = None, config=None):
    """``step(state, batch) -> (state, metrics)`` with ``batch``
    ``{"tokens", "labels", "weights"}`` ``[B, L]`` on the model's device:
    this rank's shard on a ``mesh`` (``train.lm_trainer.shard_lm_batch``).
    Metrics are 0-dim device tensors (reading one waits for the step), the
    same on every rank: ``loss``, ``tokens``, and ``grad_norm`` (with
    clipping) and ``step_good`` (with ``nan_guard``, which reads its
    verdict on the host every step). ``config``, when given, is checked
    against the mesh."""
    if config is not None:
        check_seq_parallel_attention(mesh, config)

    def step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        positions, offset = shard_positions(model.cfg, batch["tokens"], mesh)
        # the global count: each rank's loss is its share of the global mean
        count = _over_mesh(mesh, batch["weights"].sum())
        out = model(batch["tokens"], position_offset=offset, positions=positions,
                    return_hidden=fused_ce)
        loss = lm_loss_sum(out, model, batch, fused_ce) / torch.clamp(count, min=1.0)
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if mesh is not None:
            all_reduce_grads(grads)
        metrics = {"loss": _over_mesh(mesh, loss.detach().clone()), "tokens": count}
        if grad_clip_norm:
            metrics["grad_norm"] = clip_grads_by_global_norm(grads, grad_clip_norm)
        lr = state.lr_schedule(state.updates)
        for group in opt.param_groups:
            group["lr"] = lr
        if nan_guard:
            good = _over_mesh(mesh, finite_ok(metrics["loss"], grads).int(),
                              torch.distributed.ReduceOp.MIN) > 0
            state.updates += int(guarded_step(good, opt))
            metrics["step_good"] = good.float()
        else:
            opt.step()
            state.updates += 1
        state.step += 1
        return state, metrics

    return step


def make_lm_eval_step(*, fused_ce: bool = True, mesh: Optional[Mesh] = None, config=None):
    """``eval_step(state, batch, acc) -> acc``: adds the batch's weighted
    CE sum and token count, summed over every rank, to the device
    accumulator (``empty_lm_metrics``); perplexity is
    exp(loss_sum / tokens)."""
    if config is not None:
        check_seq_parallel_attention(mesh, config)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, acc: Batch) -> Batch:
        model = state.model
        model.eval()
        positions, offset = shard_positions(model.cfg, batch["tokens"], mesh)
        out = model(batch["tokens"], position_offset=offset, positions=positions,
                    return_hidden=fused_ce)
        acc["loss_sum"] += _over_mesh(mesh, lm_loss_sum(out, model, batch, fused_ce))
        acc["tokens"] += _over_mesh(mesh, batch["weights"].sum())
        return acc

    return eval_step


def empty_lm_metrics(device=None) -> Batch:
    return {"loss_sum": torch.zeros((), dtype=torch.float32, device=device),
            "tokens": torch.zeros((), dtype=torch.float32, device=device)}
