"""The image-classification train and eval steps
(``pytorch_distributed_tpu/train/step.py``: ``prepare_image``:47,
``make_train_step``:63, ``make_eval_step``:231).

The JAX steps run under ``shard_map`` over the mesh's data axis. Here each
process is one rank of a ``parallel.mesh.Mesh`` (or, with ``mesh=None``,
the one device, where every collective below is an identity) and runs the
JAX ``_local_step`` (:97-229) on its replica's rows, in its order:

- the loss: mean softmax cross-entropy with optional label smoothing on
  fp32 logits, scaled by the loss scaler, backward, unscaled;
- the gradients' **mean** over the data group (the sums of
  ``parallel.collectives.all_reduce_grads`` divided once by its size),
  then optional global-norm clipping;
- with ``fsdp`` (a state from ``parallel.fsdp.shard_state``; JAX
  ``make_train_step``:78-135 with ``state_specs``): the parameters' parts
  are all-gathered before the forward (conv kernels back in channels-last)
  and the model runs on them through ``torch.func.functional_call``; the
  parts' gradients come back reduce-scattered and divided by the group's
  size (the same mean, delivered shard-wise), the replicated leaves take
  the plain mean, clipping takes the sharded global norm, and SGD updates
  the parts. BatchNorm statistics, the fp16 finite gate and its skip and
  ``nan_guard`` are as without it: the finite flag's min over the group
  makes a non-finite part anywhere skip the step everywhere;
- the BatchNorm running statistics' mean over the group, right after the
  forward: each replica normalizes with its own batch (DDP's unsynced
  BatchNorm unless the model syncs it) and the state stays replicated.
  This is not DDP's broadcast of rank 0's buffers;
- with ``DynamicLossScaler`` (fp16) the finite flag's min over the group:
  on a non-finite step every rank keeps its parameters and momenta and
  backs off the scale, while the BatchNorm statistics keep the step's
  update (JAX's ``where`` covers only the parameters and ``opt_state``);
- with ``nan_guard`` a non-finite global loss or gradient (the verdict's
  min over the group) keeps the pre-step parameters, momenta and
  BatchNorm statistics; ``step`` advances either way (``step_good``);
- the lr from the schedule at ``state.updates``, the updates applied so
  far (optax's count, which neither guard advances), SGD with momentum
  and weight decay;
- the metrics ``{loss, correct1, correct5, count, grads_finite}`` summed
  over the group: ``loss`` is the global mean, the counts global sums, as
  0-dim device tensors (reading one waits for the step). The fp16 gate and
  ``nan_guard`` read their verdict on the host, once a step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from pytorch_distributed_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_tpu_torch.ops.metrics import ClassificationMetrics
from pytorch_distributed_tpu_torch.ops.optim import clip_grads_by_global_norm
from pytorch_distributed_tpu_torch.ops.precision import NoOpLossScaler, all_finite
from pytorch_distributed_tpu_torch.parallel.collectives import (
    all_reduce_,
    pmean_,
    pmin,
)
from pytorch_distributed_tpu_torch.parallel.fsdp import call_with, gather_params
from pytorch_distributed_tpu_torch.parallel.mesh import Mesh
from pytorch_distributed_tpu_torch.resilience.stepguard import finite_ok, guarded_step
from pytorch_distributed_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def prepare_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 pixels → ``(x / 255 − mean) / std`` in fp32 on the device (the
    host ``Normalize``'s math); float batches pass unchanged."""
    if image.dtype != torch.uint8:
        return image
    mean = torch.from_numpy(IMAGENET_MEAN).to(image.device)
    std = torch.from_numpy(IMAGENET_STD).to(image.device)
    return (image.float() / 255.0 - mean) / std


def _data_group(mesh: Optional[Mesh]):
    """The mesh's data group, or None where there is nothing to reduce."""
    return mesh.data.group if mesh is not None and mesh.data.size > 1 else None


def _pmin_flag(flag: torch.Tensor, group) -> torch.Tensor:
    """A bool flag, True only where it is True on every rank of ``group``."""
    return flag if group is None else pmin(flag.int(), group) > 0


def _psum_metrics(m: ClassificationMetrics, group) -> ClassificationMetrics:
    """The metrics' sums over ``group``, in one all-reduce."""
    if group is None:
        return m
    flat = all_reduce_(torch.stack([m.loss_sum, m.correct1, m.correct5, m.count]),
                       group=group)
    return ClassificationMetrics(*flat.unbind())


def _full_params(state: TrainState, mesh: Optional[Mesh], fsdp: bool) -> Dict[str, torch.Tensor]:
    """FSDP: every part all-gathered (4-d conv kernels in channels-last,
    as the model stores them); else nothing to swap in."""
    if not fsdp:
        return {}
    full = gather_params(state.model, state.layout, mesh.data, mean=True)
    return {n: t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t
            for n, t in full.items()}


def make_train_step(mesh: Optional[Mesh] = None, label_smoothing: float = 0.0,
                    grad_clip_norm: float = 0.0, nan_guard: bool = False,
                    fsdp: bool = False) -> Callable[[TrainState, Batch],
                                                    Tuple[TrainState, Batch]]:
    """``step(state, batch) -> (state, metrics)`` with ``batch``
    ``{"image" [B, H, W, 3], "label" [B]}`` on the model's device: this
    rank's replica's rows on a ``mesh``. ``fsdp``: the state's parameters
    are ``shard_state``'s parts over the mesh's data axis."""
    if fsdp and mesh is None:
        raise ValueError("fsdp=True shards over a mesh's data axis: pass mesh")
    group = _data_group(mesh)

    def step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        scaler = state.scaler
        fp16 = not isinstance(scaler, NoOpLossScaler)
        model.train()
        opt.zero_grad(set_to_none=True)
        saved = [b.clone() for b in model.buffers()] if nan_guard else None
        logits = call_with(model, _full_params(state, mesh, fsdp), prepare_image(batch["image"]))
        loss = cross_entropy_loss(logits, batch["label"], label_smoothing=label_smoothing)
        scaler.scale_loss(loss).backward()
        named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
        grads = scaler.unscale_grads([g for _, g in named])
        sharded = [n in state.layout for n, _ in named] if fsdp else None
        if group is not None:
            # FSDP: the parts came back reduce-scattered, divided by the size
            pmean_([g for i, g in enumerate(grads) if not (sharded and sharded[i])], group)
        if grad_clip_norm:
            clip_grads_by_global_norm(grads, grad_clip_norm,
                                      [mesh.data if s else None for s in sharded]
                                      if fsdp else None)
        if group is not None:
            pmean_(list(model.buffers()), group)
        with torch.no_grad():
            m = _psum_metrics(ClassificationMetrics.from_step(
                cross_entropy_loss(logits, batch["label"], reduction="sum"), logits,
                batch["label"]), group)
        metrics = {"loss": m.loss_sum / torch.clamp(m.count, min=1.0),
                   "correct1": m.correct1, "correct5": m.correct5, "count": m.count}
        ok = torch.ones((), dtype=torch.bool, device=logits.device)
        if fp16:
            finite = _pmin_flag(all_finite(grads).to(logits.device), group)
            state.scaler = scaler.update(finite)
            ok = finite
            metrics["grads_finite"] = finite.float()
        else:
            metrics["grads_finite"] = torch.ones((), device=logits.device)
        if nan_guard:
            good = _pmin_flag(finite_ok(metrics["loss"], grads), group)
            metrics["step_good"] = good.float()
            ok = ok & good
        lr = state.lr_schedule(state.updates)
        for group_ in opt.param_groups:
            group_["lr"] = lr
        if fp16 or nan_guard:
            applied = guarded_step(ok, opt)
            if nan_guard and not applied and not bool(good):
                with torch.no_grad():
                    for b, old in zip(model.buffers(), saved):
                        b.copy_(old)
        else:
            opt.step()
            applied = True
        state.updates += int(applied)
        state.step += 1
        return state, metrics

    return step


def make_eval_step(mesh: Optional[Mesh] = None, fsdp: bool = False) -> Callable[
        [TrainState, Batch, ClassificationMetrics], ClassificationMetrics]:
    """``eval_step(state, batch, metrics) -> metrics``: a forward on the
    running BatchNorm statistics, its loss sum and top-1/5 counts summed
    over the mesh's data group and added to the device accumulator
    (``ClassificationMetrics.empty``). ``fsdp``: the parts are
    all-gathered first, as in the train step."""
    group = _data_group(mesh)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch,
                  metrics: ClassificationMetrics) -> ClassificationMetrics:
        model = state.model
        model.eval()
        logits = call_with(model, _full_params(state, mesh, fsdp), prepare_image(batch["image"]))
        return metrics.merge(_psum_metrics(ClassificationMetrics.from_step(
            cross_entropy_loss(logits, batch["label"], reduction="sum"), logits,
            batch["label"]), group))

    return eval_step
