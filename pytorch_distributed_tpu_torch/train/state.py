"""Training state (``pytorch_distributed_tpu/train/state.py``): what a
step mutates. The JAX state is an immutable pytree a step replaces; here
the model (with its BatchNorm running statistics as buffers) and the
optimizer are updated in place and the step returns the same object.
``lr_schedule`` stands where optax keeps the schedule inside the
optimizer: the step calls it with ``updates``, the count of updates
applied (optax's count, which a skipped step does not advance), before
each update, while ``step`` counts every step. ``scaler`` is the loss
scaler: ``NoOpLossScaler`` for fp32 and bf16, ``DynamicLossScaler`` for
fp16.

``state_payload`` flattens a state into the checkpoint's leaves
(``utils.checkpoint``), ``/``-joined paths under ``state/``:

- ``model/<module path>/<name>``: every parameter and buffer of the
  model's state dict (the BatchNorm running statistics among them);
- ``optimizer/<parameter path>/<key>``: the optimizer's state of each
  parameter that has one: SGD's ``momentum_buffer``, AdamW's
  ``exp_avg``, ``exp_avg_sq`` and ``step``;
- ``step`` (every step) and ``updates`` (the count the lr schedule reads);
- ``scaler/scale`` and ``scaler/growth_tracker`` with fp16's
  ``DynamicLossScaler``.

``restore_state`` puts such leaves back into a built state in place, on
its devices; the JAX package's layout (``state/params/...``) crosses
through ``models.convert.resnet_payload_from_jax`` /
``lm_payload_from_jax`` first.

A sharded state (FSDP, ``parallel.fsdp.shard_state``; a pipeline stage,
``train.pp``) names in ``layout`` each parameter this rank holds only a
part of, with its ``utils.checkpoint.Shard``. Its leaves, and the
optimizer's moments of the same shape, go out as ``ShardedLeaf``s, so
the checkpoint holds the global leaf whatever the topology, and a
restore takes this rank's part of each global leaf: a sharded run's
checkpoint restores into a replicated run and the reverse."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.models.convert import (
    init_resnet_params,
    resnet_params_from_jax,
)
from pytorch_distributed_tpu_torch.ops.optim import sgd_with_weight_decay
from pytorch_distributed_tpu_torch.ops.precision import DynamicLossScaler, NoOpLossScaler
from pytorch_distributed_tpu_torch.utils.checkpoint import Shard, ShardedLeaf


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr_schedule: Callable[[int], float]
    step: int = 0
    scaler: Union[NoOpLossScaler, DynamicLossScaler] = dataclasses.field(
        default_factory=NoOpLossScaler)
    updates: int = 0
    #: parameter name -> its ``Shard`` for every parameter this rank holds
    #: a part of (empty: the whole model is here)
    layout: Dict[str, Shard] = dataclasses.field(default_factory=dict)

    def param_count(self) -> int:
        """Parameters of the global model."""
        return sum(int(np.prod(self.layout[n].shape)) if n in self.layout else p.numel()
                   for n, p in self.model.named_parameters())


def create_resnet_state(model, *, lr_schedule: Callable[[int], float], momentum: float = 0.9,
                        weight_decay: float = 1e-4, seed: int = 0,
                        params: Optional[Dict[str, torch.Tensor]] = None,
                        device=None, scaler=None) -> TrainState:
    """``model`` (a ``models.ResNet``) on ``device`` (CUDA unless asked for
    the CPU) with ``params`` (a state dict, e.g. from
    ``resnet_params_from_jax``) or the flax-scale initialisation of
    ``seed``, its SGD (``ops.optim.sgd_with_weight_decay``) and ``scaler``
    (``NoOpLossScaler`` when None; a ``DynamicLossScaler`` moves to the
    device)."""
    dev = resolve_device(device)
    if params is None:
        params = resnet_params_from_jax(init_resnet_params(model, seed), fused=model.fused)
    model.load_state_dict(params)
    model.to(dev)
    return TrainState(model=model, optimizer=sgd_with_weight_decay(
        model.parameters(), momentum, weight_decay), lr_schedule=lr_schedule,
        scaler=(scaler or NoOpLossScaler()).to(dev))


def _param_names(model: torch.nn.Module) -> Dict[int, str]:
    return {id(p): name for name, p in model.named_parameters()}


def state_payload(state: TrainState) -> Dict[str, object]:
    """The state's checkpoint leaves (module docstring): the live tensors,
    which the checkpoint's snapshot copies."""
    out: Dict[str, object] = {"state/step": int(state.step),
                              "state/updates": int(state.updates)}
    layout = state.layout

    def leaf(name, v):
        sh = layout.get(name)
        return ShardedLeaf(v, sh) if sh is not None and v.dim() else v

    for k, v in state.model.state_dict().items():
        out["state/model/" + k.replace(".", "/")] = leaf(k, v)
    names = _param_names(state.model)
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            for key, v in state.optimizer.state.get(p, {}).items():
                if isinstance(v, torch.Tensor):
                    name = names[id(p)]
                    out[f"state/optimizer/{name.replace('.', '/')}/{key}"] = leaf(name, v)
    if isinstance(state.scaler, DynamicLossScaler):
        out["state/scaler/scale"] = state.scaler.scale
        out["state/scaler/growth_tracker"] = state.scaler.growth_tracker
    return out


def restore_state(state: TrainState, leaves: Mapping[str, torch.Tensor]) -> None:
    """Put checkpoint ``leaves`` (``state_payload``'s paths; CPU tensors,
    perhaps read-only views of a mapped file) into ``state`` in place:
    parameters and buffers copied onto the model's devices, the
    optimizer's state replaced by the saved one (copies on each
    parameter's device; AdamW's ``step`` where torch keeps it), ``step``,
    ``updates`` and the fp16 scaler. A parameter in ``state.layout`` and
    its moments take this rank's part of the global leaf. Raises
    ``KeyError`` / ``ValueError`` when the leaves do not fit the state,
    before changing anything."""
    model_keys = {"state/model/" + k.replace(".", "/") for k in state.model.state_dict()}
    saved = {p for p in leaves if p.startswith("state/model/")}
    if saved != model_keys:
        raise KeyError(f"checkpoint model leaves do not match the model: missing "
                       f"{sorted(model_keys - saved)[:4]}, unexpected "
                       f"{sorted(saved - model_keys)[:4]}")
    layout = state.layout

    def part(name, src):  # this rank's part of a global leaf
        sh = layout.get(name)
        if sh is None or src.dim() == 0:
            return src
        if tuple(src.shape) != tuple(sh.shape):
            raise ValueError(f"checkpoint leaf {name}: shape {tuple(src.shape)}, the global "
                             f"leaf's {tuple(sh.shape)}")
        return sh.take(src)

    sd = state.model.state_dict()
    for k, v in sd.items():
        src = part(k, leaves["state/model/" + k.replace(".", "/")])
        if tuple(src.shape) != tuple(v.shape):
            raise ValueError(f"checkpoint leaf {k}: shape {tuple(src.shape)}, the model's "
                             f"{tuple(v.shape)}")
    dynamic = isinstance(state.scaler, DynamicLossScaler)
    if dynamic and "state/scaler/scale" not in leaves:
        raise KeyError("the fp16 state's checkpoint has no state/scaler leaves")
    with torch.no_grad():
        for k, v in sd.items():
            v.copy_(part(k, leaves["state/model/" + k.replace(".", "/")]))
    opt = state.optimizer
    names = _param_names(state.model)
    packed = opt.state_dict()
    packed["state"] = {}
    index = 0
    for group in opt.param_groups:
        for p in group["params"]:
            prefix = f"state/optimizer/{names[id(p)].replace('.', '/')}/"
            entry = {}
            for path, src in leaves.items():
                if path.startswith(prefix):
                    key = path[len(prefix):]
                    # torch keeps a non-fused optimizer's step on the CPU
                    entry[key] = (src.clone() if key == "step"
                                  else part(names[id(p)], src).to(p.device, copy=True))
            if entry:
                packed["state"][index] = entry
            index += 1
    opt.load_state_dict(packed)
    state.step = int(leaves["state/step"])
    state.updates = int(leaves["state/updates"])
    if dynamic:
        dev = state.scaler.scale.device
        state.scaler = dataclasses.replace(
            state.scaler, scale=leaves["state/scaler/scale"].to(dev, torch.float32, copy=True),
            growth_tracker=leaves["state/scaler/growth_tracker"].to(dev, torch.int32,
                                                                    copy=True))
