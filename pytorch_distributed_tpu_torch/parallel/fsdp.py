"""ZeRO-3 FSDP: parameters and optimizer state sharded over the data axis
(``pytorch_distributed_tpu/parallel/fsdp.py``).

As in the JAX package, sharding changes where a leaf lives, not the step's
math:

- at rest each member parameter is split along ``fsdp_dim`` (its largest
  dimension the data axis's size divides; leaves under 1024 elements stay
  replicated), and this rank keeps only its part, as an ``nn.Parameter``
  in the model in place of the whole (``shard_state``); the optimizer's
  state follows its parameter, so a rank's parameter and optimizer bytes
  drop by about the axis's size;
- the step all-gathers the parts back to whole leaves just before the
  forward (``gather_params``, an ``autograd.Function``) and runs the model
  on them through ``torch.func.functional_call``;
- the backward of that gather is its transpose, a reduce-scatter: each rank
  receives the sum over the data group of its part's gradient, divided by
  the group's size for a mean (JAX's ``scatter_grads``, the image step) or
  not (the LM step, whose per-rank loss is already its share of the global
  mean); replicated leaves take the plain mean (or sum) instead;
- the optimizer updates the local parts (SGD and AdamW are elementwise;
  AdamW decays every parameter, so no decay mask depends on a part's
  shape).

The gather and the scatter are ``parallel.collectives``' ``all_gather``
and ``reduce_scatter``: NCCL's own on NCCL; on gloo, which has no
reduce-scatter, the sum's all-reduce followed by this rank's slice, CUDA
tensors staged through the host.

``Shard`` (``utils.checkpoint``) records each part's place in its global
leaf in ``TrainState.layout``, so checkpoints hold the global leaves and
an FSDP run's checkpoint restores into a replicated run and the reverse.
"""

from __future__ import annotations

from typing import Container, Dict, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.parallel.collectives import all_gather, reduce_scatter
from pytorch_distributed_tpu_torch.parallel.mesh import AxisGroup, Mesh
from pytorch_distributed_tpu_torch.utils.checkpoint import Shard

MIN_SHARD_ELEMS = 1024


def fsdp_dim(shape, axis_size: int, min_shard_elems: int = MIN_SHARD_ELEMS) -> Optional[int]:
    """The dimension to shard: the largest one ``axis_size`` divides (the
    first of equals); None (replicate) for scalars, leaves under
    ``min_shard_elems`` elements and shapes with no divisible dimension."""
    if int(np.prod(shape, initial=1)) < min_shard_elems:
        return None
    best = None
    for d, n in enumerate(shape):
        if n % axis_size == 0 and (best is None or n > shape[best]):
            best = d
    return best


def _set_param(model: torch.nn.Module, name: str, value: torch.nn.Parameter) -> None:
    owner, _, attr = name.rpartition(".")
    setattr(model.get_submodule(owner) if owner else model, attr, value)


def shard_state(state, mesh: Mesh, members: Optional[Container[str]] = None):
    """ZeRO-3 storage for ``state`` (a ``TrainState`` whose model holds the
    whole parameters, the same on every rank, and whose optimizer has no
    state yet): every parameter that ``fsdp_dim`` shards over the mesh's
    data axis, and that is in ``members`` when given, is replaced by this
    rank's part, a new ``nn.Parameter``, in the model and the optimizer;
    ``state.layout`` records each part's ``Shard``, its writer the data
    replica's rank at seq 0, model 0. Returns ``state``."""
    axis = mesh.data
    opt = state.optimizer
    if any(opt.state.values()):
        raise ValueError("shard the state before its first step: the optimizer has state")
    owners = tuple(mesh.rank_of(data=i) for i in range(axis.size))
    swapped = {}
    for name, p in list(state.model.named_parameters()):
        d = fsdp_dim(tuple(p.shape), axis.size)
        if d is None or (members is not None and name not in members):
            continue
        shard = Shard(tuple(p.shape), d, axis.index, owners)
        local = torch.nn.Parameter(
            shard.take(p.detach()).clone(memory_format=torch.contiguous_format),
            requires_grad=p.requires_grad)
        _set_param(state.model, name, local)
        state.layout[name] = shard
        swapped[id(p)] = local
    for group in opt.param_groups:
        group["params"] = [swapped.get(id(p), p) for p in group["params"]]
    return state


def all_gather_dim(t: torch.Tensor, dim: int, axis: AxisGroup) -> torch.Tensor:
    """The parts of ``axis``'s ranks (this rank's ``t``) concatenated along
    ``dim``, in rank order."""
    n = axis.size
    if n == 1:
        return t
    parts = all_gather(t, axis.group)
    if dim == 0:
        return parts.reshape((n * t.shape[0],) + tuple(t.shape[1:]))
    return torch.cat(parts.unbind(0), dim)


def reduce_scatter_dim(g: torch.Tensor, dim: int, axis: AxisGroup) -> torch.Tensor:
    """This rank's part along ``dim`` of the sum of ``g`` over ``axis``."""
    n = axis.size
    if n == 1:
        return g
    shape = tuple(g.shape)
    chunks = g.reshape(shape[:dim] + (n, shape[dim] // n) + shape[dim + 1:]).movedim(dim, 0)
    return reduce_scatter(chunks, axis.group)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, dim, axis, mean):
        ctx.dim, ctx.axis, ctx.mean = dim, axis, mean
        return all_gather_dim(part.detach(), dim, axis)

    @staticmethod
    def backward(ctx, g):
        part = reduce_scatter_dim(g.contiguous(), ctx.dim, ctx.axis)
        if ctx.mean:
            part = part / ctx.axis.size
        return part, None, None, None


def zero_parts(layout: Dict[str, Shard]) -> Dict[str, Shard]:
    """The ZeRO parts of ``layout``: its shards over the data axis (a
    tensor-parallel or pipeline part, on the model axis, stays local)."""
    return {name: sh for name, sh in layout.items() if sh.axis == "data"}


def gather_params(model: torch.nn.Module, layout: Dict[str, Shard], axis: AxisGroup,
                  mean: bool = True) -> Dict[str, torch.Tensor]:
    """The whole value of every ZeRO part in ``layout`` (gathered over
    ``axis``, differentiable: the gradient of each comes back to its part
    reduce-scattered, divided by the axis's size when ``mean``), to pass
    to ``torch.func.functional_call``; parts on other axes stay as they
    are."""
    params = dict(model.named_parameters())
    return {name: _Gather.apply(params[name], shard.dim, axis, mean)
            for name, shard in zero_parts(layout).items()}


def call_with(model: torch.nn.Module, full: Dict[str, torch.Tensor], *args, **kw):
    """``model(*args, **kw)`` on the whole leaves ``full`` (``gather_params``'s)
    in place of the model's parts, when there are any."""
    if not full:
        return model(*args, **kw)
    return torch.func.functional_call(model, full, args, kw)


def global_leaves(tensors: Dict[str, torch.Tensor], layout: Dict[str, Shard],
                  mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``tensors`` (a state dict, or gradients by parameter name) whole, on
    the host: each one ``layout`` names gathered over its axis (the data
    axis for a ZeRO part; the model axis for a pipeline stage's stacked
    slice or a tensor-parallel part). Every rank of the axes takes part."""
    out = {}
    for k, v in tensors.items():
        sh = layout.get(k)
        if sh is not None:
            axis = getattr(mesh, sh.axis)
            b = sh.block(v.detach()).contiguous()
            v = sh.assemble(all_gather(b, axis.group) if axis.size > 1 else b[None])
        out[k] = v.detach().cpu().clone()
    return out


def state_bytes(state) -> int:
    """This rank's bytes of parameters and optimizer state."""
    n = sum(p.numel() * p.element_size() for p in state.model.parameters())
    for per in state.optimizer.state.values():
        n += sum(v.numel() * v.element_size() for v in per.values()
                 if isinstance(v, torch.Tensor))
    return n


__all__ = ["MIN_SHARD_ELEMS", "all_gather_dim", "call_with", "fsdp_dim", "gather_params",
           "global_leaves", "reduce_scatter_dim", "shard_state", "state_bytes", "zero_parts"]
