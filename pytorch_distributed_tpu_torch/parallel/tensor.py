"""Tensor parallelism's collectives and partition rules
(``pytorch_distributed_tpu/parallel/tensor.py``).

Megatron tensor parallelism splits a "column-parallel" layer's weight on
its output features (each model rank computes a slice of the features)
and a "row-parallel" layer's on its input features (each rank computes a
partial sum that one all-reduce completes). Three ``autograd.Function``s
over the model axis's group make the gradients right by construction:

- ``tp_copy`` ("f"): identity forward on a replicated activation entering
  a column-parallel layer; its backward sums the ranks' partial
  cotangents, so everything upstream (embeddings, LayerNorms) receives the
  whole gradient and the replicated parameters need no collective of
  their own over the model axis;
- ``tp_reduce`` ("g"): the sum forward that completes a row-parallel
  layer; identity backward (the cotangent is already replicated; a plain
  sum's transpose would scale it by the axis's size);
- ``tp_all_gather``: the ranks' slices concatenated along a dim, for
  replicated consumers (the vocab-parallel logits); its backward takes
  this rank's slice of the replicated cotangent (a reduce-scatter would
  hand each rank T times its gradient).

A row-parallel layer adds no bias before ``tp_reduce`` (it would be summed
T times); the transformer's ``proj`` and ``mlp_down`` have none. Each
collective is ``parallel.collectives``': NCCL's own with a card a rank, and
on a gloo group (ranks sharing one card) staged through the host. An axis
of size 1 makes each of them the identity.

``match_partition_rules`` assigns each parameter name the first rule whose
pattern it contains (``re.search``), as the JAX function does over flax
paths. The JAX package's ``opt_state_specs`` has no counterpart: a torch
optimizer keeps each parameter's state beside the parameter, so the
moments of a model rank's part are that part's shape and follow it.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from pytorch_distributed_tpu_torch.parallel.collectives import all_gather, all_reduce_
from pytorch_distributed_tpu_torch.parallel.mesh import AxisGroup


def _summed(t: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """A new tensor: ``t``'s sum over the axis's ranks."""
    return all_reduce_(t.detach().clone(memory_format=torch.contiguous_format),
                       group=axis.group)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _summed(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.local = axis, dim, x.shape[dim]
        parts = all_gather(x.detach(), axis.group)  # [T, ...]
        return torch.cat(parts.unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.local, ctx.local), None, None


def tp_copy(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Identity forward, sum over ``axis`` backward (enter a
    column-parallel region)."""
    return x if axis.size == 1 else _Copy.apply(x, axis)


def tp_reduce(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Sum over ``axis`` forward, identity backward (leave a row-parallel
    region)."""
    return x if axis.size == 1 else _Reduce.apply(x, axis)


def tp_all_gather(x: torch.Tensor, axis: AxisGroup, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in axis order, for
    consumers replicated over ``axis``; backward: this rank's slice."""
    if axis.size == 1:
        return x
    return _AllGather.apply(x, axis, dim % x.dim())


def match_partition_rules(rules: Sequence[Tuple], names: Iterable[str],
                          default=None) -> Dict[str, Optional[tuple]]:
    """Each name's rule: the first of ``rules`` (tuples whose first item
    is a regular expression) whose pattern ``re.search`` finds in it, else
    ``default``."""
    out = {}
    for name in names:
        out[name] = next((r for r in rules if re.search(r[0], name)), default)
    return out


__all__ = ["match_partition_rules", "tp_all_gather", "tp_copy", "tp_reduce"]
