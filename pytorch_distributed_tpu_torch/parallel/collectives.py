"""Collectives over ``torch.distributed``
(``pytorch_distributed_tpu/parallel/collectives.py``).

- ``all_reduce_`` and ``all_reduce_grads``: the sum all-reduce of one
  tensor, and of a list of gradients flattened into buckets (the JAX step's
  ``psum`` of the gradient tree, DDP's bucketed reducer); ``pmean_``
  divides the bucketed sums by the group's size once (``pmean``), ``pmin``
  is the min of a flag (the finite gates' ``pmin``);
- ``psum``: a differentiable sum over a group for sync-BN, whose backward
  sums the cotangents over the group, as JAX transposes ``psum`` under
  ``shard_map`` (every rank's loss depends on every rank's input);
- ``broadcast_from_primary``: every rank gets rank 0's tensors;
- ``start_ring_permute`` and ``ring_permute``: the ring's collective
  permutation (JAX's ``ppermute`` with ``perm = [(i, (i + 1) % s)]``): send
  to ``(r + 1) % s`` and receive from ``(r - 1) % s`` of the group, posted
  with ``dist.batch_isend_irecv`` so that a caller can compute while they
  travel; ``ring_permute`` is differentiable, its backward the inverse
  permute.

gloo reads host memory. On a gloo group, CUDA tensors are staged
explicitly: copied to the CPU, sent or reduced, and copied back. Only a
caller that built a gloo group for CUDA tensors gets that path (on one card
shared by several ranks, where NCCL refuses); with a card per rank the
caller uses NCCL, which reads the tensors where they are.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2 ** 20  # DDP's default bucket


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    """Ranks in ``group`` (None = the whole job); 1 without a process group."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _staged(group: Optional[dist.ProcessGroup], t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM,
                group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` (None = every rank)."""
    if group_size(group) == 1:
        return t
    if _staged(group, t):
        host = t.cpu()
        dist.all_reduce(host, op, group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op, group)
    return t


def pmin(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The min of ``t`` (e.g. an int flag) over ``group``, in place."""
    return all_reduce_(t, dist.ReduceOp.MIN, group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        # a new tensor: the input stays as autograd saved it
        return all_reduce_(t.detach().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.detach().clone(), group=ctx.group), None


def psum(t: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``group``; its backward sums the
    cotangents over the group. Every rank must reach it, and its backward,
    in the same order."""
    if group is None or group_size(group) == 1:
        return t
    return _PSum.apply(t, group)


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int) -> List[List[torch.Tensor]]:
    out: List[List[torch.Tensor]] = []
    size, key = 0, None
    for t in tensors:
        n = t.numel() * t.element_size()
        if not out or (t.dtype, t.device) != key or size + n > bucket_bytes:
            out.append([])
            size, key = 0, (t.dtype, t.device)
        out[-1].append(t)
        size += n
    return out


def all_reduce_grads(grads: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup] = None,
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Sum every gradient over ``group`` in place, in buckets of about
    ``bucket_bytes`` of one dtype, each flattened into one all-reduce."""
    if group_size(group) == 1:
        return
    for bucket in _buckets(grads, bucket_bytes):
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in bucket]), group=group)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def pmean_(tensors: Sequence[torch.Tensor],
           group: Optional[dist.ProcessGroup] = None) -> None:
    """Every tensor in place: its mean over ``group`` (bucketed sums, then
    one division each)."""
    n = group_size(group)
    if n == 1:
        return
    all_reduce_grads(tensors, group)
    torch._foreach_div_(list(tensors), float(n))


def broadcast_from_primary(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite ``tensors`` in place with rank 0's (DDP's parameter
    broadcast at construction, ``restnet_ddp.py:99``)."""
    if group_size(None) == 1:
        return
    for t in tensors:
        if _staged(None, t):
            host = t.cpu()
            dist.broadcast(host, 0)
            t.copy_(host)
        else:
            dist.broadcast(t, 0)


class PendingPermute:
    """Tensors on their way round the ring; ``wait`` returns them where the
    caller's tensors lay."""

    def __init__(self, works, sent, received, device):
        self._works, self._sent, self._received = works, sent, received
        self._device = device

    def wait(self) -> List[torch.Tensor]:
        for w in self._works:
            w.wait()
        self._sent = None
        return [r.to(self._device) for r in self._received]


def start_ring_permute(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup],
                       reverse: bool = False) -> PendingPermute:
    """Post the sends of ``tensors`` to the next rank of ``group`` and the
    receives from the previous one (``reverse``: the other way round).
    A group of one rank (or None) hands the tensors back as they are."""
    tensors = [t.detach() for t in tensors]
    if group is None or group_size(group) == 1:
        return PendingPermute([], tensors, tensors, tensors[0].device)
    s, r = dist.get_world_size(group), dist.get_rank(group)
    dst, src = ((r - 1) % s, (r + 1) % s) if reverse else ((r + 1) % s, (r - 1) % s)
    staged = _staged(group, tensors[0])
    sent = [t.cpu() if staged else t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in sent]
    ops = ([dist.P2POp(dist.isend, t, dist.get_global_rank(group, dst), group) for t in sent]
           + [dist.P2POp(dist.irecv, t, dist.get_global_rank(group, src), group)
              for t in received])
    return PendingPermute(dist.batch_isend_irecv(ops), sent, received, tensors[0].device)


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, reverse, *tensors):
        ctx.group, ctx.reverse = group, reverse
        return tuple(start_ring_permute(tensors, group, reverse).wait())

    @staticmethod
    def backward(ctx, *grads):
        back = start_ring_permute(grads, ctx.group, not ctx.reverse).wait()
        return (None, None, *back)


def ring_permute(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup],
                 reverse: bool = False) -> List[torch.Tensor]:
    """Differentiable ring permute: the tensors of rank ``r - 1`` (``r + 1``
    with ``reverse``); the gradient travels back the other way."""
    if group is None or group_size(group) == 1:
        return list(tensors)
    return list(_RingPermute.apply(group, reverse, *tensors))
