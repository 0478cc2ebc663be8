"""Ring attention through the flash kernels (``pytorch_distributed_tpu/ops/ring_flash.py``).

The schedule of ``parallel.sequence.ring_attention`` with the CUDA flash
kernels doing each visit's work, made exact by one ``autograd.Function``
over the whole ring:

Forward (one pass round the ring): each visiting K/V shard goes through the
flash forward kernel, which gives its block output and row LSE; blocks
merge by the LSE combine in fp32 ((m, l, acc) running state). Causal runs
use the ring positions: a shard from a later position is skipped, an
earlier one is fully visible (the non-causal kernel), and the rank's own
shard runs the causal kernel. O is rounded to q's dtype once, at the end,
and the global row LSE is kept for the backward.

Backward (a second pass): with the final O and the global LSE, each visit's
(dQ share, dK, dV) is independent (the FlashAttention-2 decomposition):
Δ = rowsum(dO ⊙ O) once, then per visit the fused backward kernel
(``bwd_impl="fused"``) or the split pair (``"split"``, TPU kernel 6) with
the global LSE. dQ accumulates locally in fp32; the fp32 dK/dV
accumulators travel with their shard, and one last rotation takes them
home.

Zigzag (causal only): rank r holds chunks (r, 2s-1-r) of the 2s-chunk
sequence. Of the four (q chunk, kv chunk) pairs of a visit, (hi, lo) is
always visible and (lo, hi) never; (lo, lo) and (hi, hi) are the diagonal,
fully visible or skipped by the ring positions. Every rank then runs about
two chunk kernels a visit.

The next visit's K/V permute is posted before the current visit's kernels
run, so that over NCCL the transfer can overlap them (over gloo the host
staging copies wait for the card first). The port's kernels take any
length and need no blocks, so the JAX ``_fit_block`` and the model's block
choice have no counterpart here.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from pytorch_distributed_tpu_torch.ops.attention import NEG_INF
from pytorch_distributed_tpu_torch.ops.flash_attention import (
    BWD_IMPLS,
    compute_delta,
    flash_backward,
    flash_forward,
)
from pytorch_distributed_tpu_torch.parallel.collectives import start_ring_permute
from pytorch_distributed_tpu_torch.parallel.mesh import AxisGroup, as_axis
from pytorch_distributed_tpu_torch.parallel.sequence import LAYOUTS


class _State:
    """The fp32 merge state of one run of query rows: m, l ``[B, H, L]``
    and acc ``[B, L, H, D]``."""

    def __init__(self, q: torch.Tensor):
        b, lq, h, d = q.shape
        self.m = torch.full((b, h, lq), NEG_INF, device=q.device)
        self.l = torch.zeros((b, h, lq), device=q.device)
        self.acc = torch.zeros((b, lq, h, d), device=q.device)

    def merge(self, o: torch.Tensor, lse: torch.Tensor) -> None:
        m_new = torch.maximum(self.m, lse)
        corr, w = torch.exp(self.m - m_new), torch.exp(lse - m_new)
        self.l = self.l * corr + w
        self.acc = (self.acc * corr.transpose(1, 2)[..., None]
                    + o.float() * w.transpose(1, 2)[..., None])
        self.m = m_new

    def finalize(self, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        l_safe = self.l.clamp_min(1e-37)
        o = (self.acc / l_safe.transpose(1, 2)[..., None]).to(dtype)
        return o, torch.where(self.l > 0, self.m + torch.log(l_safe), NEG_INF)


def _row_parts(layout: str, lq: int) -> List[slice]:
    """The runs of local query (and key) rows the kernels take: the whole
    shard, or its two zigzag chunks."""
    if layout == "contiguous":
        return [slice(None)]
    return [slice(0, lq // 2), slice(lq // 2, None)]


def _visits(layout: str, causal: bool, my: int, src: int) -> List[Tuple[int, int, bool]]:
    """The kernel calls of one visit from rank ``src``: ``(q part, kv part,
    causal)``, parts indexing ``_row_parts``."""
    if layout == "contiguous":
        if causal and src > my:
            return []
        return [(0, 0, causal and src == my)]
    out = []
    if src <= my:
        out.append((0, 0, src == my))  # (lo, lo)
    out.append((1, 0, False))  # (hi, lo)
    if src >= my:
        out.append((1, 1, src == my))  # (hi, hi)
    return out


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, layout: str, bwd_impl: str,
                ax: AxisGroup):
        s, my = ax.size, ax.index
        parts = _row_parts(layout, q.shape[1])
        states = [_State(q[:, p]) for p in parts]
        kv = [k, v]
        for step in range(s):
            pending = start_ring_permute(kv, ax.group) if step < s - 1 else None
            for qi, ki, diag in _visits(layout, causal, my, (my - step) % s):
                o, lse = flash_forward(q[:, parts[qi]], kv[0][:, parts[ki]],
                                       kv[1][:, parts[ki]], causal=diag, scale=scale)
                states[qi].merge(o, lse)
            if pending is not None:
                kv = pending.wait()
        outs = [st.finalize(q.dtype) for st in states]
        o = torch.cat([x[0] for x in outs], dim=1)
        lse = torch.cat([x[1] for x in outs], dim=2)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, layout, bwd_impl, ax)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, layout, bwd_impl, ax = ctx.args
        s, my = ax.size, ax.index
        parts = _row_parts(layout, q.shape[1])
        do = do.to(q.dtype)
        delta = compute_delta(do, o)  # the same for every visit: once
        dq = torch.zeros(q.shape, device=q.device)
        dkv = [torch.zeros(k.shape, device=k.device), torch.zeros(v.shape, device=v.device)]
        kv = [k, v]
        for step in range(s):
            pending = start_ring_permute(kv, ax.group) if step < s - 1 else None
            for qi, ki, diag in _visits(layout, causal, my, (my - step) % s):
                rq, rk = parts[qi], parts[ki]
                g = flash_backward(q[:, rq], kv[0][:, rk], kv[1][:, rk], o[:, rq],
                                   lse[:, :, rq], do[:, rq], causal=diag, scale=scale,
                                   bwd_impl=bwd_impl, delta=delta[:, :, rq])
                dq[:, rq] += g[0].float()
                dkv[0][:, rk] += g[1].float()
                dkv[1][:, rk] += g[2].float()
            if pending is not None:
                kv = pending.wait()
            # the accumulators travel with their shard; after the last visit
            # this rotation takes them home
            dkv = start_ring_permute(dkv, ax.group).wait()
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None)


def check_ring_args(lq: int, lk: int, causal: bool, layout: str, bwd_impl: str) -> None:
    """The JAX ring's checks (``ring_flash.py``:520-538)."""
    if lq != lk:
        raise ValueError(f"ring flash needs equal Q/KV shard lengths, got {lq} vs {lk}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "zigzag":
        if not causal:
            raise ValueError("zigzag layout only changes causal scheduling; use "
                             "layout='contiguous' for non-causal attention")
        if lq % 2:
            raise ValueError(f"zigzag needs an even shard length, got {lq}")
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl {bwd_impl!r} must be 'split' or 'fused'")


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = False, scale: Optional[float] = None,
                         layout: str = "contiguous", bwd_impl: str = "fused",
                         group=None) -> torch.Tensor:
    """Ring attention with the flash kernels per visiting shard:
    ``[B, L_local, H, D]`` shards of a sequence sharded over ``group`` (an
    ``AxisGroup``, a process group, or None for the mesh's ``SEQ_AXIS``),
    contiguously or, with ``layout="zigzag"``, as chunks (r, 2s-1-r)
    (``parallel.sequence.zigzag_shard``). Returns this rank's rows in q's
    dtype. On CUDA tensors every visit launches the kernels; on CPU tensors
    their plain versions run. Shards must have equal lengths, even ones for
    zigzag; the causal structure comes from the ring positions, so there is
    no ``base_offset``."""
    check_ring_args(q.shape[1], k.shape[1], causal, layout, bwd_impl)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    return _RingFlash.apply(q, k, v, bool(causal), scale, layout, bwd_impl, as_axis(group))
