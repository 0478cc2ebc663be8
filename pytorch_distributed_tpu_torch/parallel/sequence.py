"""Ring attention over the ``seq`` group, in plain PyTorch
(``pytorch_distributed_tpu/parallel/sequence.py``).

Each rank holds ``[B, L_local, H, D]`` shards of q, k and v. The K/V shards
travel round the ring (``parallel.collectives.ring_permute``) while every
rank folds the visiting shard into an online-softmax state
(``attend_block``, the JAX ``ops/attention.py:67`` recurrence in fp32).
After s visits each query has seen every key. Autograd differentiates
through the folds and through the permutes, whose backward is the inverse
permute. This is ``attention="ring"`` and the reference the ring over the
flash kernels (``ops.ring_flash``) is held against.

Causal runs skip a visiting shard that lies wholly in the local queries'
future. ``layout="zigzag"`` (causal only) balances the ranks: the global
sequence is cut into 2s chunks and rank r holds chunks (r, 2s-1-r), laid
out by ``zigzag_shard``. A skipped shard stays in the autograd graph with a
zero gradient (``_KeepInGraph``), so that every rank runs the backward of
every permute and none waits for a message that is never sent.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.ops.attention import NEG_INF
from pytorch_distributed_tpu_torch.parallel.collectives import ring_permute
from pytorch_distributed_tpu_torch.parallel.mesh import AxisGroup, as_axis

LAYOUTS = ("contiguous", "zigzag")


def zigzag_order(s: int) -> np.ndarray:
    """Chunk order of the zigzag layout: shard r takes chunks (r, 2s-1-r)."""
    return np.concatenate([[r, 2 * s - 1 - r] for r in range(s)])


def _reorder(x, order, axis: int):
    if isinstance(x, torch.Tensor):
        parts = torch.tensor_split(x, len(order), dim=axis)
        return torch.cat([parts[i] for i in order], dim=axis)
    parts = np.split(x, len(order), axis=axis)
    return np.concatenate([parts[i] for i in order], axis=axis)


def zigzag_shard(x, s: int, axis: int = 1):
    """Reorder a global array (numpy or torch) so that contiguous equal
    sharding over ``s`` ranks delivers the zigzag layout. Inverse:
    ``zigzag_unshard``."""
    if x.shape[axis] % (2 * s):
        raise ValueError(f"length {x.shape[axis]} not divisible by 2*{s} chunks")
    return _reorder(x, zigzag_order(s), axis)


def zigzag_unshard(x, s: int, axis: int = 1):
    """Inverse of ``zigzag_shard``."""
    return _reorder(x, np.argsort(zigzag_order(s)), axis)


def zigzag_positions(lq: int, s: int, r: int) -> torch.Tensor:
    """Absolute positions of the ``lq`` tokens of zigzag shard ``r``
    (``train/lm.py`` ``_shard_positions``:345)."""
    c = lq // 2
    return torch.cat([r * c + torch.arange(c), (2 * s - 1 - r) * c + torch.arange(c)])


class SoftmaxState(NamedTuple):
    """Online-softmax accumulator, fp32: ``o [B, Lq, H, D]`` un-normalised,
    ``m`` and ``l`` ``[B, Lq, H]``."""

    o: torch.Tensor
    m: torch.Tensor
    l: torch.Tensor

    @classmethod
    def zero(cls, b: int, lq: int, h: int, d: int, device) -> "SoftmaxState":
        return cls(torch.zeros((b, lq, h, d), device=device),
                   torch.full((b, lq, h), NEG_INF, device=device),
                   torch.zeros((b, lq, h), device=device))

    def finalize(self, dtype) -> torch.Tensor:
        """Normalise; rows that saw only masked keys give zeros."""
        return (self.o / self.l.clamp_min(1e-37)[..., None]).to(dtype)


def attend_block(state: SoftmaxState, q, k, v, *, scale: float, causal: bool,
                 q_offset: int = 0, k_offset: int = 0) -> SoftmaxState:
    """Fold one K/V block into the state: fp32 logits of the input-dtype
    operands, scaled after the product, the causal mask from the offsets,
    p zeroed where masked, PV in fp32."""
    lq, lk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    allowed = None
    if causal:
        q_pos = q_offset + torch.arange(lq, device=q.device)
        k_pos = k_offset + torch.arange(lk, device=q.device)
        allowed = k_pos[None, :] <= q_pos[:, None]
        logits = logits.masked_fill(~allowed, NEG_INF)
    m_new = torch.maximum(state.m, logits.amax(dim=-1).transpose(1, 2))
    correction = torch.exp(state.m - m_new)
    p = torch.exp(logits - m_new.transpose(1, 2)[..., None])
    if allowed is not None:
        p = p * allowed
    l_block = p.sum(dim=-1).transpose(1, 2)
    o_block = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return SoftmaxState(state.o * correction[..., None] + o_block, m_new,
                        state.l * correction + l_block)


class _KeepInGraph(torch.autograd.Function):
    """``x`` unchanged, with ``k`` and ``v`` as inputs of zero gradient: a
    visiting shard that this rank skips still leads back to the permute
    that brought it."""

    @staticmethod
    def forward(ctx, x, k, v):
        ctx.kv = [(t.shape, t.dtype, t.device) for t in (k, v)]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gx):
        return (gx, *(torch.zeros(s, dtype=dt, device=dev) for s, dt, dev in ctx.kv))


def _skip(state: SoftmaxState, k, v) -> SoftmaxState:
    return state._replace(o=_KeepInGraph.apply(state.o, k, v))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group=None, causal: bool = False,
                   scale: Optional[float] = None, base_offset: int = 0,
                   layout: str = "contiguous") -> torch.Tensor:
    """This rank's rows of softmax(QKᵀ·scale)V over the sequence sharded on
    ``group`` (default: the mesh's ``SEQ_AXIS``), ``[B, L_local, H, D]`` in
    q's dtype; ``group`` is an ``AxisGroup`` or a process group. Contiguous:
    shard i holds tokens ``[base_offset + i·L, base_offset + (i+1)·L)``.
    Zigzag: chunks (i, 2s-1-i), causal only."""
    ax = as_axis(group)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if layout == "zigzag":
        if not causal:
            raise ValueError("zigzag layout only changes causal scheduling; use "
                             "layout='contiguous' for non-causal attention")
        return _ring_attention_zigzag(q, k, v, ax, scale, base_offset)
    if layout != "contiguous":
        raise ValueError(f"unknown layout {layout!r}")
    s, my = ax.size, ax.index
    b, lq, h, d = q.shape
    lk = k.shape[1]
    state = SoftmaxState.zero(b, lq, h, d, q.device)
    k_cur, v_cur = k, v
    for step in range(s):
        src = (my - step) % s  # the visiting shard's home rank
        if causal and lk == lq and src > my:
            state = _skip(state, k_cur, v_cur)  # wholly in the future
        else:
            state = attend_block(state, q, k_cur, v_cur, scale=scale, causal=causal,
                                 q_offset=base_offset + my * lq,
                                 k_offset=base_offset + src * lk)
        if step < s - 1:
            k_cur, v_cur = ring_permute([k_cur, v_cur], ax.group)
    return state.finalize(q.dtype)


def _ring_attention_zigzag(q, k, v, ax: AxisGroup, scale: float,
                           base_offset: int) -> torch.Tensor:
    """Causal ring attention on the zigzag layout. Of the four (q chunk,
    kv chunk) pairs of a visit from ``src``: (lo, lo) runs unless
    src > my, (hi, lo) always, (hi, hi) unless src < my, and (lo, hi) never
    (``_ring_attention_zigzag``:193 of the JAX package)."""
    s, my = ax.size, ax.index
    b, lq, h, d = q.shape
    if lq % 2 or k.shape[1] != lq:
        raise ValueError(f"zigzag needs equal, even-length shards; got q {lq}, "
                         f"k {k.shape[1]}")
    c = lq // 2
    q_lo, q_hi = q[:, :c], q[:, c:]
    lo_off, hi_off = base_offset + my * c, base_offset + (2 * s - 1 - my) * c
    st_lo = SoftmaxState.zero(b, c, h, d, q.device)
    st_hi = SoftmaxState.zero(b, c, h, d, q.device)
    k_cur, v_cur = k, v
    for step in range(s):
        src = (my - step) % s
        k_lo, k_hi, v_lo, v_hi = k_cur[:, :c], k_cur[:, c:], v_cur[:, :c], v_cur[:, c:]
        src_lo, src_hi = base_offset + src * c, base_offset + (2 * s - 1 - src) * c
        if src > my:
            st_lo = _skip(st_lo, k_lo, v_lo)
        else:
            st_lo = attend_block(st_lo, q_lo, k_lo, v_lo, scale=scale, causal=True,
                                 q_offset=lo_off, k_offset=src_lo)
        st_hi = attend_block(st_hi, q_hi, k_lo, v_lo, scale=scale, causal=True,
                             q_offset=hi_off, k_offset=src_lo)
        if src < my:
            st_hi = _skip(st_hi, k_hi, v_hi)
        else:
            st_hi = attend_block(st_hi, q_hi, k_hi, v_hi, scale=scale, causal=True,
                                 q_offset=hi_off, k_offset=src_hi)
        if step < s - 1:
            k_cur, v_cur = ring_permute([k_cur, v_cur], ax.group)
    return torch.cat([st_lo.finalize(q.dtype), st_hi.finalize(q.dtype)], dim=1)
