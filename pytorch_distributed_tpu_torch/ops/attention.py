"""Attention in plain PyTorch: ``dense_attention`` and
``blockwise_attention`` for training, and paged attention's plain version
and spelling switch for serving.

``paged_attention_reference`` is the dense-gather spelling of
``pytorch_distributed_tpu/ops/attention.py:paged_attention``: take each
request's block chain out of the pool into a logical
``[B, W·block_len, H_kv, D]`` sequence, then attend in fp32 with the
frontier mask ``k_pos <= q_pos``. It is the plain version every kernel of
``ops.paged_flash`` is held against, and what the kernel wrapper runs for
tensors on the CPU.

Shapes follow the JAX package: q ``[B, C, H, D]``, pools
``[n_blocks, block_len, H_kv, D]``, tables ``[B, W]``, positions
``[B, C]``. Quantized pools (int8 or fp8, ``serving.kv_pool``) come
with scales ``[n_blocks, block_len, H_kv]``: the plain version
dequantizes after the gather and attends in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

NEG_INF = -1e30  # finite additive mask value: NEG_INF - NEG_INF is 0, not nan

GATHER_IMPLS = ("kernel", "dense")


def check_paged_shapes(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       q_positions: torch.Tensor) -> None:
    """Raise on shapes the paged attention functions do not take."""
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(
            f"q must be [B, C, H, D] and pools [n_blocks, block_len, H_kv, "
            f"D]; got q {tuple(q.shape)}, pool {tuple(k_pool.shape)}"
        )
    if v_pool.shape != k_pool.shape:
        raise ValueError(
            f"k_pool {tuple(k_pool.shape)} and v_pool {tuple(v_pool.shape)} "
            "differ"
        )
    b, c, h, d = q.shape
    h_kv = k_pool.shape[2]
    if k_pool.shape[3] != d:
        raise ValueError(f"pool head dim {k_pool.shape[3]} != query head dim {d}")
    if h % h_kv:
        raise ValueError(f"query heads {h} not a multiple of pool KV heads {h_kv}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(
            f"block_tables must be [B={b}, W], got {tuple(block_tables.shape)}"
        )
    if tuple(q_positions.shape) != (b, c):
        raise ValueError(
            f"q_positions must be [B={b}, C={c}], got {tuple(q_positions.shape)}"
        )


def check_scales(k_pool: torch.Tensor, k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor]) -> None:
    """Raise unless quantized pools come with both scales and float pools
    with none."""
    from pytorch_distributed_tpu_torch.serving.kv_pool import is_quantized_pool

    quantized = is_quantized_pool(k_pool.dtype)
    if quantized != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError(
            "quantized (int8/fp8) pools need k_scale and v_scale and float pools "
            f"must not pass them (pool dtype {k_pool.dtype}, k_scale "
            f"{'set' if k_scale is not None else 'None'}, v_scale "
            f"{'set' if v_scale is not None else 'None'})")
    if quantized and tuple(k_scale.shape) != tuple(k_pool.shape[:3]):
        raise ValueError(f"scales must be {tuple(k_pool.shape[:3])}, got "
                         f"{tuple(k_scale.shape)}")


def paged_attention_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    q_positions: torch.Tensor,
    *,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode/chunk attention against a block-pooled KV cache, by a dense
    gather (``ops/attention.py:152-290`` of the JAX package).

    Query head ``h`` reads narrow KV head ``h // (H // H_kv)`` (GQA).
    Table entries past a request's allocation point at the trash block;
    their logical positions lie past every query position, so the mask
    hides them. A row whose every key is masked (a padding row with
    position -1) comes out 0: ``p * allowed`` after the softmax. Quantized
    pools dequantize after the gather, ``q · scale_factors(scales)``.

    Returns ``[B, C, H, D]`` in q's dtype; logits, softmax and PV in fp32.
    """
    check_paged_shapes(q, k_pool, v_pool, block_tables, q_positions)
    check_scales(k_pool, k_scale, v_scale)
    b, c, h, d = q.shape
    _, block_len, h_kv, _ = k_pool.shape
    group = h // h_kv
    w = block_tables.shape[1]
    scale = scale if scale is not None else d ** -0.5
    idx = block_tables.long()
    kg = k_pool[idx].reshape(b, w * block_len, h_kv, d).float()
    vg = v_pool[idx].reshape(b, w * block_len, h_kv, d).float()
    if k_scale is not None:
        from pytorch_distributed_tpu_torch.serving.kv_pool import scale_factors

        kg = kg * scale_factors(k_scale)[idx].reshape(b, w * block_len, h_kv, 1)
        vg = vg * scale_factors(v_scale)[idx].reshape(b, w * block_len, h_kv, 1)
    qg = (q.float() * scale).reshape(b, c, h_kv, group, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kg)  # [B, H_kv, G, C, W*bl]
    k_pos = torch.arange(w * block_len, device=q.device)
    allowed = (k_pos[None, None, None, None, :]
               <= q_positions.to(q.device).long()[:, None, None, :, None])
    s = s.masked_fill(~allowed, NEG_INF)
    p = torch.softmax(s, dim=-1) * allowed
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, vg)
    return out.reshape(b, c, h, d).to(q.dtype)


def causal_mask(lq: int, lk: int, q_offset: int, k_offset: int,
                device) -> torch.Tensor:
    """``[Lq, Lk]`` bool: key j visible to query i iff
    ``k_offset + j <= q_offset + i``."""
    q_pos = q_offset + torch.arange(lq, device=device)
    k_pos = k_offset + torch.arange(lk, device=device)
    return k_pos[None, :] <= q_pos[:, None]


def dense_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
) -> torch.Tensor:
    """O(L²) attention on ``[B, L, H, D]`` (``ops/attention.py:122`` of the
    JAX package): fp32 logits of the input-dtype operands, scaled after the
    product; the causal mask from the offsets; a fully masked row comes out
    0 (``probs * mask``), not uniform; PV in fp32, the output in q's dtype.
    It is the ``attention="dense"`` training path."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        allowed = causal_mask(q.shape[1], k.shape[1], q_offset, k_offset, q.device)
        logits = logits.masked_fill(~allowed, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if causal:
        probs = probs * allowed
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_size: int = 512,
    q_offset: int = 0,
    k_offset: int = 0,
) -> torch.Tensor:
    """Memory-efficient attention (``ops/attention.py:293`` of the JAX
    package): scan the K/V blocks of ``min(block_size, Lk)`` keys, each
    folded into an fp32 online-softmax state by ``attend_block`` (the JAX
    ``attend_block``:67 recurrence, which the plain ring folds too). Under
    autograd each block's fold runs under ``torch.utils.checkpoint``, as
    JAX's scan body under ``jax.checkpoint``: the backward recomputes a
    block's logits instead of keeping them. Returns ``[B, Lq, H, D]`` in q's
    dtype; a fully masked row comes out 0."""
    from pytorch_distributed_tpu_torch.parallel.sequence import SoftmaxState, attend_block

    scale = scale if scale is not None else q.shape[-1] ** -0.5
    b, lq, h, d = q.shape
    lk = k.shape[1]
    bs = min(block_size, lk)
    if lk % bs:
        raise ValueError(f"kv length {lk} not divisible by block_size {bs}")

    def fold(o, m, l, kb, vb, k_off):
        st = attend_block(SoftmaxState(o, m, l), q, kb, vb, scale=scale, causal=causal,
                          q_offset=q_offset, k_offset=k_off)
        return tuple(st)

    state = tuple(SoftmaxState.zero(b, lq, h, d, q.device))
    for i in range(lk // bs):
        kb, vb = k[:, i * bs:(i + 1) * bs], v[:, i * bs:(i + 1) * bs]
        if torch.is_grad_enabled():
            state = torch.utils.checkpoint.checkpoint(fold, *state, kb, vb, k_offset + i * bs,
                                                      use_reentrant=False)
        else:
            state = fold(*state, kb, vb, k_offset + i * bs)
    return SoftmaxState(*state).finalize(q.dtype)


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    q_positions: torch.Tensor,
    *,
    scale: Optional[float] = None,
    gather_impl: str = "kernel",
    split_s: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The serving read path: ``gather_impl="kernel"`` runs the CUDA
    kernels of ``ops.paged_flash`` (the counterpart of the JAX package's
    ``"pallas"``), ``"dense"`` the plain version above, wherever the
    tensors lie. ``split_s`` is the flash-decoding worker count of the
    kernel spelling (None = ``auto_split_s``); the dense spelling has no
    chain sweep to split and ignores it. ``k_scale``/``v_scale``: the
    scales of quantized pools, required for them and refused for float
    pools."""
    if gather_impl == "dense":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         q_positions, scale=scale,
                                         k_scale=k_scale, v_scale=v_scale)
    if gather_impl == "kernel":
        from pytorch_distributed_tpu_torch.ops.paged_flash import (
            paged_flash_attention,
        )

        return paged_flash_attention(q, k_pool, v_pool, block_tables,
                                     q_positions, scale=scale, split_s=split_s,
                                     k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"gather_impl {gather_impl!r} must be one of {GATHER_IMPLS}")
