"""Causal transformer LM for paged serving, in PyTorch.

The port of ``pytorch_distributed_tpu/models/transformer.py`` along its
paged-serving path: learned token and position embeddings, pre-LN blocks
(attention, GELU MLP), a final LayerNorm and an untied LM head with fp32
logits. Each layer's attention writes the chunk's K/V into the block pool
and attends through the block tables (``ops.attention.paged_attention``).
One forward serves chunked prefill (C = chunk) and decode (C = 1).

What must match the flax module exactly:

- LayerNorm has eps 1e-6 and computes and returns fp32;
- ``nn.gelu`` is the tanh approximation;
- ``proj``, ``mlp_down`` and ``lm_head`` have no bias;
- embeddings, the residual stream and every Dense output are in
  ``config.dtype``; a LayerNorm's fp32 output is cast to it at the next
  Dense, and the logits are the head's output cast to fp32.

The ring, blockwise, flash, MoE, tensor-parallel, RoPE, dropout and
GQA-model branches of the JAX module are not ported yet, nor are their
config fields.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.ops.attention import (
    GATHER_IMPLS,
    paged_attention,
)

LN_EPS = 1e-6  # flax nn.LayerNorm's default

#: one layer's KV pools: (key, value), each [n_blocks, block_len, H_kv, D]
LayerCache = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    attention: str = "dense"  # serving checks it (models.generate)
    # paged read path: "kernel" runs the CUDA kernels of ops/paged_flash.py
    # (the JAX package's "pallas"), "dense" the plain PyTorch version
    gather_impl: str = "kernel"
    # flash-decoding workers: None = auto (ops.paged_flash.auto_split_s),
    # 1 = single sweep, S > 1 forced
    split_s: Optional[int] = None

    def __post_init__(self):
        if self.embed_dim % self.num_heads:
            raise ValueError(
                f"embed_dim {self.embed_dim} not divisible by num_heads "
                f"{self.num_heads}")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {self.dtype}")
        if self.gather_impl not in GATHER_IMPLS:
            raise ValueError(
                f"gather_impl {self.gather_impl!r} must be one of {GATHER_IMPLS}")
        if self.split_s is not None and (
                not isinstance(self.split_s, int) or self.split_s < 1):
            raise ValueError(
                f"split_s {self.split_s!r} must be None (auto) or an int >= 1")

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


def tiny_config(**overrides) -> TransformerConfig:
    """Small config for tests and CPU runs (the JAX package's, in fp32)."""
    defaults = dict(vocab_size=128, num_layers=2, num_heads=2, embed_dim=32,
                    max_seq_len=256, dtype=torch.float32)
    defaults.update(overrides)
    return TransformerConfig(**defaults)


class PagedIndex(NamedTuple):
    """Where a forward's tokens live in the pools, computed once for all
    layers: pool block ``blk [B, L]`` and in-block offset ``off [B, L]`` of
    each token, its absolute position as int32 ``positions [B, L]``, and
    the int32 ``tables [B, W]``."""

    blk: torch.Tensor
    off: torch.Tensor
    positions: torch.Tensor
    tables: torch.Tensor

    @classmethod
    def build(cls, positions: torch.Tensor, block_tables: torch.Tensor,
              block_len: int) -> "PagedIndex":
        tables = block_tables.to(device=positions.device, dtype=torch.int32)
        blk = torch.gather(tables.long(), 1, positions // block_len)
        return cls(blk, positions % block_len, positions.to(torch.int32),
                   tables.contiguous())


class LayerNorm32(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=jnp.float32)``: eps 1e-6, fp32 in and out,
    fp32 parameters."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
        self.qkv = nn.Linear(e, 3 * h * d, dtype=cfg.dtype)  # out (3, H, D)
        self.proj = nn.Linear(h * d, e, bias=False, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor, index: "PagedIndex",
                cache: LayerCache) -> torch.Tensor:
        """``x [B, L, E]`` (LayerNorm output). Writes the chunk's K/V into
        the pools in place at ``(index.blk, index.off)``, then attends
        through the tables; the chunk just written is visible to itself
        through the same frontier mask."""
        cfg = self.cfg
        b, l, _ = x.shape
        h, d = cfg.num_heads, cfg.head_dim
        q, k, v = self.qkv(x.to(cfg.dtype)).view(b, l, 3, h, d).unbind(dim=2)
        k_pool, v_pool = cache
        # inactive lanes write to the trash block, where clashes are harmless
        k_pool[index.blk, index.off] = k.to(k_pool.dtype)
        v_pool[index.blk, index.off] = v.to(v_pool.dtype)
        out = paged_attention(q, k_pool, v_pool, index.tables, index.positions,
                              gather_impl=cfg.gather_impl, split_s=cfg.split_s)
        return self.proj(out.reshape(b, l, h * d))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.ln1 = LayerNorm32(e)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm32(e)
        self.mlp_up = nn.Linear(e, e * cfg.mlp_ratio, dtype=cfg.dtype)
        self.mlp_down = nn.Linear(e * cfg.mlp_ratio, e, bias=False, dtype=cfg.dtype)

    def forward(self, x, index: "PagedIndex", cache: LayerCache):
        dt = self.cfg.dtype
        x = x + self.attn(self.ln1(x), index, cache)
        hdn = F.gelu(self.mlp_up(self.ln2(x).to(dt)), approximate="tanh")
        return x + self.mlp_down(hdn)


class TransformerLM(nn.Module):
    """Decoder-only LM over a block-pooled KV cache.

    ``forward(tokens [B, L], position_offset [B], block_tables [B, W],
    cache)`` → logits ``[B, L, vocab]`` fp32, with ``cache`` a list of one
    ``(key_pool, value_pool)`` pair per layer, updated in place (the JAX
    module returns a new cache; here the pools are mutated, which saves a
    pool copy per call). ``logits_index [B]`` keeps one row per request —
    the LM head then runs on B rows instead of B·L.
    """

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.wte = nn.Embedding(cfg.vocab_size, e, dtype=cfg.dtype)
        self.wpe = nn.Embedding(cfg.max_seq_len, e, dtype=cfg.dtype)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm32(e)
        self.lm_head = nn.Linear(e, cfg.vocab_size, bias=False, dtype=cfg.dtype)

    def forward(self, tokens: torch.Tensor, position_offset: torch.Tensor,
                block_tables: torch.Tensor, cache: List[LayerCache],
                logits_index: Optional[torch.Tensor] = None) -> torch.Tensor:
        if len(cache) != self.cfg.num_layers:
            raise ValueError(
                f"cache has {len(cache)} layers, the model {self.cfg.num_layers}")
        b, l = tokens.shape
        positions = (position_offset.to(tokens.device).long()[:, None]
                     + torch.arange(l, device=tokens.device))
        index = PagedIndex.build(positions, block_tables, cache[0][0].shape[1])
        x = self.wte(tokens) + self.wpe(positions)
        for blk, layer_cache in zip(self.blocks, cache):
            x = blk(x, index, layer_cache)
        if logits_index is not None:
            x = x[torch.arange(b, device=x.device), logits_index.long()][:, None]
        h = self.ln_f(x).to(self.cfg.dtype)
        return self.lm_head(h).float()
