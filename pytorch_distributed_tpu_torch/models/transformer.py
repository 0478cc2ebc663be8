"""Causal transformer LM, in PyTorch.

The port of ``pytorch_distributed_tpu/models/transformer.py`` along two
paths: learned token and position embeddings, pre-LN blocks (attention,
GELU MLP), a final LayerNorm and an untied LM head with fp32 logits.

- Dense decoding (``cache=`` a list of ``DenseCache``, no block tables;
  ``models.generate``): one ``[B, max_seq_len, H, D]`` K and V per
  layer, written in place. Prefill (``decode=False``) writes the prompt's
  K/V at a scalar ``position_offset`` and attends causally over the
  prompt; decode (``decode=True``, one token a request) writes at a
  scalar or per-request ``[B]`` ``position_offset`` and attends in fp32
  to the whole row under the ``<= position`` mask.
- Paged serving (``cache=`` given): each layer's attention writes the
  chunk's K/V into the block pool and attends through the block tables
  (``ops.attention.paged_attention``). One forward serves chunked prefill
  (C = chunk) and decode (C = 1). A quantized pool (int8/fp8, told by its
  dtype alone) is written by quantize-on-scatter, and the chunk then
  attends to the quantized values it wrote, as every later read does.
- Training (no cache): causal self-attention over the whole sequence,
  ``attention="flash"`` through the CUDA kernels of
  ``ops.flash_attention`` or ``"dense"`` in plain PyTorch; with
  ``return_hidden`` it stops after the final LayerNorm for the fused loss.
  Sequence-parallel training shards the sequence over the mesh's
  ``config.seq_axis`` group and attends round the ring: ``"ring_flash"``
  through the flash kernels (``ops.ring_flash``), ``"ring"`` in plain
  PyTorch (``parallel.sequence``), with ``ring_layout`` contiguous or
  zigzag (a zigzag shard's wpe positions come as ``positions=``).

Both forwards share one module and its state-dict names, so
``models.convert.params_from_jax`` serves both.

What must match the flax module exactly:

- LayerNorm has eps 1e-6 and computes and returns fp32;
- ``nn.gelu`` is the tanh approximation;
- ``proj``, ``mlp_down`` and ``lm_head`` have no bias;
- embeddings, the residual stream and every Dense output are in
  ``config.dtype``; a LayerNorm's fp32 output is cast to it at the next
  Dense, and the logits are the head's output cast to fp32;
- flax sets no ``param_dtype``, so the JAX model trains fp32 parameters and
  casts each Dense's and Embed's operands to ``config.dtype``. Here
  ``config.param_dtype`` (None = ``config.dtype``, the serving default)
  picks the parameters' dtype and ``Dense``/``Embed`` cast to
  ``config.dtype`` at use; training sets it to fp32
  (``train.lm.create_lm_state``), because AdamW on bf16 parameters loses
  most updates.

The blockwise, MoE, tensor-parallel, RoPE, dropout and GQA branches of the
JAX module are not ported yet: their config fields raise
``NotImplementedError`` when set, and ``attention="blockwise"`` when the
training forward runs.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.ops.attention import (
    GATHER_IMPLS,
    NEG_INF,
    dense_attention,
    paged_attention,
)
from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention
from pytorch_distributed_tpu_torch.ops.ring_flash import ring_flash_attention
from pytorch_distributed_tpu_torch.parallel.mesh import SEQ_AXIS, axis_group
from pytorch_distributed_tpu_torch.parallel.sequence import LAYOUTS, ring_attention

LN_EPS = 1e-6  # flax nn.LayerNorm's default
ATTENTIONS = ("dense", "flash", "ring", "ring_flash")
RING_ATTENTIONS = ("ring", "ring_flash")
#: JAX config fields whose branches are not ported, with their defaults
NOT_PORTED = {"dropout": 0.0, "num_kv_heads": None, "pos_embedding": "learned",
              "n_experts": 0, "tp_size": 1}


class LayerCache(NamedTuple):
    """One layer's KV pools, ``key``/``value`` ``[n_blocks, block_len,
    H_kv, D]``. Quantized pools carry ``key_scale``/``value_scale``
    ``[n_blocks, block_len, H_kv]`` (``serving.kv_pool``); float pools
    leave them None."""

    key: torch.Tensor
    value: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None


class DenseCache(NamedTuple):
    """One layer's dense decode cache, ``key``/``value`` ``[B, max_seq_len,
    H, D]`` in ``config.dtype`` (``models.generate.init_cache``)."""

    key: torch.Tensor
    value: torch.Tensor


def _later(what: str) -> str:
    return (f"{what}: not ported yet (ROADMAP.md, the port's queue: dropout, "
            "GQA, RoPE, MoE, TP and blockwise come with later slices)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # parameters' dtype; None = dtype (serving). Training keeps fp32.
    param_dtype: Optional[torch.dtype] = None
    # training attention: "flash" (the CUDA kernels), "dense", or over a
    # sequence-parallel group "ring_flash" (the kernels per ring visit) or
    # "ring" (plain PyTorch); serving requires "dense" (models.generate) and
    # reads through gather_impl
    attention: str = "dense"
    # the mesh axis whose group the ring runs over (parallel.mesh.make_mesh
    # registers it), and the shards' layout: "contiguous" or "zigzag"
    seq_axis: str = SEQ_AXIS
    ring_layout: str = "contiguous"
    # paged read path: "kernel" runs the CUDA kernels of ops/paged_flash.py
    # (the JAX package's "pallas"), "dense" the plain PyTorch version
    gather_impl: str = "kernel"
    # flash-decoding workers: None = auto (ops.paged_flash.auto_split_s),
    # 1 = single sweep, S > 1 forced
    split_s: Optional[int] = None
    # not ported: any value but the default raises NotImplementedError
    dropout: float = 0.0
    num_kv_heads: Optional[int] = None
    pos_embedding: str = "learned"
    n_experts: int = 0
    tp_size: int = 1

    def __post_init__(self):
        later = [f"{k}={getattr(self, k)!r}" for k, default in NOT_PORTED.items()
                 if getattr(self, k) != default]
        if later:
            raise NotImplementedError(_later(", ".join(later)))
        if self.embed_dim % self.num_heads:
            raise ValueError(
                f"embed_dim {self.embed_dim} not divisible by num_heads "
                f"{self.num_heads}")
        if self.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {self.dtype}")
        if self.param_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(
                f"param_dtype must be None, float32 or bfloat16, got {self.param_dtype}")
        if self.ring_layout not in LAYOUTS:
            raise ValueError(
                f"ring_layout {self.ring_layout!r} must be 'contiguous' or 'zigzag'")
        if self.ring_layout == "zigzag" and self.attention not in RING_ATTENTIONS:
            raise ValueError(
                f"ring_layout='zigzag' only applies to ring attention (got "
                f"attention={self.attention!r}); the layout is a causal-ring "
                "scheduling balance, meaningless elsewhere")
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

    @property
    def weight_dtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype


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


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=cfg.dtype)``: parameters in
    ``cfg.weight_dtype``; input, weight and bias cast to ``cfg.dtype`` at
    use (no-ops when the two agree)."""

    def __init__(self, cfg: TransformerConfig, d_in: int, d_out: int,
                 bias: bool = True):
        super().__init__(d_in, d_out, bias=bias, dtype=cfg.weight_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embed(nn.Embedding):
    """flax ``nn.Embed(dtype=cfg.dtype)``: the table in
    ``cfg.weight_dtype``, the looked-up rows in ``cfg.dtype``."""

    def __init__(self, cfg: TransformerConfig, n: int, dim: int):
        super().__init__(n, dim, dtype=cfg.weight_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return super().forward(idx).to(self.compute_dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
        self.qkv = Dense(cfg, e, 3 * h * d)  # out (3, H, D)
        self.proj = Dense(cfg, h * d, e, bias=False)

    def forward(self, x: torch.Tensor, index: Optional["PagedIndex"] = None,
                cache=None, position_offset=0, decode: bool = False) -> torch.Tensor:
        """``x [B, L, E]`` (LayerNorm output).

        Dense (``cache`` a ``DenseCache``): the K/V rows are written at
        ``position_offset`` (a scalar, or ``[B]`` for a one-token decode),
        then prefill attends causally over the L tokens and decode in fp32
        to the whole cache row, positions past each request's own masked
        out (JAX ``transformer.py:422-505``).

        Paged (``cache`` given): writes the chunk's K/V into the pools in
        place at ``(index.blk, index.off)``, then attends through the
        tables; the chunk just written is visible to itself through the
        same frontier mask. On quantized pools with ``gather_impl="kernel"``
        the two are one op, ``paged_quantize_scatter_attention`` (one
        launch with bf16 q), which derives the same places from the tables
        and positions. Training (no cache): causal self-attention over
        the L tokens by ``cfg.attention``; the flash kernel masks from
        position 0, which is exact for equal q/k offsets, and the rings
        take their causal structure from the ring positions (the contiguous
        plain ring from the document's base, ``position_offset`` less this
        shard's start)."""
        cfg = self.cfg
        b, l, _ = x.shape
        h, d = cfg.num_heads, cfg.head_dim
        q, k, v = self.qkv(x).view(b, l, 3, h, d).unbind(dim=2)
        if isinstance(cache, DenseCache):
            out = self._dense_cached(q, k, v, cache, position_offset, decode)
            return self.proj(out.reshape(b, l, h * d))
        if cache is None:
            if cfg.attention == "flash":
                out = flash_attention(q, k, v, causal=True)
            elif cfg.attention == "ring_flash":
                out = ring_flash_attention(q, k, v, causal=True, layout=cfg.ring_layout,
                                           group=axis_group(cfg.seq_axis))
            elif cfg.attention == "ring":
                ax = axis_group(cfg.seq_axis)
                base = 0 if cfg.ring_layout == "zigzag" else position_offset - ax.index * l
                out = ring_attention(q, k, v, group=ax, causal=True, base_offset=base,
                                     layout=cfg.ring_layout)
            else:
                out = dense_attention(q, k, v, causal=True, q_offset=position_offset,
                                      k_offset=position_offset)
            return self.proj(out.reshape(b, l, h * d))
        k_pool, v_pool, k_scale, v_scale = cache
        # inactive lanes write to the trash block, where clashes are harmless
        if k_scale is not None and cfg.gather_impl == "kernel":
            # the scatter and the attention as one op: with bf16 q one launch,
            # the tensor-core kernel writing the rows before it reads them
            from pytorch_distributed_tpu_torch.ops import paged_flash

            out = paged_flash.paged_quantize_scatter_attention(
                q, k, v, *cache, index.tables, index.positions, split_s=cfg.split_s)
            return self.proj(out.reshape(b, l, h * d))
        if k_scale is None:
            k_pool[index.blk, index.off] = k.to(k_pool.dtype)
            v_pool[index.blk, index.off] = v.to(v_pool.dtype)
        else:
            from pytorch_distributed_tpu_torch.ops import paged_flash

            paged_flash.paged_quantize_scatter_reference(k, v, index.blk, index.off, *cache)
        out = paged_attention(q, k_pool, v_pool, index.tables, index.positions,
                              gather_impl=cfg.gather_impl, split_s=cfg.split_s,
                              k_scale=k_scale, v_scale=v_scale)
        return self.proj(out.reshape(b, l, h * d))


    def _dense_cached(self, q, k, v, cache: DenseCache, position_offset,
                      decode: bool) -> torch.Tensor:
        ck, cv = cache
        b, l = q.shape[:2]
        if torch.is_tensor(position_offset) and position_offset.dim() == 1:
            # one token a request, each at its own row position
            pos_b = position_offset.to(q.device).long()
            rows = torch.arange(b, device=q.device)
            ck[rows, pos_b] = k[:, 0].to(ck.dtype)
            cv[rows, pos_b] = v[:, 0].to(cv.dtype)
        else:
            p0 = int(position_offset)
            ck[:, p0:p0 + l] = k.to(ck.dtype)
            cv[:, p0:p0 + l] = v.to(cv.dtype)
            pos_b = torch.full((b,), p0, dtype=torch.long, device=q.device)
        if not decode:  # prefill: a scalar offset (TransformerLM checks)
            return dense_attention(q, k, v, causal=True, q_offset=p0, k_offset=p0)
        # one layer's cache cast to fp32 at a time, as the JAX module does
        scale = self.cfg.head_dim ** -0.5
        s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, ck.float())
        mask = (torch.arange(ck.shape[1], device=q.device)[None, None, None, :]
                <= pos_b[:, None, None, None])
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, cv.float()).to(self.cfg.dtype)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.ln1 = LayerNorm32(e)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm32(e)
        self.mlp_up = Dense(cfg, e, e * cfg.mlp_ratio)
        self.mlp_down = Dense(cfg, e * cfg.mlp_ratio, e, bias=False)

    def forward(self, x, index: Optional["PagedIndex"] = None,
                cache=None, position_offset=0, decode: bool = False):
        x = x + self.attn(self.ln1(x), index, cache, position_offset, decode)
        hdn = F.gelu(self.mlp_up(self.ln2(x)), approximate="tanh")
        return x + self.mlp_down(hdn)


class TransformerLM(nn.Module):
    """Decoder-only LM, for training, over a dense decode cache or over a
    block-pooled KV cache.

    Dense: ``forward(tokens [B, L], position_offset, cache=[DenseCache,
    ...], decode=False)`` prefills (a scalar offset), ``decode=True``
    steps one token a request (``position_offset`` a scalar or ``[B]``);
    logits ``[B, L, vocab]`` fp32, the cache written in place.

    Paged: ``forward(tokens [B, L], position_offset [B], block_tables
    [B, W], cache)`` → logits ``[B, L, vocab]`` fp32, with ``cache`` a list
    of one ``LayerCache`` per layer, updated in place (the
    JAX module returns a new cache; here the pools are mutated, which saves
    a pool copy per call). ``logits_index [B]`` keeps one row per request —
    the LM head then runs on B rows instead of B·L.

    Training: ``forward(tokens [B, L], position_offset=0, positions=None,
    return_hidden=False)`` → logits ``[B, L, vocab]`` fp32, or with
    ``return_hidden`` the fp32 output of the final LayerNorm (the fused
    loss applies ``lm_head.weight`` itself). ``positions [L]`` overrides
    ``position_offset + arange(L)`` for the position embedding (required
    for a zigzag shard). Sequence-parallel: ``tokens`` is this rank's shard
    and ``position_offset`` its first token's position.
    """

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.wte = Embed(cfg, cfg.vocab_size, e)
        self.wpe = Embed(cfg, cfg.max_seq_len, e)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm32(e)
        self.lm_head = Dense(cfg, e, cfg.vocab_size, bias=False)

    def forward(self, tokens: torch.Tensor, position_offset=0,
                block_tables: Optional[torch.Tensor] = None,
                cache: Optional[List[LayerCache]] = None,
                logits_index: Optional[torch.Tensor] = None, *,
                positions: Optional[torch.Tensor] = None,
                return_hidden: bool = False, decode: bool = False) -> torch.Tensor:
        if cache is None:
            return self._forward_train(tokens, position_offset, positions, return_hidden)
        if block_tables is None:
            return self._forward_dense(tokens, position_offset, cache, decode)
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
        return self.lm_head(self.ln_f(x)).float()

    def _forward_dense(self, tokens: torch.Tensor, position_offset,
                       cache: List[DenseCache], decode: bool) -> torch.Tensor:
        if self.cfg.attention != "dense":
            raise ValueError(
                f"the dense decode cache needs attention='dense', got "
                f"{self.cfg.attention!r}")
        if len(cache) != self.cfg.num_layers:
            raise ValueError(
                f"cache has {len(cache)} layers, the model {self.cfg.num_layers}")
        b, l = tokens.shape
        if torch.is_tensor(position_offset) and position_offset.dim() == 1:
            if not (decode and l == 1):
                raise ValueError(
                    "a [B] position_offset vector is the ragged decode convention "
                    "(decode=True, one token a request); prefill takes a scalar")
            positions = position_offset.to(tokens.device).long()[:, None]
        else:
            if decode and l != 1:
                raise ValueError(f"decode processes one token a step, got {l}")
            positions = int(position_offset) + torch.arange(l, device=tokens.device)
        x = self.wte(tokens) + self.wpe(positions)
        for blk, layer_cache in zip(self.blocks, cache):
            x = blk(x, None, layer_cache, position_offset, decode)
        return self.lm_head(self.ln_f(x)).float()

    def _forward_train(self, tokens: torch.Tensor, position_offset,
                       positions: Optional[torch.Tensor],
                       return_hidden: bool) -> torch.Tensor:
        if torch.is_tensor(position_offset) and position_offset.dim() > 0:
            raise ValueError(
                "a [B] position_offset is the paged serving convention (pass "
                "block_tables and cache); training takes a scalar offset or "
                "positions=")
        if self.cfg.attention not in ATTENTIONS:
            if self.cfg.attention == "blockwise":
                raise NotImplementedError(_later(f"attention={self.cfg.attention!r}"))
            raise ValueError(
                f"attention {self.cfg.attention!r} must be one of {ATTENTIONS}")
        if self.cfg.ring_layout == "zigzag" and positions is None:
            raise ValueError(
                "ring_layout='zigzag' requires the per-shard position vector "
                "(positions=): shards hold chunk pairs (r, 2s-1-r), so "
                "offset+arange wpe positions are wrong. Use the LM train/eval "
                "steps (train/lm.py), which compute it, and shard batches with "
                "shard_lm_batch(..., layout='zigzag').")
        offset = int(position_offset)
        if positions is None:
            positions = offset + torch.arange(tokens.shape[1], device=tokens.device)
        x = self.wte(tokens) + self.wpe(positions)
        for blk in self.blocks:
            x = blk(x, position_offset=offset)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return self.lm_head(x).float()
