"""Causal transformer LM, in PyTorch.

The port of ``pytorch_distributed_tpu/models/transformer.py``: token
embeddings with learned positions (``wpe``) or rotary ones (RoPE: q and k
rotated at their absolute positions, no table), pre-LN blocks (attention
with all heads or grouped-query attention, then a GELU MLP or, in every
``moe_every``-th block, a mixture of experts, ``models.moe``), a final
LayerNorm and an untied LM head with fp32 logits.

- GQA (``num_kv_heads``): separate ``q`` and ``kv`` projections (the flax
  tree's ``q`` kernel ``[E, H, D]`` and ``kv`` ``[E, 2, H_kv, D]``, both
  with bias); MHA keeps the fused ``qkv``. Every cache holds H_kv heads;
  the paged kernels and the dense decode read them by group (query head h
  reads KV head h // G), and training repeats K/V to H heads
  (``repeat_interleave``, JAX's ``jnp.repeat``) before any attention path.
- RoPE (``pos_embedding="rope"``): interleaved pairs (``x[..., ::2]``,
  ``x[..., 1::2]``), fp32 angles and trig, cast back; q and k are rotated
  before the cache write and before any attention path, so caches hold
  rotated keys and the ring ships them. The rotations are computed once a
  forward from the one resolved position array (``rope_angles``), never
  kept across calls, and applied as one complex multiply a tensor.
- Dropout (``dropout``) at the embedding sum, after the attention
  projection, after the MLP and after the MoE output, only in a training
  forward given a ``dropout_rng`` generator (the train step derives it from
  the seed, the step and the shard, ``train.lm.dropout_generator``).

- Dense decoding (``cache=`` a list of ``DenseCache``, no block tables;
  ``models.generate``): one ``[B, max_seq_len, H_kv, D]`` K and V per
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
  ``ops.flash_attention``, or ``"dense"`` / ``"blockwise"``
  (``ops.attention.blockwise_attention``) in plain PyTorch; with
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

- Tensor parallelism (``tp_size`` T > 1 with ``model_axis``, the mesh
  axis whose group ``parallel.mesh.make_mesh`` registers): Megatron's
  split, each model rank holding the parameters at its local shapes
  (``train.lm.shard_lm_state`` places them): the fused ``qkv`` (or GQA's
  ``q`` / ``kv``) holds H/T (H_kv/T) heads after ``tp_copy``, ``proj``
  takes the local heads' width and ``tp_reduce`` sums it (no bias), the
  MLP's ``mlp_up`` holds 4E/T features after ``tp_copy`` and ``mlp_down``
  their rows before ``tp_reduce``; residual dropout comes after
  ``tp_reduce``, one mask on every model rank. ``vocab_parallel`` also
  splits the vocabulary: each rank's ``wte`` holds V/T rows, looked up
  masked and summed by ``tp_reduce``, and its ``lm_head`` V/T rows; the
  logits path gathers the ranks' slices (``tp_all_gather``), the hidden
  state of ``return_hidden`` goes to the fused CE's ``vocab_axis`` with no
  ``tp_copy`` (the CE sums dx itself). Serving runs under TP too: every
  cache (``DenseCache``, the paged ``LayerCache``) holds this rank's
  H_kv/T heads, the attention writes and reads them (through the paged
  kernels at the local head count; the GQA group H/H_kv is the same on
  every rank), ``proj``'s ``tp_reduce`` completes each path, and the logits
  come out whole on every rank (the replicated head after the last
  ``tp_reduce``, or the vocab slices gathered). MoE blocks under TP raise
  (ROADMAP queue 1 item 6.4).

Expert parallelism (``ep_size > 1``) is not ported yet and raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.models.moe import MoEMLP
from pytorch_distributed_tpu_torch.ops.attention import (
    GATHER_IMPLS,
    NEG_INF,
    blockwise_attention,
    dense_attention,
    paged_attention,
)
from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention
from pytorch_distributed_tpu_torch.ops.ring_flash import ring_flash_attention
from pytorch_distributed_tpu_torch.parallel.mesh import SEQ_AXIS, axis_group
from pytorch_distributed_tpu_torch.parallel.sequence import LAYOUTS, ring_attention
from pytorch_distributed_tpu_torch.parallel.tensor import tp_all_gather, tp_copy, tp_reduce

LN_EPS = 1e-6  # flax nn.LayerNorm's default
ATTENTIONS = ("dense", "blockwise", "flash", "ring", "ring_flash")
RING_ATTENTIONS = ("ring", "ring_flash")
POS_EMBEDDINGS = ("learned", "rope")
#: JAX config fields whose branches are not ported, with their defaults
NOT_PORTED = {"ep_size": 1}


class LayerCache(NamedTuple):
    """One layer's KV pools, ``key``/``value`` ``[n_blocks, block_len,
    H_kv, D]``. Quantized pools carry ``key_scale``/``value_scale``
    ``[n_blocks, block_len, H_kv]`` (``serving.kv_pool``); float pools
    leave them None. Under TP, H_kv is this rank's H_kv/T heads."""

    key: torch.Tensor
    value: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None


class DenseCache(NamedTuple):
    """One layer's dense decode cache, ``key``/``value`` ``[B, max_seq_len,
    H_kv, D]`` in ``config.dtype`` (``models.generate.init_cache``); under
    TP this rank's H_kv/T heads."""

    key: torch.Tensor
    value: torch.Tensor


def _later(what: str) -> str:
    return f"{what}: not ported yet (ROADMAP.md, queue 1 item 6.4)"


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
    # training attention: "flash" (the CUDA kernels), "dense", "blockwise"
    # (plain PyTorch, K/V blocks of block_size), or over a sequence-parallel
    # group "ring_flash" (the kernels per ring visit) or "ring" (plain
    # PyTorch); serving requires "dense" (models.generate) and reads
    # through gather_impl
    attention: str = "dense"
    block_size: int = 512  # the K/V block of blockwise attention
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
    # residual dropout at four sites, active only in a training forward
    # given a dropout_rng
    dropout: float = 0.0
    # grouped-query attention: K/V heads (dividing num_heads); None = MHA
    # with the fused qkv projection
    num_kv_heads: Optional[int] = None
    # "learned" (the wpe table) or "rope" (rotary q/k, no table)
    pos_embedding: str = "learned"
    rope_theta: float = 10000.0
    # mixture of experts (models.moe) in every moe_every-th block when
    # n_experts > 0
    n_experts: int = 0
    moe_every: int = 2
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_top_k: int = 1
    # not ported: any value but 1 raises NotImplementedError
    ep_size: int = 1
    # Megatron tensor parallelism over the mesh axis model_axis, of size
    # tp_size (parameters at their local shapes on each model rank;
    # train.lm.shard_lm_state places them); vocab_parallel also splits
    # wte's and lm_head's vocabulary over it
    tp_size: int = 1
    model_axis: Optional[str] = None
    vocab_parallel: bool = False

    def __post_init__(self):
        later = [f"{k}={getattr(self, k)!r}" for k, default in NOT_PORTED.items()
                 if getattr(self, k) != default]
        if later:
            raise NotImplementedError(_later(", ".join(later)))
        if self.n_experts and self.n_experts % self.ep_size:
            raise ValueError(
                f"n_experts {self.n_experts} not divisible by ep_size {self.ep_size}")
        if self.n_experts and not 1 <= self.moe_top_k <= self.n_experts:
            raise ValueError(
                f"moe_top_k {self.moe_top_k} must be in [1, n_experts="
                f"{self.n_experts}]")
        if self.embed_dim % self.num_heads:
            raise ValueError(
                f"embed_dim {self.embed_dim} not divisible by num_heads "
                f"{self.num_heads}")
        if self.tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {self.tp_size}")
        if self.num_heads % self.tp_size:
            raise ValueError(
                f"num_heads {self.num_heads} not divisible by tp_size {self.tp_size}")
        if self.pos_embedding not in POS_EMBEDDINGS:
            raise ValueError(
                f"pos_embedding {self.pos_embedding!r} must be 'learned' or 'rope'")
        if self.pos_embedding == "rope" and (self.embed_dim // self.num_heads) % 2:
            raise ValueError(
                f"rope needs an even head_dim, got {self.embed_dim // self.num_heads}")
        if self.rope_theta <= 0.0:
            raise ValueError(f"rope_theta must be > 0, got {self.rope_theta}")
        if self.num_kv_heads is not None:
            if self.num_kv_heads < 1:
                raise ValueError(f"num_kv_heads must be >= 1, got {self.num_kv_heads}")
            if self.num_heads % self.num_kv_heads:
                raise ValueError(
                    f"num_heads {self.num_heads} not divisible by num_kv_heads "
                    f"{self.num_kv_heads}")
            if self.num_kv_heads % self.tp_size:
                raise ValueError(
                    f"num_kv_heads {self.num_kv_heads} not divisible by tp_size "
                    f"{self.tp_size} (each TP rank needs whole KV heads)")
        if self.vocab_parallel and self.vocab_size % self.tp_size:
            raise ValueError(
                f"vocab_size {self.vocab_size} not divisible by tp_size {self.tp_size} "
                "(vocab_parallel shards the vocab dim)")
        if self.tp_size > 1 and self.model_axis is None:
            raise ValueError(
                f"tp_size {self.tp_size} > 1 requires model_axis: without the axis "
                "name the TP collectives are skipped and the model silently trains "
                "with thin local shards")
        if (self.embed_dim * self.mlp_ratio) % self.tp_size:
            raise ValueError(
                f"mlp width {self.embed_dim * self.mlp_ratio} not divisible by tp_size "
                f"{self.tp_size}")
        if self.n_experts and self.tp_size > 1:
            raise NotImplementedError(_later(
                f"n_experts={self.n_experts} with tp_size={self.tp_size} (TP inside "
                "each expert)"))
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")
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

    def uses_vocab_parallel(self) -> bool:
        """The one vocab-parallel predicate (the JAX config's): the
        model's embedding and head, the placement rules and the loss
        tail all ask it."""
        return self.vocab_parallel and self.model_axis is not None and self.tp_size > 1

    def model_group(self):
        """The model axis's ``AxisGroup`` under TP (the mesh registry's),
        else None."""
        return axis_group(self.model_axis) if self.tp_size > 1 else None

    @property
    def kv_heads(self) -> int:
        """The heads K/V (and every cache) hold: ``num_kv_heads``, or all."""
        return self.num_kv_heads or self.num_heads

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


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """The rotations ``e^{i·ang}`` (complex64 ``[B or 1, L, 1, D/2]``) of
    the absolute ``positions`` (``[L]`` shared or ``[B, L]`` a request),
    the JAX ``_rope_rotate``'s ``ang = pos · θ^(-2i/D)`` with fp32 trig;
    computed once a forward for every layer."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    pos = positions if positions.dim() == 2 else positions[None]
    ang = pos.float()[..., None] * inv
    return torch.complex(torch.cos(ang), torch.sin(ang))[:, :, None, :]


def rope_apply(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [B, L, H, D]`` by ``rope_angles``' rotations: the
    interleaved pairs ``(x[..., ::2], x[..., 1::2])`` as complex numbers
    times ``rot`` in fp32, i.e. ``(x1·cos - x2·sin, x1·sin + x2·cos)``,
    cast back to x's dtype (three kernels a tensor, where the pairwise
    spelling takes about ten)."""
    xc = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)))
    return torch.view_as_real(xc * rot).flatten(-2).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate
    (a uniform draw from ``generator`` below it) and scale the kept ones
    by 1 / (1 - rate), in x's dtype."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """``[B, L, H_kv, D]`` → ``[B, L, H_kv·G, D]``, KV head j repeated for
    query heads j·G .. j·G + G - 1 (``jnp.repeat(x, G, axis=2)``)."""
    return x if group == 1 else torch.repeat_interleave(x, group, dim=2)


class Attention(nn.Module):
    """Under TP (``tp_size`` T) this rank's H/T query heads and H_kv/T
    K/V heads: ``qkv`` ``[3·(H/T)·D, E]`` (its heads of q, of k and of v),
    GQA's ``q`` / ``kv`` likewise, ``proj`` ``[E, (H/T)·D]``."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e, d = cfg.embed_dim, cfg.head_dim
        self.heads = cfg.num_heads // cfg.tp_size
        self.kv_heads = cfg.kv_heads // cfg.tp_size
        h = self.heads
        if cfg.num_kv_heads is None:
            self.qkv = Dense(cfg, e, 3 * h * d)  # out (3, H, D)
        else:
            self.q = Dense(cfg, e, h * d)  # out (H, D)
            self.kv = Dense(cfg, e, 2 * self.kv_heads * d)  # out (2, H_kv, D)
        self.proj = Dense(cfg, h * d, e, bias=False)

    def project(self, x: torch.Tensor):
        """q ``[B, L, H, D]``, k and v ``[B, L, H_kv, D]`` (views of the
        projections' outputs; this rank's heads under TP)."""
        cfg = self.cfg
        b, l, _ = x.shape
        h, d = self.heads, cfg.head_dim
        if cfg.num_kv_heads is None:
            return self.qkv(x).view(b, l, 3, h, d).unbind(dim=2)
        k, v = self.kv(x).view(b, l, 2, self.kv_heads, d).unbind(dim=2)
        return self.q(x).view(b, l, h, d), k, v

    def forward(self, x: torch.Tensor, index: Optional["PagedIndex"] = None,
                cache=None, position_offset=0, decode: bool = False,
                rope=None, drop=None) -> torch.Tensor:
        """``x [B, L, E]`` (LayerNorm output). ``rope``: the forward's
        ``rope_angles`` rotations (under RoPE), applied to q and k before anything
        else reads them; ``drop``: the training forward's dropout, applied
        to the projection's output.

        Dense (``cache`` a ``DenseCache``): the K/V rows are written at
        ``position_offset`` (a scalar, or ``[B]`` for a one-token decode),
        then prefill attends causally over the L tokens (K/V repeated to H
        heads) and decode in fp32 to the whole cache row, positions past
        each request's own masked out, by group against the H_kv-head
        cache (JAX ``transformer.py:422-505``).

        Paged (``cache`` given): writes the chunk's K/V into the pools in
        place at ``(index.blk, index.off)``, then attends through the
        tables (the kernels fold a GQA group into rows); the chunk just
        written is visible to itself through the same frontier mask. On
        quantized pools with ``gather_impl="kernel"`` the two are one op,
        ``paged_quantize_scatter_attention`` (one launch with bf16 q),
        which derives the same places from the tables and positions.
        Training (no cache): K/V repeated to H heads, then causal
        self-attention over the L tokens by ``cfg.attention``; the flash
        kernel masks from position 0, which is exact for equal q/k offsets,
        and the rings take their causal structure from the ring positions
        (the contiguous plain ring from the document's base,
        ``position_offset`` less this shard's start)."""
        cfg = self.cfg
        b, l, _ = x.shape
        h, d = self.heads, cfg.head_dim
        tp = cfg.model_group()
        if tp is not None:
            x = tp_copy(x, tp)  # column-parallel projections below
        q, k, v = self.project(x)
        if rope is not None:
            q, k = rope_apply(q, rope), rope_apply(k, rope)
        if isinstance(cache, DenseCache):
            return self._out(self._dense_cached(q, k, v, cache, position_offset, decode), tp)
        if cache is None:
            group = h // self.kv_heads
            k, v = repeat_kv(k, group), repeat_kv(v, group)
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
            elif cfg.attention == "blockwise":
                out = blockwise_attention(q, k, v, causal=True,
                                          block_size=min(cfg.block_size, l),
                                          q_offset=position_offset, k_offset=position_offset)
            else:
                out = dense_attention(q, k, v, causal=True, q_offset=position_offset,
                                      k_offset=position_offset)
            # dropout after the reduce, one mask on every model rank
            out = self._out(out, tp)
            return out if drop is None else drop(out)
        k_pool, v_pool, k_scale, v_scale = cache
        # inactive lanes write to the trash block, where clashes are harmless
        if k_scale is not None and cfg.gather_impl == "kernel":
            # the scatter and the attention as one op: with bf16 q one launch,
            # the tensor-core kernel writing the rows before it reads them
            from pytorch_distributed_tpu_torch.ops import paged_flash

            out = paged_flash.paged_quantize_scatter_attention(
                q, k, v, *cache, index.tables, index.positions, split_s=cfg.split_s)
            return self._out(out, tp)
        if k_scale is None:
            k_pool[index.blk, index.off] = k.to(k_pool.dtype)
            v_pool[index.blk, index.off] = v.to(v_pool.dtype)
        else:
            from pytorch_distributed_tpu_torch.ops import paged_flash

            paged_flash.paged_quantize_scatter_reference(k, v, index.blk, index.off, *cache)
        out = paged_attention(q, k_pool, v_pool, index.tables, index.positions,
                              gather_impl=cfg.gather_impl, split_s=cfg.split_s,
                              k_scale=k_scale, v_scale=v_scale)
        return self._out(out, tp)

    def _out(self, out: torch.Tensor, tp) -> torch.Tensor:
        """The heads' output ``[B, L, H, D]`` through ``proj``; under TP the
        row-parallel ``proj`` (no bias) gives this rank's partial sum, which
        ``tp_reduce`` completes."""
        out = self.proj(out.flatten(2))
        return out if tp is None else tp_reduce(out, tp)

    def _dense_cached(self, q, k, v, cache: DenseCache, position_offset,
                      decode: bool) -> torch.Tensor:
        ck, cv = cache
        b, l, h, d = q.shape
        h_kv = ck.shape[2]
        group = h // h_kv
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
            return dense_attention(q, repeat_kv(k, group), repeat_kv(v, group), causal=True,
                                   q_offset=p0, k_offset=p0)
        # one layer's cache cast to fp32 at a time, as the JAX module does;
        # under GQA query head h reads cache head h // G, never widened
        scale = self.cfg.head_dim ** -0.5
        qg = (q.float() * scale).reshape(b, 1, h_kv, group, d)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float())
        mask = (torch.arange(ck.shape[1], device=q.device)[None, None, None, None, :]
                <= pos_b[:, None, None, None, None])
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", p, cv.float())
        return out.reshape(b, 1, h, d).to(self.cfg.dtype)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, use_moe: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_moe = use_moe
        e = cfg.embed_dim
        self.ln1 = LayerNorm32(e)
        self.attn = Attention(cfg)
        self.ln2 = LayerNorm32(e)
        if use_moe:
            self.moe = MoEMLP(cfg.n_experts, e, e * cfg.mlp_ratio,
                              capacity_factor=cfg.capacity_factor,
                              aux_loss_weight=cfg.moe_aux_weight, top_k=cfg.moe_top_k,
                              dtype=cfg.dtype, param_dtype=cfg.weight_dtype)
        else:
            # under TP this rank's 4E/T features: mlp_up's rows, mlp_down's
            # columns
            m = e * cfg.mlp_ratio // cfg.tp_size
            self.mlp_up = Dense(cfg, e, m)
            self.mlp_down = Dense(cfg, m, e, bias=False)

    def forward(self, x, index: Optional["PagedIndex"] = None,
                cache=None, position_offset=0, decode: bool = False, rope=None, drop=None):
        x = x + self.attn(self.ln1(x), index, cache, position_offset, decode, rope, drop)
        if self.use_moe:
            out = self.moe(self.ln2(x))
        else:
            h = self.ln2(x)
            tp = self.cfg.model_group()
            if tp is not None:
                h = tp_copy(h, tp)  # column-parallel mlp_up
            out = self.mlp_down(F.gelu(self.mlp_up(h), approximate="tanh"))
            if tp is not None:
                out = tp_reduce(out, tp)  # row-parallel mlp_down, no bias
        return x + (out if drop is None else drop(out))


def use_moe(cfg: TransformerConfig, layer: int) -> bool:
    """Whether block ``layer`` holds the MoE (every ``moe_every``-th)."""
    return bool(cfg.n_experts) and layer % cfg.moe_every == cfg.moe_every - 1


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
    return_hidden=False, dropout_rng=None)`` → logits ``[B, L, vocab]``
    fp32, or with ``return_hidden`` the fp32 output of the final LayerNorm
    (the fused loss applies ``lm_head.weight`` itself). ``positions [L]``
    overrides ``position_offset + arange(L)`` for the position embedding or
    rotation (required for a zigzag shard). Sequence-parallel: ``tokens``
    is this rank's shard and ``position_offset`` its first token's
    position. Dropout runs when ``cfg.dropout > 0``, the module is in
    training mode and ``dropout_rng`` (a ``torch.Generator`` on the
    tokens' device) is given; the masks are its draws, in the order of the
    sites. The MoE blocks leave each call's aux loss and drop share on
    their ``MoEMLP`` (``models.moe.moe_layers``).
    """

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        # vocab-parallel: this rank's V/T rows of wte and of lm_head
        vocab = cfg.vocab_size // cfg.tp_size if cfg.uses_vocab_parallel() else cfg.vocab_size
        self.wte = Embed(cfg, vocab, e)
        if cfg.pos_embedding == "learned":
            self.wpe = Embed(cfg, cfg.max_seq_len, e)
        self.blocks = nn.ModuleList(Block(cfg, use_moe(cfg, i)) for i in range(cfg.num_layers))
        self.ln_f = LayerNorm32(e)
        self.lm_head = Dense(cfg, e, vocab, bias=False)

    def embed(self, tokens: torch.Tensor, positions: torch.Tensor):
        """Token embeddings plus the learned positions', and the rotary
        rotations under RoPE (None otherwise), from one position array.
        Vocab-parallel: this rank looks up the tokens of its rows (the
        others a clamped row, zeroed) and ``tp_reduce`` sums the one real
        row a token; the mask keeps foreign rows' gradients off this
        rank's table."""
        if self.cfg.uses_vocab_parallel():
            tp = self.cfg.model_group()
            n = self.wte.num_embeddings
            loc = tokens - tp.index * n
            ok = (loc >= 0) & (loc < n)
            emb = self.wte(loc.clamp(0, n - 1))
            x = tp_reduce(torch.where(ok[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                                      device=emb.device)), tp)
        else:
            x = self.wte(tokens)
        if self.cfg.pos_embedding == "learned":
            return x + self.wpe(positions), None
        return x, rope_angles(positions, self.cfg.head_dim, self.cfg.rope_theta)

    def forward(self, tokens: torch.Tensor, position_offset=0,
                block_tables: Optional[torch.Tensor] = None,
                cache: Optional[List[LayerCache]] = None,
                logits_index: Optional[torch.Tensor] = None, *,
                positions: Optional[torch.Tensor] = None,
                return_hidden: bool = False, decode: bool = False,
                dropout_rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if cache is None:
            return self._forward_train(tokens, position_offset, positions, return_hidden,
                                       dropout_rng)
        if self.cfg.tp_size > 1 and self.cfg.model_group().size != self.cfg.tp_size:
            raise ValueError(
                f"mesh {self.cfg.model_axis!r} size {self.cfg.model_group().size} != tp_size "
                f"{self.cfg.tp_size}: the caches hold a rank's H_kv/T heads")
        if block_tables is None:
            return self._forward_dense(tokens, position_offset, cache, decode)
        if len(cache) != self.cfg.num_layers:
            raise ValueError(
                f"cache has {len(cache)} layers, the model {self.cfg.num_layers}")
        b, l = tokens.shape
        positions = (position_offset.to(tokens.device).long()[:, None]
                     + torch.arange(l, device=tokens.device))
        index = PagedIndex.build(positions, block_tables, cache[0][0].shape[1])
        x, rope = self.embed(tokens, positions)
        for blk, layer_cache in zip(self.blocks, cache):
            x = blk(x, index, layer_cache, rope=rope)
        if logits_index is not None:
            x = x[torch.arange(b, device=x.device), logits_index.long()][:, None]
        return self.logits(self.ln_f(x))

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
        x, rope = self.embed(tokens, positions)
        for blk, layer_cache in zip(self.blocks, cache):
            x = blk(x, None, layer_cache, position_offset, decode, rope)
        return self.logits(self.ln_f(x))

    def _forward_train(self, tokens: torch.Tensor, position_offset,
                       positions: Optional[torch.Tensor], return_hidden: bool,
                       dropout_rng: Optional[torch.Generator]) -> torch.Tensor:
        if torch.is_tensor(position_offset) and position_offset.dim() > 0:
            raise ValueError(
                "a [B] position_offset is the paged serving convention (pass "
                "block_tables and cache); training takes a scalar offset or "
                "positions=")
        if self.cfg.attention not in ATTENTIONS:
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
        drop = None
        if self.cfg.dropout > 0.0 and self.training and dropout_rng is not None:
            rate = self.cfg.dropout

            def drop(t):
                return dropout(t, rate, dropout_rng)

        x, rope = self.embed(tokens, positions)
        if drop is not None:
            x = drop(x)
        for blk in self.blocks:
            x = blk(x, position_offset=offset, rope=rope, drop=drop)
        x = self.ln_f(x)
        return x if return_hidden else self.logits(x)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits ``[..., vocab]`` of the final LayerNorm's output,
        whole on every model rank: the replicated head, or under vocab
        parallelism the column-parallel head's slices gathered in rank
        order."""
        if not self.cfg.uses_vocab_parallel():
            return self.lm_head(x).float()
        tp = self.cfg.model_group()
        return tp_all_gather(self.lm_head(tp_copy(x, tp)).float(), tp, dim=-1)
