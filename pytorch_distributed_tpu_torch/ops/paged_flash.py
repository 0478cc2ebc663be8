"""Paged attention through the hand-written CUDA kernels.

The port of ``pytorch_distributed_tpu/ops/paged_flash.py``'s
``paged_flash_attention``: the queries attend to the block-pooled KV
cache through the block tables, and the gathered sequence never exists
in device memory. Two kernels of ``csrc/paged_attention.cu``:

- ``paged_attention_sweep``: one thread block per (row tile, KV head,
  batch row) walks the whole chain with an fp32 online softmax;
- ``paged_attention_split`` (flash-decoding): the chain splits over S
  workers that write fp32 ``(acc, m, l)`` partials; the last worker of
  each row tile merges them by log-sum-exp inside the same launch (the
  JAX package merges in jnp after its kernel).

The kernels read q ``[B, C, H, D]`` through its strides (the fused qkv
projection's view needs no copy) and fold GQA into rows themselves:
query head ``kv·G + g`` at chunk index ``c`` is row ``g·C + c`` of KV head
``kv``, so a KV head's whole query group shares each K/V block it reads.

For tensors on the CPU the wrapper runs the plain version
(``ops.attention.paged_attention_reference``); for CUDA tensors it
launches a kernel or raises. ``launch_counts`` counts each kernel's
launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops.attention import (
    check_paged_shapes,
    paged_attention_reference,
)

#: flash-decoding auto policy (``split_s=None``): split once one batch
#: row's chain is at least this many blocks
SPLIT_THRESHOLD = 8
#: the auto policy's worker-count cap (a forced ``split_s`` may exceed it)
MAX_SPLIT = 8

SWEEP = "paged_attention_sweep"
SPLIT = "paged_attention_split"
#: launches of each kernel since the last ``reset_launch_counts``
launch_counts = {SWEEP: 0, SPLIT: 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 96, 128)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def auto_split_s(w: int, b: int, *, threshold: int = SPLIT_THRESHOLD,
                 max_split: int = MAX_SPLIT) -> int:
    """Flash-decoding worker count for a ``[B, W]`` block table: 1 until
    ``W // B >= threshold`` (few long chains leave most SMs idle in a
    single sweep), then ``min(max_split, W)`` so every worker owns at
    least one block."""
    if w // max(b, 1) < threshold:
        return 1
    return min(max_split, w)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    operands = [p, i64, i64, i64, p, p, p, p, p]  # q + strides, pools, tables, qpos, out
    dims = [i, i, i, i, i, i, i, i]  # dtype, B, C, H_kv, G, D, block_len, W
    lib.pdt_paged_attention_sweep.argtypes = operands + dims + [f, p]
    lib.pdt_paged_attention_sweep.restype = i
    lib.pdt_paged_attention_split.argtypes = operands + [p, p, p, p] + dims + [i, f, p]
    lib.pdt_paged_attention_split.restype = i
    lib.pdt_paged_attention_rows_per_tile.argtypes = []
    lib.pdt_paged_attention_rows_per_tile.restype = i
    lib.pdt_cuda_error_string.argtypes = [i]
    lib.pdt_cuda_error_string.restype = ctypes.c_char_p


def _library() -> ctypes.CDLL:
    return _build.load_library("paged_attention", declare=_declare)


def _check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.pdt_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {code})")


def _check_cuda_operands(q, k_pool, v_pool, block_tables, q_positions) -> None:
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables),
                    ("q_positions", q_positions)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"the paged kernels take float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"q ({q.dtype}) and the pools ({k_pool.dtype}, {v_pool.dtype}) "
            "must share one dtype")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("the KV pools must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the KV pools must be 16-byte aligned")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(
            f"head dim {q.shape[-1]} unsupported: the kernels take D in {_HEAD_DIMS}")
    if block_tables.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"block_tables must be an integer tensor, got "
                        f"{block_tables.dtype}")


def paged_flash_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    q_positions: torch.Tensor,
    *,
    scale: Optional[float] = None,
    split_s: Optional[int] = None,
) -> torch.Tensor:
    """Attention of ``q [B, C, H, D]`` against the pools
    ``[n_blocks, block_len, H_kv, D]`` through ``block_tables [B, W]``,
    key position j visible to query i iff ``j <= q_positions[b, i]``.

    ``split_s``: None = ``auto_split_s(W, B)``, 1 = the single sweep,
    S > 1 = S flash-decoding workers (clipped to W). The split's merge
    sums in another order than the sweep, so the two agree to a
    tolerance (1e-3 in fp32), not bit for bit.

    CPU tensors run ``paged_attention_reference``; CUDA tensors launch a
    kernel or raise. Returns ``[B, C, H, D]`` in q's dtype.
    """
    check_paged_shapes(q, k_pool, v_pool, block_tables, q_positions)
    if split_s is not None and split_s < 1:
        raise ValueError(f"split_s must be >= 1, got {split_s}")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         q_positions, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention runs on cuda or cpu, not {q.device}")
    _check_cuda_operands(q, k_pool, v_pool, block_tables, q_positions)
    b, _, _, d = q.shape
    w = block_tables.shape[1]
    scale = scale if scale is not None else d ** -0.5
    s_workers = min(split_s if split_s is not None else auto_split_s(w, b), w)
    if q.stride(-1) != 1:
        q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    qpos = q_positions.to(torch.int32).contiguous()
    if s_workers == 1:
        return launch_sweep(q, k_pool, v_pool, tables, qpos, scale)
    return launch_split(q, k_pool, v_pool, tables, qpos, s_workers, scale)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _operands(q, k_pool, v_pool, tables, qpos, out) -> List:
    return [_ptr(q), q.stride(0), q.stride(1), q.stride(2), _ptr(k_pool),
            _ptr(v_pool), _ptr(tables), _ptr(qpos), _ptr(out)]


def _dims(q, k_pool, tables) -> List[int]:
    b, c, h, d = q.shape
    h_kv = k_pool.shape[2]
    return [_DTYPE_CODES[q.dtype], b, c, h_kv, h // h_kv, d, k_pool.shape[1],
            tables.shape[1]]


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch_sweep(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 tables: torch.Tensor, qpos: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """One launch of the single-sweep kernel. ``q [B, C, H, D]`` may be a
    strided view with unit stride in D; int32 ``tables [B, W]`` and
    ``qpos [B, C]`` are contiguous; all on one card
    (``paged_flash_attention`` checks and prepares them). Returns
    ``[B, C, H, D]`` in q's dtype."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _library()
    code = lib.pdt_paged_attention_sweep(
        *_operands(q, k_pool, v_pool, tables, qpos, out),
        *_dims(q, k_pool, tables), float(scale), _stream(q))
    _check_launch(lib, SWEEP, code)
    launch_counts[SWEEP] += 1
    return out


def launch_split(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 tables: torch.Tensor, qpos: torch.Tensor, s_workers: int,
                 scale: float) -> torch.Tensor:
    """One launch of the flash-decoding kernel (operands as
    ``launch_sweep``, ``1 <= s_workers <= W``). Its fp32 partials go to
    scratch, and the last worker of each row tile merges them into the
    output. Returns ``[B, C, H, D]`` in q's dtype."""
    b, c, h, d = q.shape
    h_kv = k_pool.shape[2]
    rows = (h // h_kv) * c
    lib = _library()
    row_tiles = -(-rows // lib.pdt_paged_attention_rows_per_tile())
    f32 = dict(device=q.device, dtype=torch.float32)
    acc = torch.empty((b, h_kv, s_workers, rows, d), **f32)
    m = torch.empty((b, h_kv, s_workers, rows), **f32)
    l = torch.empty((b, h_kv, s_workers, rows), **f32)
    tickets = torch.zeros((b, h_kv, row_tiles), dtype=torch.int32, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    code = lib.pdt_paged_attention_split(
        *_operands(q, k_pool, v_pool, tables, qpos, out),
        _ptr(acc), _ptr(m), _ptr(l), _ptr(tickets),
        *_dims(q, k_pool, tables), s_workers, float(scale), _stream(q))
    _check_launch(lib, SPLIT, code)
    launch_counts[SPLIT] += 1
    return out
