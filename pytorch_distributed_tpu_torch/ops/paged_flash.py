"""Paged attention and quantize-on-scatter through the hand-written CUDA
kernels.

The port of ``pytorch_distributed_tpu/ops/paged_flash.py``. Three kernels
of ``csrc/paged_attention.cu``:

- ``paged_attention_sweep``: one thread block per (row tile, KV head,
  batch row) walks the whole chain with an fp32 online softmax. bf16 q on
  bf16, int8 and fp8 pools runs ``paged_sweep_tc_kernel`` (``sweep_kernel``
  decides): its products on tensor cores, the pool blocks landed by TMA
  through a ring of stages, a row tile holding all ``G·C`` rows of a KV
  head up to 64; other operands run the CUDA-core walk;
- ``paged_attention_split`` (flash-decoding): the chain splits over S
  workers that write fp32 ``(acc, m, l)`` partials; the last worker of
  each row tile merges them by log-sum-exp inside the same launch (the
  JAX package merges in jnp after its kernel). The operands that the sweep
  runs on tensor cores run ``paged_split_tc_kernel``: the same tensor-core
  body over one worker's span of the chain, in small blocks (two consumer
  warps, 32-row tiles, a two-stage ring) that all fit on the card at once;
  others the CUDA-core walk. Its scratch (``split_buffers``) is kept per
  card and stream, so a call is one launch;
- ``paged_quantize_scatter``: writes a chunk's K/V rows into quantized
  pools, computing each row's per-head scale inside the write. With bf16
  q the tensor-core sweep and split do this work themselves, before they
  read the rows: ``paged_quantize_scatter_attention`` (the append route),
  one launch a layer where the scatter and the attention took two.

Both attention kernels read float pools (q's dtype) or quantized pools
(int8 with fp32 scales, fp8 e4m3/e5m2 with int8 exponents). What bounds
them is the attended chain's bytes over the card's 3.35 TB/s: on a
quantized pool its one-byte codes and a scale a row, about half a bf16
chain. On tensor cores (bf16 q) the codes land by TMA as they are, half a
bf16 stage's bytes, and widen exactly to bf16 inside the products; the
scales stay outside them: each key's K scale multiplies its column of S,
and its V scale multiplies p, which goes to PV as two bf16 terms (hi =
bf16(p·vs), lo = bf16(p·vs − hi)), ~16 bits where the reference keeps
fp32. The walk (fp32 q) dequantizes each row to fp32 as it loads it and
keeps p in fp32. They read q ``[B, C, H, D]`` through its
strides (the fused qkv projection's view needs no copy) and fold GQA into
rows themselves: query head ``kv·G + g`` at chunk index ``c`` is row
``g·C + c`` of KV head ``kv``, so a KV head's whole query group shares
each K/V block it reads.

For tensors on the CPU each wrapper runs its plain version
(``ops.attention.paged_attention_reference``,
``paged_quantize_scatter_reference``); for CUDA tensors it launches a
kernel or raises. ``launch_counts`` counts the attention kernels'
launches on float pools, ``quant_launch_counts`` each kernel's launches on
each quantized pool dtype, ``route_launch_counts`` the sweep's and the
split's launches by route (``route_key``: tensor cores or the walk),
whatever the pool, and among them those that also wrote the new rows
(``append_key``, per pool dtype); nothing else adds to them but a CUDA
graph's replay, which adds the launches its capture recorded
(``launch_snapshot``, ``launches_since``, ``add_launches``: the serving
engine keeps them true under replay).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops.attention import (
    check_paged_shapes,
    check_scales,
    paged_attention_reference,
)

#: flash-decoding auto policy (``split_s=None``): split once one batch
#: row's chain is at least this many blocks
SPLIT_THRESHOLD = 8
#: the auto policy's worker-count cap (a forced ``split_s`` may exceed it)
MAX_SPLIT = 8

SWEEP = "paged_attention_sweep"
SPLIT = "paged_attention_split"
QUANTIZE = "paged_quantize_scatter"
#: quantized pool dtypes by their ``kv_dtype`` name, with the kernels' code
POOL_NAMES = {torch.int8: "int8", torch.float8_e4m3fn: "fp8",
              torch.float8_e5m2: "fp8_e5m2"}
_POOL_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}
#: launches of the attention kernels on float pools since the last
#: ``reset_launch_counts``
launch_counts = {SWEEP: 0, SPLIT: 0}
#: launches of each kernel on each quantized pool dtype (``variant``)
quant_launch_counts = {f"{k}[{kv}]": 0 for k in (SWEEP, SPLIT, QUANTIZE)
                       for kv in POOL_NAMES.values()}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 96, 128)
#: head dims of the kernels on quantized pools (fewer instantiations to build)
_QUANT_HEAD_DIMS = (64, 128)

#: the single sweep's two kernels (``sweep_kernel``)
TENSOR_CORES = "tensor_cores"
CUDA_CORES = "cuda_cores"
#: the pool dtypes of the tensor-core kernels: bf16, and the quantized
#: pools, whose codes are exact in bf16
TC_POOL_DTYPES = (torch.bfloat16, torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)


def route_key(kernel: str, route: str) -> str:
    """The ``route_launch_counts`` key of ``kernel`` (``SWEEP`` or
    ``SPLIT``) on ``route`` (``TENSOR_CORES`` or ``CUDA_CORES``)."""
    return f"{kernel}@{route}"


#: the append route: a tensor-core sweep or split that also quantizes the
#: chunk's new K/V rows into the pools before it reads them (kernel 9's work)
APPEND = "append"


def append_key(kernel: str, pool_dtype: torch.dtype) -> str:
    """The ``route_launch_counts`` key of ``kernel`` (``SWEEP`` or
    ``SPLIT``) on the append route, on a quantized pool dtype."""
    return f"{kernel}@{APPEND}[{POOL_NAMES[pool_dtype]}]"


#: launches of the sweep and the split by route, on any pool, and those of
#: them on the append route by pool dtype
route_launch_counts = {**{route_key(k, r): 0 for k in (SWEEP, SPLIT)
                          for r in (TENSOR_CORES, CUDA_CORES)},
                       **{append_key(k, dt): 0 for k in (SWEEP, SPLIT) for dt in POOL_NAMES}}
#: the tensor-core sweep: query rows of a thread block; with the split,
#: chain keys of a ring stage and the head dims (one or two 64-column TMA
#: boxes, the 128-byte swizzle's span)
TC_TILE_ROWS = 64
#: the tensor-core split's row tile (two consumer warps: small blocks, six
#: an SM)
TC_SPLIT_TILE_ROWS = 32
TC_STAGE_KEYS = 64
TC_HEAD_DIMS = (64, 128)


def variant(kernel: str, pool_dtype: torch.dtype) -> str:
    """The ``quant_launch_counts`` key of ``kernel`` on a quantized pool."""
    return f"{kernel}[{POOL_NAMES[pool_dtype]}]"


def sweep_kernel(q_dtype: torch.dtype, pool_dtype: torch.dtype, d: int,
                 block_len: int) -> str:
    """Which kernel runs the single sweep, and the split (the same rule, at
    every row count: rows past a row tile take further ones):
    ``TENSOR_CORES`` for bf16 q on bf16, int8, fp8 e4m3 or fp8 e5m2 pools
    (``TC_POOL_DTYPES``) with D in ``TC_HEAD_DIMS`` and a block length
    that a 64-key stage takes in whole TMA boxes of at least 8 rows (8, 16,
    32, or a multiple of 64); else ``CUDA_CORES``: fp32 q and fp32 pools,
    and the other head dims and block lengths.

    On quantized pools the tensor cores multiply the codes themselves,
    each widened exactly to bf16, and keep the scales outside the
    products: S takes each key's K scale after QKᵀ, and PV takes p times
    each key's V scale as two bf16 terms, hi and lo. That is the
    reference's ``(q·scale)·(k·ks)`` up to fp32 summation order, and its
    fp32 ``p·(v·vs)`` to ~16 bits of p."""
    whole_boxes = (8 <= block_len and TC_STAGE_KEYS % block_len == 0
                   or block_len % TC_STAGE_KEYS == 0)
    if (q_dtype == torch.bfloat16 and pool_dtype in TC_POOL_DTYPES
            and d in TC_HEAD_DIMS and whole_boxes):
        return TENSOR_CORES
    return CUDA_CORES


def tc_row_tiles(rows: int) -> int:
    """Thread blocks of the tensor-core sweep per (batch row, KV head) for
    ``rows = G·C`` query rows: one holds up to ``TC_TILE_ROWS``, so at
    R <= 64 each chain byte is read once per (batch row, KV head)."""
    return -(-rows // TC_TILE_ROWS)


def pool_tensor_map_geometry(pool: torch.Tensor) -> Tuple[int, ...]:
    """The TMA tensor map of a contiguous pool ``[n_blocks, bl, H_kv, D]``
    as the tensor-core kernels read it: the pool viewed as ``[n_blocks·bl,
    H_kv, D]``, dims ``(D, H_kv, n_blocks·bl)`` innermost first, the byte
    strides of H_kv and of a row, and the box ``(cols, 1, min(bl, 64))``:
    one pool block of one KV head (or 64 rows of one). A bf16 box is 64
    columns (128 bytes; D = 128 takes two boxes); a box of one-byte codes
    (int8, fp8) is all D columns, D bytes, which the kernel maps with the
    64-byte swizzle at D 64 and the 128-byte one at D 128."""
    n_blocks, bl, h_kv, d = pool.shape
    e = pool.element_size()
    cols = d if e == 1 else 64
    return (d, h_kv, n_blocks * bl, d * e, h_kv * d * e, cols, 1, min(bl, TC_STAGE_KEYS))


def split_row_tiles(kernel: str, rows: int, walk_rows: int) -> int:
    """Row tiles of the split per (batch row, KV head) for ``rows = G·C``:
    ``TC_SPLIT_TILE_ROWS`` rows each on tensor cores, ``walk_rows`` (the
    CUDA-core walk's tile, 8) on the walk. The split takes one ticket per
    row tile."""
    tile = TC_SPLIT_TILE_ROWS if kernel == TENSOR_CORES else walk_rows
    return -(-rows // tile)


#: the split's scratch, by (card, stream): see ``split_buffers``
_split_scratch = {}


def split_buffers(key, b: int, h_kv: int, s_workers: int, rows: int, d: int,
                  row_tiles: int, device) -> Tuple[torch.Tensor, ...]:
    """The scratch of one split launch: fp32 partials ``acc [B, H_kv, S,
    R, D]``, ``m`` and ``l [B, H_kv, S, R]``, and int32 ``tickets [B·H_kv·
    row_tiles]``, as views of two buffers kept per ``key`` (the card and
    the stream). A kernel reads each partial only after its worker wrote
    it in the same launch, so nothing needs clearing; the tickets are
    zeroed once, when a buffer is allocated, and every launch leaves them
    zero (the last worker of each row tile resets its own). Launches on one
    stream run in order, so each finds them zero. A buffer that grows is
    allocated anew on the caller's stream, and the caching allocator hands
    the old one's memory only to work ordered after it on that stream."""
    n = b * h_kv * s_workers * rows
    bufs = _split_scratch.setdefault(key, {})
    grow = [bufs.get("partials") is None or bufs["partials"].numel() < n * (d + 2),
            bufs.get("tickets") is None or bufs["tickets"].numel() < b * h_kv * row_tiles]
    if any(grow) and torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the split's scratch must be sized before a CUDA graph capture "
                           "(reserve_split_buffers), not allocated inside it")
    if grow[0]:
        bufs["partials"] = torch.empty(n * (d + 2), dtype=torch.float32, device=device)
    if grow[1]:
        bufs["tickets"] = torch.zeros(b * h_kv * row_tiles, dtype=torch.int32, device=device)
    part = bufs["partials"]
    shape = (b, h_kv, s_workers, rows)
    return (part[:n * d].view(*shape, d), part[n * d:n * (d + 1)].view(shape),
            part[n * (d + 1):n * (d + 2)].view(shape), bufs["tickets"][:b * h_kv * row_tiles])


def reserve_split_buffers(stream: int, device, q_dtype: torch.dtype, pool: torch.Tensor,
                          calls) -> None:
    """Size the split's scratch of ``(device, stream)`` for every call in
    ``calls``, each ``(B, C, H, W, split_s)`` of q ``[B, C, H, D]`` over
    ``pool``'s geometry with a ``[B, W]`` table, before a CUDA graph is
    captured on ``stream`` (``cuda_stream``), so no buffer is allocated
    inside the capture: the graphs then share the largest."""
    lib = _library()
    _, bl, h_kv, d = pool.shape
    kernel = sweep_kernel(q_dtype, pool.dtype, d, bl)
    walk_rows = lib.pdt_paged_attention_rows_per_tile()
    for b, c, h, w, split_s in calls:
        s_workers = split_workers(w, b, split_s)
        if s_workers > 1:
            rows = (h // h_kv) * c
            split_buffers((device, stream), b, h_kv, s_workers, rows, d,
                          split_row_tiles(kernel, rows, walk_rows), device)


_COUNTERS = (launch_counts, quant_launch_counts, route_launch_counts)


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0


def launch_snapshot() -> Tuple[dict, ...]:
    """Copies of the three launch counters."""
    return tuple(dict(c) for c in _COUNTERS)


def launches_since(snapshot: Tuple[dict, ...]) -> Tuple[dict, ...]:
    """What each counter gained since ``snapshot`` (nonzero keys only)."""
    return tuple({k: v - s[k] for k, v in c.items() if v != s[k]}
                 for c, s in zip(_COUNTERS, snapshot))


def restore_launches(snapshot: Tuple[dict, ...]) -> None:
    """Set the counters back to ``snapshot``: launches made since are
    not counted (a capture, an inert warm run)."""
    for c, s in zip(_COUNTERS, snapshot):
        c.update(s)


def add_launches(delta: Tuple[dict, ...]) -> None:
    """Add ``launches_since``'s gains, e.g. a graph replay's launches."""
    for c, d in zip(_COUNTERS, delta):
        for k, v in d.items():
            c[k] += v


def auto_split_s(w: int, b: int, *, threshold: int = SPLIT_THRESHOLD,
                 max_split: int = MAX_SPLIT) -> int:
    """Flash-decoding worker count for a ``[B, W]`` block table: 1 until
    ``W // B >= threshold`` (few long chains leave most SMs idle in a
    single sweep), then ``min(max_split, W)`` so every worker owns at
    least one block."""
    if w // max(b, 1) < threshold:
        return 1
    return min(max_split, w)


def split_workers(w: int, b: int, split_s: Optional[int]) -> int:
    """The worker count of a call with a ``[B, W]`` table: ``split_s``,
    or ``auto_split_s`` when it is None, clipped to W (1 = the sweep)."""
    return min(split_s if split_s is not None else auto_split_s(w, b), w)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    # q + strides, pools, scales, tables, qpos, out
    operands = [p, i64, i64, i64, p, p, p, p, p, p, p]
    dims = [i, i, i, i, i, i, i, i, i]  # dtype, pool, B, C, H_kv, G, D, block_len, W
    lib.pdt_paged_attention_sweep.argtypes = operands + dims + [f, p]
    lib.pdt_paged_attention_sweep.restype = i
    # the append route's new rows: k + strides, v + strides, their dtype
    append = [p, i64, i64, i64, p, i64, i64, i64, i]
    # q + strides, pools, scales, their tensor map geometry, tables, qpos,
    # out; pool, B, C, H_kv, G, block_len, W; scale; the new rows; stream
    lib.pdt_paged_attention_sweep_tc.argtypes = (
        [p, i64, i64, i64, p, p, p, p, ctypes.POINTER(i64), p, p, p] + [i] * 7 + [f]
        + append + [p])
    lib.pdt_paged_attention_sweep_tc.restype = i
    lib.pdt_paged_attention_split.argtypes = operands + [p, p, p, p] + dims + [i, f, p]
    lib.pdt_paged_attention_split.restype = i
    # as the tensor-core sweep, then acc, m, l, tickets; pool, B, C, H_kv,
    # G, block_len, W, S; scale; the new rows; stream
    lib.pdt_paged_attention_split_tc.argtypes = (
        [p, i64, i64, i64, p, p, p, p, ctypes.POINTER(i64), p, p, p, p, p, p, p]
        + [i] * 8 + [f] + append + [p])
    lib.pdt_paged_attention_split_tc.restype = i
    lib.pdt_paged_attention_rows_per_tile.argtypes = []
    lib.pdt_paged_attention_rows_per_tile.restype = i
    # k, v + strides; blk, off; the four pools; dtype, pool, N, L, H_kv, D, block_len
    lib.pdt_paged_quantize_scatter.argtypes = (
        [p, i64, i64, i64, p, i64, i64, i64, p, p, p, p, p, p] + [i] * 7 + [p])
    lib.pdt_paged_quantize_scatter.restype = i
    lib.pdt_cuda_error_string.argtypes = [i]
    lib.pdt_cuda_error_string.restype = ctypes.c_char_p


def _library() -> ctypes.CDLL:
    return _build.load_library("paged_attention", declare=_declare)


def _check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.pdt_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {code})")


def _check_pools(dev, d: int, tensors, k_pool, v_pool, k_scale) -> None:
    """Device, dtype, layout and head-dim checks the kernels share."""
    for name, t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    quantized = k_scale is not None
    dims = _QUANT_HEAD_DIMS if quantized else _HEAD_DIMS
    if d not in dims:
        raise ValueError(f"head dim {d} unsupported: the kernels take D in {dims}"
                         f"{' on quantized pools' if quantized else ''}")
    for name, t in tensors:
        if name.endswith(("pool", "scale")) and t is not None:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")


def _check_cuda_operands(q, k_pool, v_pool, block_tables, q_positions,
                         k_scale, v_scale) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the paged kernels take float32 or bfloat16 q, got {q.dtype}")
    if k_pool.dtype != v_pool.dtype:
        raise TypeError(f"k_pool ({k_pool.dtype}) and v_pool ({v_pool.dtype}) differ")
    if k_scale is None and k_pool.dtype != q.dtype:
        raise TypeError(
            f"q ({q.dtype}) and the float pools ({k_pool.dtype}) must share one "
            "dtype; quantized pools are int8, float8_e4m3fn or float8_e5m2")
    _check_pools(q.device, q.shape[-1],
                 (("k_pool", k_pool), ("v_pool", v_pool),
                  ("block_tables", block_tables), ("q_positions", q_positions),
                  ("k_scale", k_scale), ("v_scale", v_scale)),
                 k_pool, v_pool, k_scale)
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
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention of ``q [B, C, H, D]`` against the pools
    ``[n_blocks, block_len, H_kv, D]`` through ``block_tables [B, W]``,
    key position j visible to query i iff ``j <= q_positions[b, i]``.

    ``split_s``: None = ``auto_split_s(W, B)``, 1 = the single sweep,
    S > 1 = S flash-decoding workers (clipped to W). The split's merge
    sums in another order than the sweep, so the two agree to a
    tolerance (1e-3 in fp32), not bit for bit.

    ``k_scale``/``v_scale`` ``[n_blocks, block_len, H_kv]``: the scales of
    quantized pools (``serving.kv_pool`` layout), None for float pools.
    On quantized pools the Pallas body dequantizes V to fp32 and keeps p
    in fp32 for PV. The tensor-core kernels (bf16 q, ``sweep_kernel``)
    multiply the codes, exact in bf16, and keep each key's scales outside
    the products, with p·vs in two bf16 terms (~16 bits); the walk (fp32
    q) dequantizes each row to fp32 and keeps p in fp32. On float pools p
    is rounded to the pools' dtype.

    CPU tensors run ``paged_attention_reference``; CUDA tensors launch a
    kernel or raise. Returns ``[B, C, H, D]`` in q's dtype.
    """
    check_paged_shapes(q, k_pool, v_pool, block_tables, q_positions)
    check_scales(k_pool, k_scale, v_scale)
    if split_s is not None and split_s < 1:
        raise ValueError(f"split_s must be >= 1, got {split_s}")
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pool, v_pool, block_tables,
                                         q_positions, scale=scale,
                                         k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_attention runs on cuda or cpu, not {q.device}")
    return _launch(q, k_pool, v_pool, block_tables, q_positions, scale, split_s,
                   k_scale, v_scale)


def _launch(q, k_pool, v_pool, block_tables, q_positions, scale, split_s, k_scale,
            v_scale, new=None) -> torch.Tensor:
    """One launch of the sweep or the split for CUDA operands (checked
    and prepared here), with the append route's new rows ``new = (k, v)``
    or without (None)."""
    _check_cuda_operands(q, k_pool, v_pool, block_tables, q_positions,
                         k_scale, v_scale)
    b, _, _, d = q.shape
    w = block_tables.shape[1]
    scale = scale if scale is not None else d ** -0.5
    s_workers = split_workers(w, b, split_s)
    if q.stride(-1) != 1:
        q = q.contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    qpos = q_positions.to(torch.int32).contiguous()
    if s_workers == 1:
        return launch_sweep(q, k_pool, v_pool, tables, qpos, scale,
                            k_scale=k_scale, v_scale=v_scale, new=new)
    return launch_split(q, k_pool, v_pool, tables, qpos, s_workers, scale,
                        k_scale=k_scale, v_scale=v_scale, new=new)


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _operands(q, k_pool, v_pool, k_scale, v_scale, tables, qpos, out) -> List:
    return [_ptr(q), q.stride(0), q.stride(1), q.stride(2), _ptr(k_pool),
            _ptr(v_pool), _ptr(k_scale), _ptr(v_scale), _ptr(tables), _ptr(qpos),
            _ptr(out)]


def _pool_code(k_pool: torch.Tensor, k_scale) -> int:
    return 0 if k_scale is None else _POOL_CODES[k_pool.dtype]


def _dims(q, k_pool, k_scale, tables) -> List[int]:
    b, c, h, d = q.shape
    h_kv = k_pool.shape[2]
    return [_DTYPE_CODES[q.dtype], _pool_code(k_pool, k_scale), b, c, h_kv,
            h // h_kv, d, k_pool.shape[1], tables.shape[1]]


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _count(kernel: str, route: str, k_pool: torch.Tensor, k_scale, appended: bool) -> None:
    if k_scale is None:
        launch_counts[kernel] += 1
    else:
        quant_launch_counts[variant(kernel, k_pool.dtype)] += 1
    route_launch_counts[route_key(kernel, route)] += 1
    if appended:
        route_launch_counts[append_key(kernel, k_pool.dtype)] += 1


def _new_rows(new) -> List:
    """The tensor-core entry points' append operands: the new rows ``k``,
    ``v`` with their (batch, chunk, head) strides and dtype code, or nulls
    when ``new`` is None (no append)."""
    if new is None:
        return [_ptr(None), 0, 0, 0, _ptr(None), 0, 0, 0, _DTYPE_CODES[torch.bfloat16]]
    k, v = new
    return [_ptr(k), *k.stride()[:3], _ptr(v), *v.stride()[:3], _DTYPE_CODES[k.dtype]]


def _check_append_route(route: str, new) -> None:
    if new is not None and route != TENSOR_CORES:
        raise ValueError("the append route runs on the tensor-core kernels only "
                         "(bf16 q on quantized pools, sweep_kernel)")


def _in_rows(x: torch.Tensor) -> torch.Tensor:
    """A new-rows operand as the append route reads it, 16 bytes a load:
    unit stride in D, 16-byte aligned rows, else a contiguous copy."""
    e = x.element_size()
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(s * e % 16 for s in x.stride()[:3]):
        return x.contiguous()
    return x


def _in_pairs(q: torch.Tensor) -> torch.Tensor:
    """q as the tensor-core kernels read it, two bf16 values a load: 4-byte
    aligned with even strides, else a contiguous copy."""
    if q.data_ptr() % 4 or any(s % 2 for s in q.stride()[:3]):
        return q.contiguous()
    return q


def launch_sweep(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 tables: torch.Tensor, qpos: torch.Tensor, scale: float, *,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 new: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """One launch of the single-sweep kernel that ``sweep_kernel`` picks.
    ``q [B, C, H, D]`` may be a strided view with unit stride in D; int32
    ``tables [B, W]`` and ``qpos [B, C]`` are contiguous; all on one card
    (``paged_flash_attention`` checks and prepares them). ``new = (k, v)``
    (``[B, C, H_kv, D]``, 16-byte aligned rows: ``_in_rows``) takes the
    append route: the launch first writes row ``(b, c)`` into the quantized
    pools at position ``qpos[b, c]``. Returns ``[B, C, H, D]`` in q's
    dtype."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _library()
    b, c, h, d = q.shape
    _, bl, h_kv, _ = k_pool.shape
    route = sweep_kernel(q.dtype, k_pool.dtype, d, bl)
    _check_append_route(route, new)
    if route == TENSOR_CORES:
        q = _in_pairs(q)
        geometry = (ctypes.c_int64 * 8)(*pool_tensor_map_geometry(k_pool))
        code = lib.pdt_paged_attention_sweep_tc(
            _ptr(q), q.stride(0), q.stride(1), q.stride(2), _ptr(k_pool), _ptr(v_pool),
            _ptr(k_scale), _ptr(v_scale), geometry, _ptr(tables), _ptr(qpos), _ptr(out),
            _pool_code(k_pool, k_scale), b, c, h_kv, h // h_kv, bl, tables.shape[1],
            float(scale), *_new_rows(new), _stream(q))
    else:
        code = lib.pdt_paged_attention_sweep(
            *_operands(q, k_pool, v_pool, k_scale, v_scale, tables, qpos, out),
            *_dims(q, k_pool, k_scale, tables), float(scale), _stream(q))
    _check_launch(lib, SWEEP, code)
    _count(SWEEP, route, k_pool, k_scale, new is not None)
    return out


def launch_split(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 tables: torch.Tensor, qpos: torch.Tensor, s_workers: int,
                 scale: float, *, k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 new: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """One launch of the flash-decoding kernel that ``sweep_kernel`` picks
    (operands, and the append route, as ``launch_sweep``, ``1 <= s_workers
    <= W``). Its fp32 partials go to ``split_buffers``' scratch, and the
    last worker of each row tile merges them into the output. Returns
    ``[B, C, H, D]`` in q's dtype."""
    b, c, h, d = q.shape
    _, bl, h_kv, _ = k_pool.shape
    rows = (h // h_kv) * c
    lib = _library()
    kernel = sweep_kernel(q.dtype, k_pool.dtype, d, bl)
    _check_append_route(kernel, new)
    if kernel == TENSOR_CORES:
        q = _in_pairs(q)
    stream = _stream(q)
    acc, m, l, tickets = split_buffers(
        (q.device, stream.value), b, h_kv, s_workers, rows, d,
        split_row_tiles(kernel, rows, lib.pdt_paged_attention_rows_per_tile()), q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if kernel == TENSOR_CORES:
        geometry = (ctypes.c_int64 * 8)(*pool_tensor_map_geometry(k_pool))
        code = lib.pdt_paged_attention_split_tc(
            _ptr(q), q.stride(0), q.stride(1), q.stride(2), _ptr(k_pool), _ptr(v_pool),
            _ptr(k_scale), _ptr(v_scale), geometry, _ptr(tables), _ptr(qpos), _ptr(out),
            _ptr(acc), _ptr(m), _ptr(l), _ptr(tickets), _pool_code(k_pool, k_scale), b, c,
            h_kv, h // h_kv, bl, tables.shape[1], s_workers, float(scale), *_new_rows(new),
            stream)
    else:
        code = lib.pdt_paged_attention_split(
            *_operands(q, k_pool, v_pool, k_scale, v_scale, tables, qpos, out),
            _ptr(acc), _ptr(m), _ptr(l), _ptr(tickets),
            *_dims(q, k_pool, k_scale, tables), s_workers, float(scale), stream)
    _check_launch(lib, SPLIT, code)
    _count(SPLIT, kernel, k_pool, k_scale, new is not None)
    return out


# ---------------------------------------------------------------------------
# quantize-on-scatter (kernel 9)
# ---------------------------------------------------------------------------


def paged_quantize_scatter_reference(k, v, blk, off, k_pool, v_pool, k_scale,
                                     v_scale) -> None:
    """The plain version: ``serving.kv_pool.quantize_kv`` of each chunk,
    then four ``index_put_`` writes at ``(blk, off)``, in place."""
    from pytorch_distributed_tpu_torch.serving.kv_pool import quantize_kv

    for x, pool, scales in ((k, k_pool, k_scale), (v, v_pool, v_scale)):
        xq, xs = quantize_kv(x, pool.dtype)
        pool[blk, off] = xq
        scales[blk, off] = xs


def paged_quantize_scatter(k: torch.Tensor, v: torch.Tensor, blk: torch.Tensor,
                           off: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor) -> None:
    """Write the chunk's K/V rows ``k, v [B, L, H_kv, D]`` (float32 or
    bfloat16, strided views with unit stride in D) into the quantized
    pools in place: row ``(b, l)`` goes to pool block ``blk[b, l]`` at
    offset ``off[b, l]``, with its per-head scale (``quantize_rows``) in
    ``k_scale``/``v_scale`` at the same place. Bit-identical to the plain
    version. Duplicate destinations come only from inactive lanes writing
    the trash block, where any order is harmless.

    CPU tensors run ``paged_quantize_scatter_reference``; CUDA tensors
    launch the kernel or raise."""
    from pytorch_distributed_tpu_torch.serving.kv_pool import is_quantized_pool

    if not is_quantized_pool(k_pool.dtype):
        raise ValueError(f"paged_quantize_scatter writes quantized pools "
                         f"(int8/fp8), got {k_pool.dtype}")
    check_scales(k_pool, k_scale, v_scale)
    if k.dim() != 4 or k.shape != v.shape or tuple(k.shape[2:]) != tuple(k_pool.shape[2:]):
        raise ValueError(f"k, v must be [B, L, H_kv={k_pool.shape[2]}, "
                         f"D={k_pool.shape[3]}], got {tuple(k.shape)}, {tuple(v.shape)}")
    if tuple(blk.shape) != tuple(k.shape[:2]) or tuple(off.shape) != tuple(k.shape[:2]):
        raise ValueError(f"blk and off must be [B, L] = {tuple(k.shape[:2])}")
    if k.device.type == "cpu":
        paged_quantize_scatter_reference(k, v, blk, off, k_pool, v_pool,
                                         k_scale, v_scale)
        return
    if k.device.type != "cuda":
        raise ValueError(f"paged_quantize_scatter runs on cuda or cpu, not {k.device}")
    if k.dtype not in _DTYPE_CODES or v.dtype != k.dtype:
        raise TypeError(f"k and v must share float32 or bfloat16, got {k.dtype}, {v.dtype}")
    _check_pools(k.device, k.shape[-1],
                 (("v", v), ("blk", blk), ("off", off), ("k_pool", k_pool),
                  ("v_pool", v_pool), ("k_scale", k_scale), ("v_scale", v_scale)),
                 k_pool, v_pool, k_scale)
    if k.stride(-1) != 1:
        k = k.contiguous()
    if v.stride(-1) != 1:
        v = v.contiguous()
    launch_quantize_scatter(k, v, blk.to(torch.int64).contiguous(),
                            off.to(torch.int64).contiguous(), k_pool, v_pool,
                            k_scale, v_scale)


def launch_quantize_scatter(k, v, blk, off, k_pool, v_pool, k_scale,
                            v_scale) -> None:
    """One launch of the quantize-on-scatter kernel on operands that
    ``paged_quantize_scatter`` checked (int64 contiguous ``blk``/``off``)."""
    b, l, h_kv, d = k.shape
    lib = _library()
    code = lib.pdt_paged_quantize_scatter(
        _ptr(k), k.stride(0), k.stride(1), k.stride(2),
        _ptr(v), v.stride(0), v.stride(1), v.stride(2),
        _ptr(blk), _ptr(off), _ptr(k_pool), _ptr(v_pool), _ptr(k_scale),
        _ptr(v_scale), _DTYPE_CODES[k.dtype], _POOL_CODES[k_pool.dtype],
        b * l, l, h_kv, d, k_pool.shape[1], _stream(k))
    _check_launch(lib, QUANTIZE, code)
    quant_launch_counts[variant(QUANTIZE, k_pool.dtype)] += 1


# ---------------------------------------------------------------------------
# the scatter, then the attention: the append route
# ---------------------------------------------------------------------------


def append_destinations(block_tables: torch.Tensor, q_positions: torch.Tensor,
                        block_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where row ``(b, c)`` of a chunk goes: pool block ``blk = tables[b,
    pos // block_len]`` at slot ``off = pos % block_len``, ``pos =
    q_positions[b, c]``, as ``models.transformer.PagedIndex.build`` derives
    them (the kernels compute the same in place). A negative position
    (a padding row) reads as 0 here: no route writes such a row where
    this points. Returns int64 ``(blk, off)``, each ``[B, C]``."""
    pos = q_positions.long().clamp_min(0)
    blk = torch.gather(block_tables.to(pos.device).long(), 1, pos // block_len)
    return blk, pos % block_len


def paged_quantize_scatter_attention_reference(q, k, v, k_pool, v_pool, k_scale, v_scale,
                                               block_tables, q_positions, *,
                                               scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: each row with a non-negative position written by
    ``paged_quantize_scatter_reference`` at ``append_destinations``, then
    ``paged_attention_reference`` over the pools (in place, as the
    kernels)."""
    blk, off = append_destinations(block_tables, q_positions, k_pool.shape[1])
    keep = q_positions >= 0
    paged_quantize_scatter_reference(k[keep], v[keep], blk[keep], off[keep], k_pool, v_pool,
                                     k_scale, v_scale)
    return paged_attention_reference(q, k_pool, v_pool, block_tables, q_positions,
                                     scale=scale, k_scale=k_scale, v_scale=v_scale)


def paged_quantize_scatter_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    q_positions: torch.Tensor,
    *,
    scale: Optional[float] = None,
    split_s: Optional[int] = None,
) -> torch.Tensor:
    """The scatter, then the attention, as a quantized layer's serving
    step runs them: the chunk's new rows ``k, v [B, C, H_kv, D]`` (float32
    or bfloat16, strided views welcome) quantized into the pools in place,
    row ``(b, c)`` at its position ``q_positions[b, c]``
    (``append_destinations``), with ``paged_quantize_scatter``'s bits;
    then ``paged_flash_attention`` of ``q`` over the pools, the new rows
    included. A row with a negative position (a padding row) comes out 0
    and writes nothing (on the two-launch route: into the trash block).

    CPU tensors run the plain version. CUDA tensors take one route:
    - bf16 q on the tensor-core kernels' pools and shapes
      (``sweep_kernel``): the append route, ONE launch of the tensor-core
      sweep (``split_s`` 1) or split, whose blocks quantize and store the
      rows of their keys before they read them; counted under its kernel,
      its route and ``append_key``;
    - else (fp32 q, the walk's shapes): ``scatter_then_attend``, kernel 9
      then the attention kernel.
    A failed build or launch raises; nothing falls back to another route.
    Returns ``[B, C, H, D]`` in q's dtype."""
    from pytorch_distributed_tpu_torch.serving.kv_pool import is_quantized_pool

    check_paged_shapes(q, k_pool, v_pool, block_tables, q_positions)
    check_scales(k_pool, k_scale, v_scale)
    if not is_quantized_pool(k_pool.dtype):
        raise ValueError(f"paged_quantize_scatter_attention writes quantized pools "
                         f"(int8/fp8), got {k_pool.dtype}")
    b, c, _, d = q.shape
    want = (b, c, k_pool.shape[2], d)
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"k, v must be [B, C, H_kv, D] = {want}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if split_s is not None and split_s < 1:
        raise ValueError(f"split_s must be >= 1, got {split_s}")
    if q.device.type == "cpu":
        return paged_quantize_scatter_attention_reference(
            q, k, v, k_pool, v_pool, k_scale, v_scale, block_tables, q_positions, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_quantize_scatter_attention runs on cuda or cpu, not {q.device}")
    if sweep_kernel(q.dtype, k_pool.dtype, d, k_pool.shape[1]) != TENSOR_CORES:
        return scatter_then_attend(q, k, v, k_pool, v_pool, k_scale, v_scale, block_tables,
                                   q_positions, scale=scale, split_s=split_s)
    if k.dtype not in _DTYPE_CODES or v.dtype != k.dtype:
        raise TypeError(f"k and v must share float32 or bfloat16, got {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    return _launch(q, k_pool, v_pool, block_tables, q_positions, scale, split_s, k_scale,
                   v_scale, new=(_in_rows(k), _in_rows(v)))


def scatter_then_attend(q, k, v, k_pool, v_pool, k_scale, v_scale, block_tables,
                        q_positions, *, scale: Optional[float] = None,
                        split_s: Optional[int] = None) -> torch.Tensor:
    """The two-launch spelling of ``paged_quantize_scatter_attention``:
    ``paged_quantize_scatter`` (kernel 9) at ``append_destinations``, then
    ``paged_flash_attention``. It is that op's route for fp32 q and the
    walk's shapes, and the append route's yardstick. A padding row
    (negative position) is written into the trash block's slot 0, where
    clashes are harmless (the engine's inactive lanes write there too),
    so the route stays on the device, never waiting for the card."""
    from pytorch_distributed_tpu_torch.serving.kv_pool import TRASH_BLOCK

    blk, off = append_destinations(block_tables, q_positions, k_pool.shape[1])
    pad = q_positions.to(blk.device) < 0
    paged_quantize_scatter(k, v, blk.masked_fill(pad, TRASH_BLOCK), off.masked_fill(pad, 0),
                           k_pool, v_pool, k_scale, v_scale)
    return paged_flash_attention(q, k_pool, v_pool, block_tables, q_positions, scale=scale,
                                 split_s=split_s, k_scale=k_scale, v_scale=v_scale)
