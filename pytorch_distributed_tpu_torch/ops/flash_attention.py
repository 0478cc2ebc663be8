"""FlashAttention through the hand-written CUDA kernels.

The port of ``pytorch_distributed_tpu/ops/flash_attention.py``'s
``flash_attention`` with both of its backwards (``bwd_impl="fused"``, the
default, or ``"split"``), as a ``torch.autograd.Function``. Four kernels of
``csrc/flash_attention.cu``:

- ``flash_attention_fwd`` (the TPU's ``_flash_fwd``): O in the input dtype
  and the row log-sum-exp LSE ``[B, H, Lq]`` fp32;
- ``flash_attention_bwd`` (the TPU's ``_flash_bwd_fused``): dK, dV and dQ
  in one pass over the visible (q, k) tiles, dQ summed in fp32 across key
  tiles, which is the JAX kernel's ``partials_f32=True``. The key tiles
  add their dQ tiles in a fixed order (per-tile counters, ``dq_workspace``),
  so two launches give the same bits. Δ = rowsum(dO ⊙ O) and the final dQ
  cast are torch ops around it, as they are XLA ops around the Pallas
  kernel;
- ``flash_attention_bwd_dkv`` and ``flash_attention_bwd_dq`` (the TPU's
  split ``_flash_bwd``, ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``): dK, dV
  with one block per key tile (the fused kernel's code without its dQ
  pass), and dQ with one block per query tile, each written once in the
  input dtype. The ring runs them per visit with ``bwd_impl="split"``.

In bf16 the forward and both dK/dV passes are ``wgmma`` kernels fed by
TMA: each operand reaches the kernel as a tensor map over its own strides,
whose geometry ``tensor_map_geometry`` computes here; LSE and Δ reach it
as one zero-padded fp32 buffer (``row_stats``). fp32 inputs run CUDA-core
kernels from the same C functions.

Both backwards take an optional precomputed Δ ``[B, H, Lq]`` fp32: the ring
computes it once from the final O, not once per visit.

Beside each kernel is its plain version (``flash_forward_reference``,
``flash_backward_reference``): the same arithmetic and rounding on whole
``[B, H, Lq, Lk]`` tensors, the backward written out from the formula of
``_masked_p_ds`` (not autograd through ``dense_attention``). The wrappers
run the plain version for tensors on the CPU; for CUDA tensors they launch
a kernel or raise. ``launch_counts`` counts each kernel's launches and
nothing else.

Shapes follow the JAX package: q ``[B, Lq, H, D]``, k and v ``[B, Lk, H,
D]``. The kernels read them through their strides, so the fused qkv
projection's views need no copy, and mask keys past Lk themselves, so any
length works without padding. ``q_offset``/``k_offset`` shift the causal
diagonal (key j visible to query i iff ``k_offset + j <= q_offset + i``),
which makes fully masked rows: they give O = 0, LSE = NEG_INF and zero
gradients.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.ops.attention import NEG_INF, causal_mask

FWD = "flash_attention_fwd"
BWD = "flash_attention_bwd"
BWD_DKV = "flash_attention_bwd_dkv"
BWD_DQ = "flash_attention_bwd_dq"
#: launches of each kernel since the last ``reset_launch_counts``
launch_counts = {FWD: 0, BWD: 0, BWD_DKV: 0, BWD_DQ: 0}
BWD_IMPLS = ("fused", "split")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
TILE = 64  # rows of a Q or K/V tile, and the TMA box's rows and columns


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _allowed(lq: int, lk: int, causal: bool, shift: int, device) -> torch.Tensor:
    if not causal:
        return torch.ones((lq, lk), dtype=torch.bool, device=device)
    return causal_mask(lq, lk, shift, 0, device)


def _scaled_logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 ``[B, H, Lq, Lk]`` logits of q scaled in its own dtype
    (``ops/flash_attention.py:75``)."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    return torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())


def flash_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool, scale: float,
                            shift: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's plain version: ``(O [B, Lq, H, D]`` in q's
    dtype, ``LSE [B, H, Lq]`` fp32). Softmax statistics in fp32, p rounded
    to V's dtype before PV, rows without a visible key 0 with LSE
    NEG_INF."""
    allowed = _allowed(q.shape[1], k.shape[1], causal, shift, q.device)
    s = _scaled_logits(q, k, scale).masked_fill(~allowed, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    lc = l.clamp_min(1e-37)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    o = pv / lc.squeeze(-1).transpose(1, 2)[..., None]
    lse = torch.where(l > 0, m + torch.log(lc), NEG_INF).squeeze(-1)
    return o.to(q.dtype), lse


def check_bwd_impl(bwd_impl: str) -> None:
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(
            f"bwd_impl {bwd_impl!r} must be 'split' (two kernels) or "
            "'fused' (single-pass dQ+dK+dV with HBM dQ partials)")


def compute_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ⊙ O) in fp32, ``[B, H, Lq]``, contiguous
    (``compute_delta``:401 of the JAX package, without its 128-lane
    broadcast)."""
    return (do.float() * o).sum(dim=-1).transpose(1, 2).contiguous()


def flash_backward_reference(q, k, v, o, lse, do, *, causal: bool, scale: float,
                             shift: int = 0, delta: Optional[torch.Tensor] = None):
    """The plain version of both backwards: ``(dq, dk, dv)`` in the inputs'
    dtypes, from P = where(mask, exp(S − LSE), 0), dP = dO·Vᵀ and
    dS = P ⊙ (dP − Δ)·scale (``_masked_p_ds``), with P in dO's dtype for
    dV, dS in q's dtype for dK and dQ, and dQ summed in fp32. The JAX
    package computes both of its backward kernels, fused and split, from
    ``_masked_p_ds``; the split's dQ is the pure-fp32 sum modelled here, and
    the fused kernel's is the same sum with ``partials_f32=True``. ``delta``
    (``[B, H, Lq]`` fp32) defaults to ``compute_delta(do, o)``."""
    allowed = _allowed(q.shape[1], k.shape[1], causal, shift, q.device)
    if delta is None:
        delta = compute_delta(do, o)
    p = torch.where(allowed, torch.exp(_scaled_logits(q, k, scale) - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dsc = ds.to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", dsc, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", dsc, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tensor_map_geometry(t: torch.Tensor) -> Tuple[int, ...]:
    """The TMA tensor map of a bf16 ``[B, L, H, D]`` operand, read through
    its strides: dims ``(D, H, L, B)`` innermost first, the byte strides of
    H, L and B, and the box ``(64, 1, 64, 1)``, one 64-row x 64-column tile
    of one (batch, head), 128 bytes a row (the 128-byte swizzle's span; D =
    128 takes two boxes, at columns 0 and 64). The fp32 kernels read only
    its dims and strides."""
    b, l, h, d = t.shape
    e = t.element_size()
    return (d, h, l, b, t.stride(2) * e, t.stride(1) * e, t.stride(0) * e, TILE, 1, TILE, 1)


def row_stats(lse: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """LSE and Δ (``[B, H, Lq]`` fp32, any strides) as the kernels read
    them: one fp32 ``[2, B·H, ceil(Lq / 64)·64]`` buffer, zero past Lq, so
    every Q tile's 64 values are one aligned bulk copy."""
    b, h, lq = lse.shape
    rows = torch.zeros((2, b, h, -(-lq // TILE) * TILE), dtype=torch.float32,
                       device=lse.device)
    rows[0, ..., :lq] = lse
    rows[1, ..., :lq] = delta
    return rows.view(2, b * h, -1)


def dq_workspace(b: int, lq: int, h: int, d: int, causal: bool, shift: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 fused backward's fp32 dQ and its int32 counters. dQ: one
    contiguous 64 x D tile per (batch·head, Q tile), ``[B·H, ceil(Lq / 64),
    64·D]``, in the kernel's thread order (``dq_from_workspace``), so a
    block adds a tile with one bulk copy; counters ``[B·H, ceil(Lq / 64)]``,
    zero, one per tile. The first key tile to add to a Q tile stores, so dQ
    needs zeros only where a Q tile sees no key at all: causal with ``shift
    < -63``, the first tile's last row then masked."""
    n_qt = -(-lq // TILE)
    zero_dq = causal and shift < -(TILE - 1)
    make = torch.zeros if zero_dq else torch.empty
    dq = make((b * h, n_qt, TILE * d), dtype=torch.float32, device=device)
    turns = torch.zeros((b * h, n_qt), dtype=torch.int32, device=device)
    return dq, turns


def dq_from_workspace(ws: torch.Tensor, b: int, lq: int, dtype: torch.dtype) -> torch.Tensor:
    """dQ ``[B, Lq, H, D]`` in ``dtype`` from ``dq_workspace``'s tiles: the
    cast, then one permuting copy. A tile holds float4 ``k = 8x + j`` of
    consumer thread ``tid = 32w + 4g + t`` at ``(k·128 + tid)·4``: rows
    ``16w + g`` and ``16w + g + 8`` of the tile, columns ``64x + 8j + 2t``
    and ``+ 1``, in the order (g, 2t), (g, 2t + 1), (g + 8, 2t),
    (g + 8, 2t + 1)."""
    bh, n_qt, size = ws.shape
    h, d = bh // b, size // TILE
    # dims: b, h, Q tile, x, j, warp, g, t, row half, column parity
    tiles = ws.to(dtype).view(b, h, n_qt, d // TILE, 8, 4, 8, 4, 2, 2)
    out = torch.empty((b, n_qt * TILE, h, d), dtype=dtype, device=ws.device)
    out.view(b, n_qt, 4, 2, 8, h, d // TILE, 8, 4, 2).copy_(
        tiles.permute(0, 2, 5, 8, 6, 1, 3, 4, 7, 9))
    return out if lq == n_qt * TILE else out[:, :lq].contiguous()


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    g = ctypes.POINTER(ctypes.c_int64)
    operand = [p, g]  # pointer and its tensor_map_geometry
    tail = [i, i, i, f, p]  # dtype, causal, shift, scale, stream
    lib.pdt_flash_fwd.argtypes = operand * 3 + [p, p] + tail
    lib.pdt_flash_fwd.restype = i
    lib.pdt_flash_bwd.argtypes = operand * 4 + [p, i, p, p, p, p] + tail
    lib.pdt_flash_bwd.restype = i
    lib.pdt_flash_bwd_split.argtypes = operand * 4 + [p, i, p, p, p] + tail
    lib.pdt_flash_bwd_split.restype = i
    lib.pdt_flash_error_string.argtypes = [i]
    lib.pdt_flash_error_string.restype = ctypes.c_char_p


def _library() -> ctypes.CDLL:
    return _build.load_library("flash_attention", declare=_declare)


def _check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.pdt_flash_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {code})")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"q must be [B, Lq, H, D] and k, v [B, Lk, H, D]; got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch, heads "
            "or head dim")


def _check_cuda_operands(*tensors: torch.Tensor) -> None:
    """What the kernels take: one card, one dtype in {fp32, bf16}, D in
    ``HEAD_DIMS``, unit stride in D, 16-byte aligned rows, non-empty."""
    first = tensors[0]
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"operands on {t.device} and {first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"operands of dtypes {t.dtype} and {first.dtype}")
        if t.stride(-1) != 1:
            raise ValueError("the flash kernels need unit stride in the head dim")
        elem = t.element_size()
        if t.data_ptr() % 16 or any(s * elem % 16 for s in t.stride()[:3]):
            raise ValueError("the flash kernels need 16-byte aligned rows")
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(f"the flash kernels take float32 or bfloat16, got {first.dtype}")
    if first.shape[-1] not in HEAD_DIMS:
        raise ValueError(
            f"head dim {first.shape[-1]} unsupported: the kernels take D in {HEAD_DIMS}")
    if min(t.shape[1] for t in tensors) < 1:
        raise ValueError("the flash kernels need non-empty sequences")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _operand(t: torch.Tensor) -> list:
    return [_ptr(t), (ctypes.c_int64 * 11)(*tensor_map_geometry(t))]


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch_forward(q, k, v, causal: bool, scale: float,
                   shift: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel on checked CUDA operands. Returns
    ``(O [B, Lq, H, D], LSE [B, H, Lq] fp32)``."""
    b, lq, h, d = q.shape
    o = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    lib = _library()
    code = lib.pdt_flash_fwd(
        *_operand(q), *_operand(k), *_operand(v), _ptr(o), _ptr(lse), _DTYPE_CODES[q.dtype],
        int(causal), int(shift), float(scale), _stream(q))
    _check_launch(lib, FWD, code)
    launch_counts[FWD] += 1
    return o, lse


def _backward_operands(q, k, v, o, lse, do, delta):
    """The C functions' leading arguments, and the fp32 row statistics
    they read (``row_stats``; Δ from ``do`` and ``o`` when not given)."""
    if delta is None:
        delta = compute_delta(do, o)
    rows = row_stats(lse, delta)
    args = [*_operand(q), *_operand(k), *_operand(v), *_operand(do), _ptr(rows),
            rows.shape[-1]]
    return args, rows


def launch_backward(q, k, v, o, lse, do, causal: bool, scale: float, shift: int,
                    delta: Optional[torch.Tensor] = None):
    """Δ (unless given), one launch of the fused backward kernel on checked
    CUDA operands, and the dQ cast. Returns ``(dq, dk, dv)`` in the inputs'
    dtype."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    args, rows = _backward_operands(q, k, v, o, lse, do, delta)
    if q.dtype == torch.bfloat16:  # the wgmma kernel: tiles added in a fixed order
        dq, turns = dq_workspace(b, lq, h, d, causal, shift, q.device)
    else:  # fp32: dQ written once by the CUDA-core dQ kernel
        dq, turns = torch.empty((b, lq, h, d), dtype=torch.float32, device=q.device), None
    dk = torch.empty((b, lk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, lk, h, d), dtype=v.dtype, device=v.device)
    lib = _library()
    code = lib.pdt_flash_bwd(
        *args, _ptr(dq), None if turns is None else _ptr(turns), _ptr(dk), _ptr(dv),
        _DTYPE_CODES[q.dtype], int(causal), int(shift), float(scale), _stream(q))
    _check_launch(lib, BWD, code)
    launch_counts[BWD] += 1
    if turns is None:
        return dq, dk, dv
    return dq_from_workspace(dq, b, lq, q.dtype), dk, dv


def launch_backward_split(q, k, v, o, lse, do, causal: bool, scale: float, shift: int,
                          delta: Optional[torch.Tensor] = None):
    """Δ (unless given), then the split backward on checked CUDA operands:
    the dK/dV kernel and the dQ kernel, one launch each, every output
    written once in the input dtype. Returns ``(dq, dk, dv)``."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    args, rows = _backward_operands(q, k, v, o, lse, do, delta)
    dq = torch.empty((b, lq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, lk, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, lk, h, d), dtype=v.dtype, device=v.device)
    lib = _library()
    code = lib.pdt_flash_bwd_split(
        *args, _ptr(dq), _ptr(dk), _ptr(dv), _DTYPE_CODES[q.dtype], int(causal), int(shift),
        float(scale), _stream(q))
    _check_launch(lib, f"{BWD_DKV}/{BWD_DQ}", code)
    launch_counts[BWD_DKV] += 1
    launch_counts[BWD_DQ] += 1
    return dq, dk, dv


def flash_forward(q, k, v, *, causal: bool, scale: float, shift: int = 0):
    """``(O, LSE)``: the plain version on the CPU, the kernel on CUDA."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal=causal, scale=scale, shift=shift)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check_cuda_operands(q, k, v)
    return launch_forward(q, k, v, causal, scale, shift)


def flash_backward(q, k, v, o, lse, do, *, causal: bool, scale: float, shift: int = 0,
                   bwd_impl: str = "fused", delta: Optional[torch.Tensor] = None):
    """``(dq, dk, dv)``: the plain version on the CPU; on CUDA the fused
    kernel or, with ``bwd_impl="split"``, the two split kernels."""
    check_bwd_impl(bwd_impl)
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, o, lse, do, causal=causal,
                                        scale=scale, shift=shift, delta=delta)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    do = do.contiguous()
    _check_cuda_operands(q, k, v, o, do)
    launch = launch_backward if bwd_impl == "fused" else launch_backward_split
    return launch(q, k, v, o, lse, do, causal, scale, shift, delta)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, shift: int, bwd_impl: str):
        o, lse = flash_forward(q, k, v, causal=causal, scale=scale, shift=shift)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, shift, bwd_impl)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, shift, bwd_impl = ctx.args
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.to(q.dtype), causal=causal,
                                    scale=scale, shift=shift, bwd_impl=bwd_impl)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    bwd_impl: str = "fused",
) -> torch.Tensor:
    """``softmax(QKᵀ·scale)V`` on ``[B, L, H, D]``, differentiable in q, k
    and v (``ops/flash_attention.py:530`` of the JAX package). Returns
    ``[B, Lq, H, D]`` in q's dtype.

    On CUDA tensors the forward launches one kernel and the backward the
    fused kernel (``bwd_impl="fused"``) or the two split kernels
    (``"split"``), D in ``HEAD_DIMS``, fp32 or bf16, or they raise; on CPU
    tensors they run the plain versions. dQ sums in fp32 either way (the
    JAX ``partials_f32=True``, and the split kernels' own accumulation), so
    against JAX's default bf16 partials it differs by their rounding.
    """
    _check_shapes(q, k, v)
    check_bwd_impl(bwd_impl)
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    return _FlashAttention.apply(q, k, v, bool(causal), scale,
                                 int(q_offset) - int(k_offset), bwd_impl)
