"""The fused bottleneck tail's one-pass reductions through hand-written CUDA.

The port of ``pytorch_distributed_tpu/ops/bottleneck_tail.py``: three
kernels of ``csrc/bottleneck_tail.cu`` that the fused expand tail of
``models.resnet`` runs every train step.

- ``moments(z)``: ``(Σz [F], zᵀz [F, F])``, one read of z, fp32 sums;
- ``tail_bwd_reduce(z, g, out)``: ``(gp, P, Σgp)`` with ``gp = g·[out > 0]``
  in g's dtype (written once), ``P = zᵀgp`` ``[F, E]`` and ``Σgp`` ``[E]``
  fp32, one read of g and out;
- ``tail_bwd_dz(gp, z, wa, c, dmn)``: ``gp @ wa + z @ c + dmn`` ``[..., F]``
  in z's dtype, one output write; wa ``[E, F]``, c ``[F, F]`` and dmn
  ``[F]`` are fp32 and are rounded to z's dtype for the product (on the
  tensor cores in bf16), which the JAX kernel does not do. On bf16 rows it
  runs ``tail_dz_wgmma_kernel`` (TMA and wgmma, persistent blocks, gp and
  z read through the tensor maps of ``dz_tensor_map_geometry``); on fp32
  rows a CUDA-core kernel.

Operands are NHWC ``[B, H, W, C]`` or ``[N, C]``, bf16 or fp32, read as
``[N, C]`` rows through their row stride: a ``channels_last`` NCHW
activation passes as ``x.permute(0, 2, 3, 1)``, a view, and no wide
operand is copied. Beside each kernel is its plain version
(``*_reference``): the same function on the ``[N, C]`` view in torch ops,
sums in fp32. The wrappers run the plain version for tensors on the CPU;
for CUDA tensors they launch the kernel or raise. ``launch_counts`` counts
each kernel's launches and nothing else.

The two reductions run ``tail_reduce_wgmma_kernel`` on bf16 rows (a TMA
ring, wgmma, gp gated in shared memory; ``reduce_plan`` picks its tiles
from ``csrc/tail_plans.cuh`` and ``reduce_tensor_map_geometry`` its tensor
maps) and a CUDA-core kernel
on fp32 rows (``reduce_grid``). Both are deterministic: each block writes
its fp32 tile of one chunk of rows to a partial buffer ``[chunks, F + 1,
n_b]`` (row F the column sums), which a merge kernel as wide as the card
adds in a fixed order, so two launches give the same bits, as the Pallas
kernels' sequential grid does.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from pytorch_distributed_tpu_torch.ops import _build

MOMENTS = "moments"
BWD_REDUCE = "tail_bwd_reduce"
BWD_DZ = "tail_bwd_dz"
#: launches of each kernel since the last ``reset_launch_counts``
launch_counts = {MOMENTS: 0, BWD_REDUCE: 0, BWD_DZ: 0}

_DTYPES = (torch.float32, torch.bfloat16)
TILE = 64  # output tile edge of the reduction kernels; the dz kernel's TMA box
STEP = 32  # contraction rows a block takes per step
BLOCKS_PER_SM = 4  # of the fp32 reductions
MIN_CHUNK = 128  # rows
TILE_PLAN_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tail_plans.cuh"


class TilePlan(NamedTuple):
    """A row of ``csrc/tail_plans.cuh``: the bf16 reduction's tile of ``km``
    x ``kn`` units of 64 x 64 for ``gated`` (tail_bwd_reduce) or moments at
    F up to ``f_max`` (0: any F), ``rows`` rows a ring stage of ``stages``."""
    gated: bool
    f_max: int
    km: int
    kn: int
    rows: int
    stages: int


def _read_tile_plans() -> Tuple[TilePlan, ...]:
    """The rows of ``csrc/tail_plans.cuh``, the table the kernel source
    instantiates, in its order (a row's index names it to the kernel)."""
    text = TILE_PLAN_SOURCE.read_text()
    return tuple(TilePlan(bool(v[0]), *v[1:])
                 for v in (tuple(int(x) for x in m.split(","))
                           for m in re.findall(r"^TAIL_PLAN\(([^)]*)\)", text, re.M)))


TILE_PLANS = _read_tile_plans()


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def rows(x: torch.Tensor) -> torch.Tensor:
    """The ``[N, C]`` view of NHWC (or ``[N, C]``) ``x``; raises where the
    rows are not one stride apart (no copy is made)."""
    if x.dim() == 2:
        return x
    if x.dim() != 4:
        raise ValueError(f"expected NHWC [B, H, W, C] or [N, C], got {tuple(x.shape)}")
    try:
        return x.view(-1, x.shape[-1])
    except RuntimeError as err:
        raise ValueError(
            f"NHWC operand of strides {x.stride()} is not a [N, C] view; pass a "
            "channels_last activation's permute(0, 2, 3, 1)") from err


# ---- the plain versions ----

def moments_reference(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    z2 = rows(z).float()
    return z2.sum(0), z2.T @ z2


def tail_bwd_reduce_reference(z, g, out):
    g2 = rows(g)
    gp = torch.where(rows(out).float() > 0, g2, torch.zeros((), dtype=g2.dtype, device=g2.device))
    gpf = gp.float()
    return gp.view(g.shape), rows(z).float().T @ gpf, gpf.sum(0)


def tail_bwd_dz_reference(gp, z, wa, c, dmn):
    dt = z.dtype
    acc = (rows(gp).float() @ wa.to(dt).float() + rows(z).float() @ c.to(dt).float()
           + dmn.reshape(1, -1).float())
    return acc.to(dt).view(z.shape)


# ---- the kernels ----

@functools.lru_cache(maxsize=None)
def card_sms(device: torch.device) -> int:
    """The streaming multiprocessors of the card that holds ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_of(kernel_name: str) -> Optional[str]:
    """The tail function (``MOMENTS``, ``BWD_REDUCE``, ``BWD_DZ``) that
    launches the kernel of this (demangled) name in a profiler trace, else
    None. The reductions are ``tail_reduce_wgmma_kernel<kGate, …>`` (bf16),
    ``tail_reduce_kernel<kGate>`` (fp32; an older build's ``<T, kGate>``)
    and their merge, ``tail_merge_kernel<kGate>``, kGate false for moments;
    an older build merged in ``tail_sum_kernel<kMirror>``, kMirror true for
    moments. dz is ``tail_dz_wgmma_kernel`` (bf16) or ``tail_dz_kernel``."""
    name = kernel_name.lower()
    if "tail_reduce" in name or "tail_merge_kernel" in name:
        return BWD_REDUCE if "true" in name else MOMENTS
    if "tail_sum_kernel" in name:
        return MOMENTS if "true" in name else BWD_REDUCE
    if "tail_dz" in name:
        return BWD_DZ
    return None


def chunk_rows(n: int, n_tiles: int, sms: int) -> int:
    """Rows per block of a reduction over ``n`` rows with ``n_tiles``
    output tiles on a card of ``sms`` SMs: about ``BLOCKS_PER_SM`` blocks an
    SM in all, at least ``MIN_CHUNK`` rows each, a multiple of ``STEP``."""
    chunks = -(-BLOCKS_PER_SM * sms // n_tiles)
    rows = max(-(-n // chunks), MIN_CHUNK)
    return -(-rows // STEP) * STEP


def reduce_grid(n: int, f: int, n_b: int, gated: bool,
                sms: int) -> Tuple[int, int, Tuple[int, int, int]]:
    """``(output tiles, chunk rows, partial-buffer shape)`` of the fp32
    (CUDA-core) reduction ``zᵀB`` over ``n`` rows, z ``[n, f]`` and B
    ``[n, n_b]``, on a card of ``sms`` SMs: moments
    (``gated=False``, B = z) computes the upper triangle of its 64x64 tiles,
    tail_bwd_reduce all of them. The fp32 partial buffer holds one
    ``[f + 1, n_b]`` slice per chunk of rows."""
    n_i, n_j = -(-f // TILE), -(-n_b // TILE)
    n_tiles = n_i * n_j if gated else n_i * (n_i + 1) // 2
    chunk = chunk_rows(n, n_tiles, sms)
    return n_tiles, chunk, (-(-n // chunk), f + 1, n_b)


class ReducePlan(NamedTuple):
    """How the bf16 kernel splits a reduction ``zᵀB``: row ``index`` of
    ``TILE_PLANS``, its tiles of ``km`` x ``kn`` units of 64 x 64, ``rows``
    rows a ring stage (and a TMA box), ``n_tiles`` tiles (moments: the upper
    triangle of its super-tiles), ``chunk`` rows a block, and the fp32
    partial buffer's shape."""
    index: int
    km: int
    kn: int
    rows: int
    n_tiles: int
    chunk: int
    part_shape: Tuple[int, int, int]


def reduce_plan(n: int, f: int, n_b: int, gated: bool, sms: int) -> ReducePlan:
    """The bf16 reduction's plan over ``n`` rows, z ``[n, f]`` and B ``[n,
    n_b]`` (``gated``: tail_bwd_reduce, else moments with ``n_b = f``), on a
    card of ``sms`` SMs: the first row of ``TILE_PLANS`` for the function
    whose F bound covers ``f``, and chunks of whole 64-row boxes (so of whole
    stages), about ``sms`` blocks in all (one an SM: each holds a ring of
    ~200 KB)."""
    index = next(i for i, t in enumerate(TILE_PLANS)
                 if t.gated == gated and (not t.f_max or f <= t.f_max))
    t = TILE_PLANS[index]
    n_i = -(-f // (TILE * t.km))
    n_tiles = n_i * -(-n_b // (TILE * t.kn)) if gated else n_i * (n_i + 1) // 2
    per_block = -(-n // max(1, sms // n_tiles))
    chunk = -(-per_block // TILE) * TILE
    return ReducePlan(index, t.km, t.kn, t.rows, n_tiles, chunk, (-(-n // chunk), f + 1, n_b))


def reduce_tensor_map_geometry(box_rows: int, *xs: torch.Tensor) -> Tuple[Tuple[int, ...], ...]:
    """The TMA tensor maps of the bf16 reductions, one per operand (z; or z,
    g, out and gp), each read through its row stride, so a channels-last
    activation's rows need no copy: ``(columns, rows, row stride in bytes,
    box columns, box rows)`` with the box ``(64, box_rows)``, 128 bytes a
    box row (the 128-byte swizzle's span). A box past N or the channels
    lands as zeros (and a stored box is clipped), so neither need be a
    multiple of 64. g and out share the box and the swizzle, so the gate is
    applied position by position in shared memory."""
    return tuple((x.shape[1], x.shape[0], x.stride(0) * x.element_size(), TILE, box_rows)
                 for x in xs)


def dz_tensor_map_geometry(gp2: torch.Tensor, z2: torch.Tensor, wa: torch.Tensor,
                           c: torch.Tensor) -> Tuple[Tuple[int, ...], ...]:
    """The TMA tensor maps of the bf16 dz kernel, one per operand: gp
    ``[N, E]`` and z ``[N, F]`` (A, read through their row strides, so a
    channels-last activation's rows need no copy), wa ``[E, F]`` and c
    ``[F, F]`` (B, contiguous). Each is ``(columns, rows, row stride in
    bytes, box columns, box rows)`` with the box ``(64, 64)``: 64 rows of
    128 bytes, the 128-byte swizzle's span; a box past an operand's edge
    lands as zeros, so E and F need not be multiples of 64."""
    return tuple((x.shape[1], x.shape[0], x.stride(0) * x.element_size(), TILE, TILE)
                 for x in (gp2, z2, wa, c))


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    geometry = ctypes.POINTER(i64)
    # fp32: z, its row stride; N, F, chunk; partial, s, m2; stream
    lib.pdt_moments.argtypes = [p, i64, i, i, i, p, p, p, p]
    lib.pdt_moments.restype = i
    # bf16: z, its tensor map; N, F; plan (a row of TILE_PLANS), chunk; partial,
    # s, m2; stream
    lib.pdt_moments_tc.argtypes = [p, geometry, i, i, i, i, p, p, p, p]
    lib.pdt_moments_tc.restype = i
    # fp32: z, g, out and their row strides, gp, chunk, partial, p, sb; N, F, E; stream
    lib.pdt_tail_bwd_reduce.argtypes = [p, i64, p, i64, p, i64, p, i, p, p, p, i, i, i, p]
    lib.pdt_tail_bwd_reduce.restype = i
    # bf16: z, g, out, gp, their tensor maps; N, F, E; plan, chunk; partial,
    # p, sb; stream
    lib.pdt_tail_bwd_reduce_tc.argtypes = [p, p, p, p, geometry, i, i, i, i, i, p, p, p, p]
    lib.pdt_tail_bwd_reduce_tc.restype = i
    lib.pdt_tail_bwd_dz.argtypes = [p, i64, p, i64, p, p, p, i, i, i, p]
    lib.pdt_tail_bwd_dz.restype = i
    # gp, z, wa, c, their tensor maps' geometry, dmn, dz; N, F, E; stream
    lib.pdt_tail_bwd_dz_tc.argtypes = [p, p, p, p, geometry, p, p, i, i, i, p]
    lib.pdt_tail_bwd_dz_tc.restype = i
    lib.pdt_tail_error_string.argtypes = [i]
    lib.pdt_tail_error_string.restype = ctypes.c_char_p


def _library() -> ctypes.CDLL:
    return _build.load_library("bottleneck_tail", declare=_declare)


def _check_launch(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.pdt_tail_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {code})")


def _check_rows(*xs: torch.Tensor) -> None:
    """What the kernels take: one card, one dtype in {fp32, bf16}, unit
    channel stride, 16-byte aligned rows, channel counts multiples of 8."""
    first = xs[0]
    if first.dtype not in _DTYPES:
        raise TypeError(f"the tail kernels take float32 or bfloat16, got {first.dtype}")
    for x in xs:
        if x.device != first.device or x.dtype != first.dtype:
            raise ValueError(f"operands on {x.device}/{x.dtype} and {first.device}/{first.dtype}")
        if x.stride(1) != 1 or x.shape[1] % 8:
            raise ValueError(f"the tail kernels need unit channel stride and channels "
                             f"a multiple of 8, got shape {tuple(x.shape)} strides {x.stride()}")
        if x.data_ptr() % 16 or x.stride(0) * x.element_size() % 16:
            raise ValueError("the tail kernels need 16-byte aligned rows")
        if x.shape[0] != first.shape[0] or x.shape[0] < 1:
            raise ValueError("operands differ in rows, or have none")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _geometry(maps: Tuple[Tuple[int, ...], ...]):
    """Tensor-map geometry as the C entry points take it: int64 in a row."""
    flat = [v for m in maps for v in m]
    return (ctypes.c_int64 * len(flat))(*flat)


def _on(x: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the plain version runs); False for CUDA."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return False


def moments(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Σz [F], zᵀz [F, F])`` over the rows of NHWC ``z``, fp32."""
    if _on(z, MOMENTS):
        return moments_reference(z)
    z2 = rows(z)
    _check_rows(z2)
    n, f = z2.shape
    s = torch.empty(f, dtype=torch.float32, device=z.device)
    m2 = torch.empty((f, f), dtype=torch.float32, device=z.device)
    lib = _library()
    if z.dtype == torch.bfloat16:
        plan = reduce_plan(n, f, f, gated=False, sms=card_sms(z.device))
        partial = torch.empty(plan.part_shape, dtype=torch.float32, device=z.device)
        code = lib.pdt_moments_tc(
            _ptr(z2), _geometry(reduce_tensor_map_geometry(plan.rows, z2)), n, f, plan.index,
            plan.chunk, _ptr(partial), _ptr(s), _ptr(m2), _stream(z))
    else:
        _, chunk, part_shape = reduce_grid(n, f, f, gated=False, sms=card_sms(z.device))
        partial = torch.empty(part_shape, dtype=torch.float32, device=z.device)
        code = lib.pdt_moments(_ptr(z2), z2.stride(0), n, f, chunk, _ptr(partial), _ptr(s),
                               _ptr(m2), _stream(z))
    _check_launch(lib, MOMENTS, code)
    launch_counts[MOMENTS] += 1
    return s, m2


def tail_bwd_reduce(z: torch.Tensor, g: torch.Tensor, out: torch.Tensor):
    """``(gp, P, Σgp)``: ``gp = g·[out > 0]`` shaped as g in g's dtype,
    ``P = zᵀgp [F, E]`` and ``Σgp [E]`` fp32, over the rows of NHWC z, g
    and out."""
    if _on(z, BWD_REDUCE):
        return tail_bwd_reduce_reference(z, g, out)
    z2, g2, o2 = rows(z), rows(g), rows(out)
    _check_rows(z2, g2, o2)
    if g2.shape != o2.shape:
        raise ValueError(f"g {tuple(g.shape)} and out {tuple(out.shape)} differ")
    n, f = z2.shape
    e = g2.shape[1]
    gp = torch.empty((n, e), dtype=g.dtype, device=g.device)
    p = torch.empty((f, e), dtype=torch.float32, device=z.device)
    sb = torch.empty(e, dtype=torch.float32, device=z.device)
    lib = _library()
    if z.dtype == torch.bfloat16:
        plan = reduce_plan(n, f, e, gated=True, sms=card_sms(z.device))
        partial = torch.empty(plan.part_shape, dtype=torch.float32, device=z.device)
        geometry = reduce_tensor_map_geometry(plan.rows, z2, g2, o2, gp)
        code = lib.pdt_tail_bwd_reduce_tc(
            _ptr(z2), _ptr(g2), _ptr(o2), _ptr(gp), _geometry(geometry), n, f, e, plan.index,
            plan.chunk, _ptr(partial), _ptr(p), _ptr(sb), _stream(z))
    else:
        _, chunk, part_shape = reduce_grid(n, f, e, gated=True, sms=card_sms(z.device))
        partial = torch.empty(part_shape, dtype=torch.float32, device=z.device)
        code = lib.pdt_tail_bwd_reduce(
            _ptr(z2), z2.stride(0), _ptr(g2), g2.stride(0), _ptr(o2), o2.stride(0), _ptr(gp),
            chunk, _ptr(partial), _ptr(p), _ptr(sb), n, f, e, _stream(z))
    _check_launch(lib, BWD_REDUCE, code)
    launch_counts[BWD_REDUCE] += 1
    return gp.view(g.shape), p, sb


def tail_bwd_dz(gp: torch.Tensor, z: torch.Tensor, wa: torch.Tensor, c: torch.Tensor,
                dmn: torch.Tensor) -> torch.Tensor:
    """``gp @ wa + z @ c + dmn`` shaped as z, in z's dtype: gp NHWC
    ``[..., E]``, z ``[..., F]``, wa ``[E, F]``, c ``[F, F]``, dmn ``[F]``
    or ``[1, F]`` (fp32, rounded to z's dtype for the product)."""
    if _on(z, BWD_DZ):
        return tail_bwd_dz_reference(gp, z, wa, c, dmn)
    gp2, z2 = rows(gp), rows(z)
    _check_rows(gp2, z2)
    n, f = z2.shape
    e = gp2.shape[1]
    dmn = dmn.reshape(-1).float().contiguous()
    if wa.shape != (e, f) or c.shape != (f, f) or dmn.shape != (f,):
        raise ValueError(f"wa {tuple(wa.shape)}, c {tuple(c.shape)}, dmn {tuple(dmn.shape)} "
                         f"do not fit E={e}, F={f}")
    if any(x.device != z.device for x in (wa, c, dmn)):
        raise ValueError("wa, c and dmn must lie on z's device")
    dz = torch.empty((n, f), dtype=z.dtype, device=z.device)
    lib = _library()
    if z.dtype == torch.bfloat16:
        wa16, c16 = (x.to(torch.bfloat16).contiguous() for x in (wa, c))  # rounded once
        geometry = dz_tensor_map_geometry(gp2, z2, wa16, c16)
        code = lib.pdt_tail_bwd_dz_tc(_ptr(gp2), _ptr(z2), _ptr(wa16), _ptr(c16),
                                      _geometry(geometry), _ptr(dmn), _ptr(dz), n, f, e,
                                      _stream(z))
    else:
        w = torch.cat([wa, c]).float()  # [E + F, F], contiguous
        code = lib.pdt_tail_bwd_dz(_ptr(gp2), gp2.stride(0), _ptr(z2), z2.stride(0), _ptr(w),
                                   _ptr(dmn), _ptr(dz), n, f, e, _stream(z))
    _check_launch(lib, BWD_DZ, code)
    launch_counts[BWD_DZ] += 1
    return dz.view(z.shape)
