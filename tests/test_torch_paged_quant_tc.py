"""Kernels 7 and 8 on int8 and fp8 pools, on tensor cores.

bf16 q on int8, fp8 e4m3 and fp8 e5m2 pools runs ``paged_sweep_tc_kernel``
and ``paged_split_tc_kernel``: the pools' one-byte codes land by TMA as they
are, widen exactly to bf16 inside the products, and the scales stay outside
them (each key's K scale on its column of S, its V scale on p, which goes to
PV as two bf16 terms). The kernels run only on the card (``chip_smoke.py``
holds them against the plain version there). Here: that every code is
exact in bf16 (and the int8 widening's float trick), the one-byte pools'
tensor-map geometry, what the wrapper hands the library and counts, and a
torch emulation of the scheme against the JAX package's Pallas
``paged_flash_attention`` in interpret mode, to one bf16 ulp of the output.
"""

import ctypes

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.paged_flash import (
    paged_flash_attention as jax_paged_flash_attention,
)
from pytorch_distributed_tpu_torch.ops import paged_flash
from pytorch_distributed_tpu_torch.ops.attention import NEG_INF
from pytorch_distributed_tpu_torch.ops.paged_flash import (
    CUDA_CORES,
    TENSOR_CORES,
    pool_tensor_map_geometry,
)
from pytorch_distributed_tpu_torch.serving.kv_pool import (
    kv_pool_dtype,
    quantize_kv,
    scale_factors,
)

BF16, F32 = torch.bfloat16, torch.float32
KV = ("int8", "fp8", "fp8_e5m2")
JAX_DT = {torch.int8: jnp.int8, torch.float8_e4m3fn: jnp.float8_e4m3fn,
          torch.float8_e5m2: jnp.float8_e5m2}
NP_DT = {torch.float8_e4m3fn: ml_dtypes.float8_e4m3fn, torch.float8_e5m2: ml_dtypes.float8_e5m2}


@pytest.mark.parametrize("kv", KV)
def test_every_code_is_exact_in_bf16(kv):
    """Each of the 256 codes of a pool dtype (the finite ones, for fp8) is a
    bf16 value, so widening a code to bf16 rounds nothing; for int8 the
    kernel's widening, float(2^23 + code + 128) − (2^23 + 128) built from the
    exponent bits 0x4B, gives the code itself."""
    dt = kv_pool_dtype(kv)
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(dt)
    x = codes.float()
    x = x[torch.isfinite(x)]
    assert torch.equal(x.bfloat16().float(), x)
    if dt == torch.int8:
        u = (codes.view(torch.uint8).to(torch.int32) ^ 0x80) | 0x4B000000
        assert torch.equal(u.view(torch.float32) - 8388736.0, codes.float())


def box(pool: torch.Tensor, geometry, col: int, head: int, row: int) -> torch.Tensor:
    """What a TMA box of ``geometry`` at coordinates (col, head, row) reads
    from a one-byte pool's storage, zeros where it lies out of bounds."""
    d, h_kv, n_rows, s_head, s_row, b_col, b_head, b_rows = geometry
    assert pool.element_size() == 1 and b_head == 1
    out = torch.zeros((b_rows, b_col), dtype=torch.uint8)
    flat = pool.view(torch.uint8).reshape(-1)
    for r in range(b_rows):
        if row + r < n_rows:
            start = (row + r) * s_row + head * s_head + col
            out[r] = flat[start:start + b_col]
    return out


@pytest.mark.parametrize("block_len", [8, 16, 64, 128])
@pytest.mark.parametrize("pool_dtype,d", [(torch.int8, 64), (torch.float8_e4m3fn, 128),
                                          (torch.float8_e5m2, 64)])
def test_one_byte_pool_geometry_lands_whole_code_rows(pool_dtype, d, block_len):
    """A one-byte pool as ``[n_blocks·bl, H_kv, D]``: byte strides D and
    H_kv·D, a box of all D columns (D bytes: the 64-byte swizzle's span at
    D 64, the 128-byte one's at 128) by 1 head by min(bl, 64) rows. Walking
    a table in 64-key stages, one box per pool block (or per 64 rows of
    one) lands every key's codes once; a box past the frontier, asked for at
    row ``n_blocks·bl``, reads zeros."""
    rng = np.random.default_rng(block_len + d)
    n_blocks, h_kv, head, w = 9, 3, 1, 4
    raw = rng.integers(0, 256, (n_blocks, block_len, h_kv, d), dtype=np.uint8)
    pool = torch.from_numpy(raw).view(pool_dtype)
    table = rng.permutation(np.arange(1, n_blocks))[:w]
    geometry = pool_tensor_map_geometry(pool)
    rows = min(block_len, 64)
    assert geometry == (d, h_kv, n_blocks * block_len, d, h_kv * d, d, 1, rows)
    assert 64 % rows == 0 and rows * d % (8 * d) == 0  # whole 8-row swizzle atoms
    n_keys = w * block_len
    landed = torch.cat([
        box(pool, geometry, 0, head, int(table[key // block_len]) * block_len + key % block_len)
        for i in range(-(-n_keys // 64)) for key in range(64 * i, 64 * i + 64, rows)
        if key < n_keys])
    chain = torch.from_numpy(raw[table][:, :, head].reshape(n_keys, d))
    assert torch.equal(landed, chain)
    assert not box(pool, geometry, 0, head, n_blocks * block_len).any()


class FakeLibrary:
    """The kernels' library as the wrapper calls it: each entry point
    records its arguments and reports a launch."""

    def __init__(self):
        self.calls = []

    def pdt_paged_attention_rows_per_tile(self):
        return 8

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("q_dtype,pool_dtype,want", [
    (BF16, torch.int8, "pdt_paged_attention_sweep_tc"),
    (BF16, torch.float8_e4m3fn, "pdt_paged_attention_sweep_tc"),
    (BF16, torch.float8_e5m2, "pdt_paged_attention_sweep_tc"),
    (F32, torch.int8, "pdt_paged_attention_sweep"),
    (F32, torch.float8_e4m3fn, "pdt_paged_attention_sweep"),
])
def test_quantized_sweep_hands_the_scales_and_pool_kind(q_dtype, pool_dtype, want,
                                                        monkeypatch):
    """``launch_sweep`` on quantized pools: bf16 q calls the tensor-core
    entry point with both scale tables, the one-byte pools' geometry and
    the pool kind (1 int8, 2 e4m3, 3 e5m2); fp32 q the walk's. Either
    counts one launch under the pool's variant and one under its route,
    and none on float pools."""
    lib = FakeLibrary()
    monkeypatch.setattr(paged_flash, "_library", lambda: lib)
    monkeypatch.setattr(paged_flash, "_stream", lambda t: ctypes.c_void_p(None))
    b, c, h, h_kv, d, bl, w, n_blocks = 2, 3, 8, 2, 64, 16, 5, 11
    q = torch.zeros((b, c, h, d), dtype=q_dtype)
    k_pool = torch.zeros((n_blocks, bl, h_kv, d), dtype=pool_dtype)
    sdt = F32 if pool_dtype == torch.int8 else torch.int8
    k_scale, v_scale = (torch.zeros((n_blocks, bl, h_kv), dtype=sdt) for _ in "kv")
    tables = torch.zeros((b, w), dtype=torch.int32)
    qpos = torch.zeros((b, c), dtype=torch.int32)
    paged_flash.reset_launch_counts()
    out = paged_flash.launch_sweep(q, k_pool, k_pool.clone(), tables, qpos, 0.125,
                                   k_scale=k_scale, v_scale=v_scale)
    assert out.shape == q.shape and out.dtype == q_dtype
    assert [name for name, _ in lib.calls] == [want]
    route = TENSOR_CORES if want.endswith("_tc") else CUDA_CORES
    assert {k: v for k, v in paged_flash.quant_launch_counts.items() if v} == {
        paged_flash.variant(paged_flash.SWEEP, pool_dtype): 1}
    assert {k: v for k, v in paged_flash.route_launch_counts.items() if v} == {
        paged_flash.route_key(paged_flash.SWEEP, route): 1}
    assert not any(paged_flash.launch_counts.values())
    args = lib.calls[0][1]
    assert [a.value for a in args[6:8]] == [k_scale.data_ptr(), v_scale.data_ptr()]
    if route == TENSOR_CORES:
        assert tuple(args[8]) == pool_tensor_map_geometry(k_pool)
        pool = {torch.int8: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}[pool_dtype]
        assert args[12:19] == (pool, b, c, h_kv, h // h_kv, bl, w)


# ---------------------------------------------------------------------------
# the scheme against the Pallas kernel
# ---------------------------------------------------------------------------


def emulate_tc(q, k_codes, v_codes, k_scale, v_scale, tables, pos, scale=None):
    """The quantized tensor-core scheme in torch, on the CPU: q scaled in
    its dtype (bf16); the codes widened to bf16, exactly; S = ks · (q·scale)
    · k_code in fp32; the softmax in fp32, l summing p; P' = p · vs as two
    bf16 terms, hi = bf16(P'), lo = bf16(P' − hi), each multiplied by the
    V codes with fp32 sums; the output acc / l in q's dtype, a fully
    masked row 0."""
    b, c, h, d = q.shape
    _, bl, h_kv, _ = k_codes.shape
    g, w = h // h_kv, tables.shape[1]
    scale = scale if scale is not None else d ** -0.5
    idx = tables.long()
    kc, vc = (x[idx].reshape(b, w * bl, h_kv, d).float() for x in (k_codes, v_codes))
    assert torch.equal(kc.bfloat16().float(), kc) and torch.equal(vc.bfloat16().float(), vc)
    ks, vs = (scale_factors(x)[idx].reshape(b, w * bl, h_kv).permute(0, 2, 1)[:, :, None, None]
              for x in (k_scale, v_scale))  # [B, H_kv, 1, 1, keys]
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float().reshape(b, c, h_kv, g, d)
    s = torch.einsum("bchgd,bkhd->bhgck", qs, kc) * ks
    allowed = torch.arange(w * bl)[None, None, None, None, :] <= pos.long()[:, None, None, :, None]
    s = s.masked_fill(~allowed, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * allowed
    l = p.sum(dim=-1)
    pv = p * vs
    hi = pv.bfloat16().float()
    lo = (pv - hi).bfloat16().float()
    acc = torch.einsum("bhgck,bkhd->bhgcd", hi, vc) + torch.einsum("bhgck,bkhd->bhgcd", lo, vc)
    out = acc / l.clamp_min(1e-37)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, d).to(q.dtype)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (float32's spacing, 16 bits
    coarser)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


def to_jax(t: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype, bit for bit."""
    if t.dtype in NP_DT:
        return jnp.asarray(t.view(torch.uint8).numpy().view(NP_DT[t.dtype]))
    if t.dtype == BF16:
        return jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("c,split_s", [(1, 2), (3, 1)])
def test_scheme_matches_jax_pallas_to_one_bf16_ulp(kv, c, split_s):
    """The emulation of the quantized tensor-core scheme against the JAX
    ``paged_flash_attention`` in interpret mode (the sweep, and the split
    with its jnp merge), bf16 q, on pools quantized by the port's
    ``quantize_kv``: GQA (H 4 over H_kv 2), ragged chains with trash
    tails, keys masked past each row's position, a padding row (-1) in
    the chunk, a batch row with no visible key. Each output is within one
    bf16 ulp of the Pallas kernel's (they round fp32 sums that agree to
    ~2^-16 of p, and the fp8 scales' XLA exp2, to bf16); the masked rows
    are 0 on both sides."""
    rng = np.random.default_rng(len(kv) + c)
    b, h, h_kv, d, bl, w = 3, 4, 2, 16, 4, 6
    n_blocks = 1 + b * w
    pool_dt = kv_pool_dtype(kv)
    k_codes, k_scale = quantize_kv(torch.from_numpy(
        rng.standard_normal((n_blocks, bl, h_kv, d)).astype(np.float32)), pool_dt)
    v_codes, v_scale = quantize_kv(torch.from_numpy(
        (rng.standard_normal((n_blocks, bl, h_kv, d)) * 3).astype(np.float32)), pool_dt)
    tables = np.zeros((b, w), np.int32)
    order = rng.permutation(np.arange(1, n_blocks))
    tables[0, :6] = order[:6]
    tables[1, :3] = order[6:9]
    pos = np.full((b, c), -1, np.int32)
    pos[0] = np.arange(22 - c + 1, 23)
    pos[1, 0] = 9
    q = torch.from_numpy(rng.standard_normal((b, c, h, d)).astype(np.float32)).to(BF16)
    want = jax_paged_flash_attention(
        to_jax(q), to_jax(k_codes), to_jax(v_codes), jnp.asarray(tables), jnp.asarray(pos),
        k_scale=to_jax(k_scale), v_scale=to_jax(v_scale), split_s=split_s, interpret=True)
    want = np.asarray(want).astype(np.float32)
    got = emulate_tc(q, k_codes, v_codes, k_scale, v_scale, torch.from_numpy(tables),
                     torch.from_numpy(pos)).float().numpy()
    diff = np.abs(got - want)
    assert np.all(diff <= bf16_ulp(np.maximum(np.abs(got), np.abs(want)))), diff.max()
    assert not got[2].any() and not want[2].any()
    if c > 1:
        assert not got[1, 1:].any() and not want[1, 1:].any()
    assert np.abs(want).max() > 0.1  # rows with visible keys carry values


@pytest.mark.parametrize("name,sweep,split", [
    ("void (anonymous namespace)::paged_sweep_tc_kernel<2, 64, 8>(CUtensorMap, CUtensorMap, "
     "(anonymous namespace)::TcParams)", True, False),
    ("void (anonymous namespace)::paged_split_tc_kernel<1, 64, 6>(CUtensorMap, CUtensorMap, "
     "(anonymous namespace)::TcParams)", False, True),
    ("void (anonymous namespace)::paged_attention_kernel<__nv_bfloat16, __nv_fp8_e4m3, 2, 2, "
     "false>((anonymous namespace)::Params)", True, False),
    ("void (anonymous namespace)::paged_attention_kernel<__nv_bfloat16, signed char, 1, 2, "
     "true>((anonymous namespace)::Params)", False, True),
    ("_ZN51_GLOBAL__N__3a9a22d8_18_paged_attention_cu_1a6f29fa22paged_attention_kernelI13__nv_"
     "bfloat1613__nv_fp8_e4m3Li2ELi2ELb0EEEvNS_6ParamsE", True, False),
    ("_ZN51_GLOBAL__N__3a9a22d8_18_paged_attention_cu_1a6f29fa22paged_attention_kernelI13__nv_"
     "bfloat16aLi1ELi2ELb1EEEvNS_6ParamsE", False, True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<unsigned char>, "
     "at::detail::Array<char*, 1> >(int, at::native::FillFunctor<unsigned char>, "
     "at::detail::Array<char*, 1>)", False, False),
])
def test_ab_matches_kernel_7_and_8_by_either_spelling(name, sweep, split):
    """``tools/attention_ab.py`` picks kernel 7's and kernel 8's CUDA
    functions out of a trace on either route (the tensor-core kernels, the
    walk's ``false``/``true`` instantiations), demangled or mangled, and
    nothing else (the L2 flush's fill)."""
    from pytorch_distributed_tpu_torch.tools import attention_ab

    assert attention_ab.is_sweep_kernel(name) == sweep
    assert attention_ab.is_split_kernel(name) == split


@pytest.mark.parametrize("values,want", [([3.0, None, 1.0, 2.0], 2.0), ([None, None], None),
                                         ([4.0], 4.0)])
def test_ab_median_skips_a_device_time_no_trace_held(values, want):
    """An A/B entry whose device time no trace held in full (None in that
    run) takes the median of the runs that measured it, or None."""
    from pytorch_distributed_tpu_torch.tools.tail_ab import median_of

    assert median_of(values) == want
