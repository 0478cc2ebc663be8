"""The port's quantized KV pools against the JAX package's.

- ``quantize_rows``/``quantize_kv`` bit-equal to the JAX ones in int8, fp8
  e4m3 and fp8 e5m2 on seeded rows; where XLA's CPU ``log2``/``exp2`` are
  inexact (an amax at an exact power of two times fmax) the port keeps
  the exact exponent, which one case pins down.
- The plain dequantizing attention against JAX ``paged_attention``
  (dense gather) and against the Pallas kernels in interpret mode (sweep
  and split), to 1e-4 in fp32: the JAX side's fp8 multipliers carry
  XLA's ``exp2`` error of a few ulps, so the two are not bit-equal.
- Quantize-on-scatter (the plain spelling the CPU runs) bit-equal to JAX
  ``paged_quantize_scatter`` in interpret mode, compared through
  ``paged_cache_from_jax``.
- Greedy streams of ``Scheduler(kv_dtype=...)`` equal to the JAX
  ``Scheduler(kv_dtype=..., gather_impl="dense")``'s.
- Layout, capacity, the wrappers' checks, and the cache converters.
"""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.ops.attention import paged_attention as jax_paged_attention
from pytorch_distributed_tpu.ops.paged_flash import (
    paged_flash_attention as jax_paged_flash_attention,
)
from pytorch_distributed_tpu.ops.paged_flash import (
    paged_quantize_scatter as jax_paged_quantize_scatter,
)
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu.serving.kv_pool import init_paged_cache as jax_init_paged_cache
from pytorch_distributed_tpu.serving.kv_pool import pool_block_bytes as jax_pool_block_bytes
from pytorch_distributed_tpu.serving.kv_pool import quantize_kv as jax_quantize_kv
from pytorch_distributed_tpu.serving.kv_pool import quantize_rows as jax_quantize_rows
from pytorch_distributed_tpu_torch.models import (
    paged_cache_from_jax,
    paged_cache_to_jax,
    params_from_jax,
    tiny_config,
)
from pytorch_distributed_tpu_torch.ops import paged_flash
from pytorch_distributed_tpu_torch.ops.attention import paged_attention_reference
from pytorch_distributed_tpu_torch.serving import Scheduler, init_paged_cache, pool_block_bytes
from pytorch_distributed_tpu_torch.serving.kv_pool import (
    kv_pool_dtype,
    pow2,
    quantize_kv,
    quantize_rows,
    scale_factors,
)

KV = ("int8", "fp8", "fp8_e5m2")
JAX_DT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn, "fp8_e5m2": jnp.float8_e5m2}


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy (ml_dtypes fp8 included) → torch, bit for bit."""
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    if a.dtype == ml_dtypes.float8_e5m2:
        return torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e5m2)
    return torch.from_numpy(np.array(a))


def bits(t) -> np.ndarray:
    """Raw bytes of a torch tensor or numpy/jax array, for bit equality."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(t))
    return a.view(np.uint8)


def rows(shape, seed=0, lo=1e-3, hi=50.0) -> np.ndarray:
    """Normal rows scaled so that each row's amax spans [lo, hi] log-uniformly."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x * np.exp(rng.uniform(np.log(lo), np.log(hi), shape[:-1] + (1,))).astype(np.float32)


# ---------------------------------------------------------------------------
# quantize_rows / quantize_kv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", KV)
def test_quantize_rows_bit_equal_to_jax(kv):
    x = rows((48, 12, 64), seed=1)
    x[0, 0] = 0.0  # an all-zero row: amax floored at 1e-8
    qj, sj = jax_quantize_rows(jnp.asarray(x), JAX_DT[kv])
    qt, st = quantize_rows(torch.from_numpy(x), kv_pool_dtype(kv))
    assert qt.dtype == kv_pool_dtype(kv) and qt.shape == x.shape
    assert st.dtype == (torch.float32 if kv == "int8" else torch.int8)
    np.testing.assert_array_equal(bits(qt), bits(qj))
    np.testing.assert_array_equal(bits(st), bits(sj))


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_quantize_kv_bit_equal_to_jax(kv, dtype):
    """A chunk [B, L, H_kv, D] in the compute dtype, fp32 statistics.

    bf16 values scaled by an exact 2**-e often fall exactly halfway
    between two fp8 values. The port rounds those ties to even; XLA's CPU
    ``exp2`` is a few ulps off, which breaks some ties the other way. So
    for bf16 into fp8 every difference must be such a tie, and nothing
    else may differ."""
    x = rows((2, 5, 3, 16), seed=2).astype(dtype)
    qj, sj = jax_quantize_kv(jnp.asarray(x), JAX_DT[kv])
    xt = torch.from_numpy(x.astype(np.float32))
    if dtype != np.float32:
        xt = xt.bfloat16()  # exact: x is already bf16
    qt, st = quantize_kv(xt, kv_pool_dtype(kv))
    np.testing.assert_array_equal(bits(st), bits(sj))
    diff = bits(qt) != bits(qj)
    if dtype == np.float32 or kv == "int8":
        assert not diff.any()
        return
    assert diff.mean() < 0.02
    y = x.astype(np.float64) * 2.0 ** -st.numpy().astype(np.float64)[..., None]
    port = qt.float().numpy().astype(np.float64)
    ref = np.asarray(qj).astype(np.float64)
    assert np.all(np.abs(y - port)[diff] == np.abs(y - ref)[diff])  # exact ties
    assert not (bits(qt)[diff] & 1).any()  # the port's side is the even one


@pytest.mark.parametrize("kv", ["fp8", "fp8_e5m2"])
def test_fp8_exponent_is_exact_at_powers_of_two(kv):
    """``e = ceil(log2(amax / fmax))`` exactly, amax at and one ulp around
    fmax·2^j: the case where XLA's CPU log2 can miss the ceiling."""
    fmax = float(torch.finfo(kv_pool_dtype(kv)).max)
    amax = []
    for j in range(-20, 5):
        a = np.float32(fmax * 2.0 ** j)
        amax += [a, np.nextafter(a, np.float32(0)), np.nextafter(a, np.float32(np.inf))]
    x = np.zeros((len(amax), 1, 8), np.float32)
    x[:, 0, 3] = amax
    _, e = quantize_rows(torch.from_numpy(x), kv_pool_dtype(kv))
    for a, got in zip(amax, e[:, 0].tolist()):
        ratio = float(a) / fmax  # exact in double for these values
        want = math.ceil(math.log2(ratio))
        if 2.0 ** (want - 1) >= ratio:  # log2 rounding in double
            want -= 1
        assert got == want, (a, got, want)
        assert float(a) * 2.0 ** -got <= fmax  # never saturates


def test_scale_factors_are_exact_powers_of_two():
    e = torch.arange(-126, 127, dtype=torch.int32)
    assert torch.equal(pow2(e), torch.tensor([2.0 ** k for k in range(-126, 127)]))
    assert torch.equal(scale_factors(e.to(torch.int8)[:200]), pow2(e[:200]))
    s = torch.rand(5)
    assert scale_factors(s) is s


# ---------------------------------------------------------------------------
# dequantizing attention, plain version against JAX
# ---------------------------------------------------------------------------

B, H, D, BL, W = 2, 4, 8, 4, 6


def quant_inputs(kv, c, h_kv, seed=0):
    """Pools quantized on the JAX side (so both sides read the same
    bytes), trash tails, a ragged frontier and padding rows (position
    -1)."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * W
    pools = []
    for _ in range(2):
        qv, sc = jax_quantize_rows(jnp.asarray(rows((n_blocks, BL, h_kv, D), seed + 7)),
                                   JAX_DT[kv])
        pools += [np.asarray(qv), np.asarray(sc)]
        seed += 1
    tables = np.zeros((B, W), np.int32)
    order = rng.permutation(np.arange(1, n_blocks))
    tables[0, :5] = order[:5]
    tables[1, :2] = order[5:7]
    q = rng.normal(size=(B, c, H, D)).astype(np.float32)
    pos = np.zeros((B, c), np.int32)
    pos[0] = np.arange(19 - c + 1, 20)
    pos[1] = -1
    if c > 1:
        pos[1, :2] = [3, 7]
    kq, ks, vq, vs = pools
    return q, kq, vq, ks, vs, tables, pos


def port_attention(q, kq, vq, ks, vs, tables, pos):
    return paged_attention_reference(
        torch.from_numpy(q), to_torch(kq), to_torch(vq), torch.from_numpy(tables),
        torch.from_numpy(pos), k_scale=to_torch(ks), v_scale=to_torch(vs)).numpy()


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("c,h_kv", [(1, 4), (5, 2)])
def test_dequant_reference_matches_jax_dense_gather(kv, c, h_kv):
    q, kq, vq, ks, vs, tables, pos = quant_inputs(kv, c, h_kv)
    want = jax_paged_attention(*map(jnp.asarray, (q, kq, vq, tables, pos)),
                               gather_impl="dense", k_scale=jnp.asarray(ks),
                               v_scale=jnp.asarray(vs))
    got = port_attention(q, kq, vq, ks, vs, tables, pos)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("split_s", [1, 2])
def test_dequant_reference_matches_jax_pallas_interpret(kv, split_s):
    """The Pallas sweep and split with their in-kernel dequant."""
    q, kq, vq, ks, vs, tables, pos = quant_inputs(kv, 5, 2, seed=3)
    want = jax_paged_flash_attention(
        *map(jnp.asarray, (q, kq, vq, tables, pos)), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), split_s=split_s, interpret=True)
    got = port_attention(q, kq, vq, ks, vs, tables, pos)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_dequant_wrapper_on_cpu_runs_the_plain_version_and_checks_scales():
    q, kq, vq, ks, vs, tables, pos = quant_inputs("fp8", 1, 4)
    args = [torch.from_numpy(q), to_torch(kq), to_torch(vq), torch.from_numpy(tables),
            torch.from_numpy(pos)]
    sc = dict(k_scale=to_torch(ks), v_scale=to_torch(vs))
    paged_flash.reset_launch_counts()
    want = paged_attention_reference(*args, **sc)
    for split_s in (None, 1, 2):
        assert torch.equal(paged_flash.paged_flash_attention(*args, split_s=split_s, **sc),
                           want)
    assert not any(paged_flash.launch_counts.values())
    assert not any(paged_flash.quant_launch_counts.values())
    with pytest.raises(ValueError, match="need k_scale"):
        paged_flash.paged_flash_attention(*args)  # quantized pools, no scales
    with pytest.raises(ValueError, match="need k_scale"):
        paged_flash.paged_flash_attention(*args, k_scale=sc["k_scale"])
    floats = [args[0], args[1].float(), args[2].float(), *args[3:]]
    with pytest.raises(ValueError, match="must not pass"):
        paged_attention_reference(*floats, **sc)  # float pools with scales
    with pytest.raises(ValueError, match="scales must be"):
        paged_attention_reference(*args, k_scale=sc["k_scale"][:, :1],
                                  v_scale=sc["v_scale"][:, :1])


# ---------------------------------------------------------------------------
# quantize-on-scatter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", KV)
def test_scatter_bit_equal_to_jax_interpret(kv):
    """Chunk rows [B=2, L=3] into a zero pool at (blk, off), inactive-lane
    duplicates into the trash block included; the JAX pools come over
    through ``paged_cache_from_jax``."""
    jcfg = jax_tiny_config(attention="dense", max_seq_len=32)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    jcache = jax_init_paged_cache(jcfg, params, 6, 4, kv_dtype=kv)
    attn = jcache["block0"]["attn"]
    k = rows((2, 3, 2, 16), seed=4)
    v = rows((2, 3, 2, 16), seed=5)
    blk = np.array([[3, 3, 4], [0, 0, 0]], np.int32)  # row 1: a dead lane
    off = np.array([[2, 3, 0], [0, 0, 0]], np.int32)
    outs = jax_paged_quantize_scatter(
        *map(jnp.asarray, (k, v, blk, off)), attn["key"], attn["value"],
        attn["key_scale"], attn["value_scale"], interpret=True)
    want = paged_cache_from_jax({"block0": {"attn": dict(zip(
        ("key", "value", "key_scale", "value_scale"), outs))}})[0]

    cfg = tiny_config(max_seq_len=32)
    got = init_paged_cache(cfg, 6, 4, kv_dtype=kv)[0]
    paged_flash.reset_launch_counts()
    paged_flash.paged_quantize_scatter(torch.from_numpy(k), torch.from_numpy(v),
                                       torch.from_numpy(blk).long(),
                                       torch.from_numpy(off).long(), *got)
    assert not any(paged_flash.quant_launch_counts.values())  # plain version on the CPU
    live = [(3, 2), (3, 3), (4, 0)]
    for g, w in zip(got, want):
        for b_, o_ in live:
            np.testing.assert_array_equal(bits(g[b_, o_]), bits(w[b_, o_]))
        others = torch.ones(g.shape[:2], dtype=torch.bool)
        for b_, o_ in live + [(0, 0)]:
            others[b_, o_] = False
        assert not g[others].view(torch.uint8).any()  # in place, nothing else
    with pytest.raises(ValueError, match="quantized pools"):
        paged_flash.paged_quantize_scatter(
            torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(blk).long(),
            torch.from_numpy(off).long(), *init_paged_cache(cfg, 6, 4)[0])


def test_cache_converters_round_trip():
    jcfg = jax_tiny_config(attention="dense", max_seq_len=32)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    for kv in (None,) + KV:
        tree = jax.tree.map(np.asarray, jax_init_paged_cache(jcfg, params, 3, 4,
                                                             kv_dtype=kv))
        rng = np.random.default_rng(0)
        tree = jax.tree.map(lambda a: rng.integers(0, 100, a.shape).astype(a.dtype), tree)
        cache = paged_cache_from_jax(tree)
        assert len(cache) == jcfg.num_layers
        assert (cache[0].key_scale is None) == (kv is None)
        back = paged_cache_to_jax(cache)
        for (pa, a), (pb, b_) in zip(jax.tree_util.tree_leaves_with_path(tree),
                                     jax.tree_util.tree_leaves_with_path(back)):
            assert pa == pb and a.dtype == b_.dtype
            np.testing.assert_array_equal(bits(a), bits(b_))


# ---------------------------------------------------------------------------
# the pools
# ---------------------------------------------------------------------------


def test_pool_block_bytes_matches_jax_and_the_capacity_ratios():
    jcfg = jax_tiny_config(attention="dense", max_seq_len=32, dtype=jnp.bfloat16)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = tiny_config(max_seq_len=32, dtype=torch.bfloat16)
    got = {kv: pool_block_bytes(cfg, 16, kv) for kv in (None,) + KV}
    for kv, n in got.items():
        assert n == jax_pool_block_bytes(jcfg, params, 16, kv_dtype=kv), kv
    d = cfg.head_dim
    assert got[None] / got["int8"] == pytest.approx(2 * d / (d + 4))
    assert got[None] / got["fp8"] == got[None] / got["fp8_e5m2"] == pytest.approx(
        2 * d / (d + 1))


# ---------------------------------------------------------------------------
# greedy streams against the JAX scheduler
# ---------------------------------------------------------------------------

MAX_SEQ = 64
SERVE = dict(n_slots=3, block_len=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params))


def prompts(n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=int(l)).astype(np.int32)
            for l in rng.integers(3, 25, size=n)]


def drain_all(sched, reqs, max_new=6):
    rids = [sched.submit(p, max_new) for p in reqs]
    out = sched.drain()
    return [[int(t) for t in out[r]] for r in rids]


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_greedy_streams_match_jax_scheduler(weights, kv):
    """``gather_impl="kernel"`` on the CPU runs the plain versions of the
    dequant attention and of the scatter; ``"dense"`` the
    ``quantize_kv`` + ``index_put_`` spelling: both equal JAX's streams."""
    jcfg, jparams, state = weights
    reqs = prompts()
    want = drain_all(JaxScheduler(jcfg, jparams, kv_dtype=kv, gather_impl="dense",
                                  **SERVE), reqs)
    cfg = tiny_config(max_seq_len=MAX_SEQ)
    for impl in ("kernel", "dense"):
        s = Scheduler(cfg, state, kv_dtype=kv, gather_impl=impl, device="cpu", **SERVE)
        assert drain_all(s, reqs) == want, impl
        assert s.engine.allocator.in_use == 0
        assert s.engine.cache[0].key.dtype == kv_pool_dtype(kv)
        assert s.metrics()["kv_dtype"] == kv
