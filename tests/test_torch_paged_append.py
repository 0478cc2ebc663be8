"""Kernel 9 on the append route: the scatter, then the attention, as one op.

``paged_flash.paged_quantize_scatter_attention`` writes a chunk's new K/V
rows into quantized pools at their positions and attends over the pools;
with bf16 q on the card the tensor-core sweep or split does both in one
launch (its blocks quantize and store the rows of their keys before they
read them; ``chip_smoke.py`` holds that launch bit-equal to the two-launch
route there). Here, on the CPU:

- the op's plain version against the JAX package's
  ``paged_quantize_scatter`` then ``paged_flash_attention`` in interpret
  mode, on the same numpy inputs: pools and scales bit-equal (outside the
  trash block), the output to 1e-4 in fp32, as ``test_torch_kv_quant.py``
  holds fp8 attention across the packages (XLA's ``exp2`` makes the fp8
  multipliers a few ulps off);
- ``test_torch_paged_quant_tc.py``'s emulation of the tensor-core scheme on
  the pools the op wrote, within one bf16 ulp of the Pallas kernel;
- the destinations the op derives against ``PagedIndex.build``'s;
- what the wrappers hand the library on the append route, and count;
- a paged ``TransformerLM`` on quantized pools with ``gather_impl="kernel"``
  going through the op and never through ``paged_quantize_scatter``.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.paged_flash import (
    paged_flash_attention as jax_paged_flash_attention,
)
from pytorch_distributed_tpu.ops.paged_flash import (
    paged_quantize_scatter as jax_paged_quantize_scatter,
)
from pytorch_distributed_tpu_torch.models import init_params, params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.models.transformer import PagedIndex
from pytorch_distributed_tpu_torch.ops import paged_flash
from pytorch_distributed_tpu_torch.serving import Scheduler
from pytorch_distributed_tpu_torch.serving.kv_pool import kv_pool_dtype, quantize_kv
from test_torch_paged_quant_tc import bf16_ulp, emulate_tc, to_jax

BF16, F32 = torch.bfloat16, torch.float32
KV = ("int8", "fp8", "fp8_e5m2")
H_KV, D, BL, W = 2, 16, 4, 6


def bits(t) -> np.ndarray:
    """The raw bytes of a torch tensor or a JAX array."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(t)).view(np.uint8)


def append_inputs(kv, c, g, dtype, seed=0):
    """Three lanes over quantized pools of noise: lane 0 a chunk ending at
    position 21 (its chain ragged, a trash tail), lane 1 a chunk ending at
    8 whose last row is padding (-1) when C > 1, lane 2 inactive: a
    trash-only table row at positions 0 .. C - 1 (for C > 1 the trash slots
    take two rows each, as the engine's padding jobs do). New rows [3, C,
    H_kv, D] spanning amax 1e-3 .. 50, q [3, C, G·H_kv, D] in ``dtype``."""
    rng = np.random.default_rng(seed + 10 * c + g)
    n_blocks = 1 + 3 * W
    pool_dt = kv_pool_dtype(kv)
    pools = []
    for _ in range(2):
        pools += list(quantize_kv(torch.from_numpy(
            rng.standard_normal((n_blocks, BL, H_KV, D)).astype(np.float32)), pool_dt))
    kq, ks, vq, vs = pools
    tables = np.zeros((3, W), np.int32)
    order = rng.permutation(np.arange(1, n_blocks))
    tables[0, :6] = order[:6]
    tables[1, :3] = order[6:9]
    pos = np.stack([np.arange(22 - c, 22), np.arange(9 - c, 9), np.arange(c)]).astype(np.int32)
    if c > 1:
        pos[1, -1] = -1
    scale = np.exp(rng.uniform(np.log(1e-3), np.log(50.0), (2, 3, c, H_KV, 1)))
    k, v = (torch.from_numpy((rng.standard_normal((3, c, H_KV, D)) * s).astype(np.float32))
            .to(dtype) for s in scale)
    q = torch.from_numpy(rng.standard_normal((3, c, g * H_KV, D)).astype(np.float32)).to(dtype)
    return q, k, v, [kq, vq, ks, vs], torch.from_numpy(tables), torch.from_numpy(pos)


def jax_scatter_then_attend(q, k, v, pools, tables, pos, split_s):
    """The JAX package's two calls in interpret mode: ``paged_quantize_
    scatter`` of the rows with a position (at ``tables[b, pos // bl]``, slot
    ``pos % bl``), then ``paged_flash_attention``. Returns the output and
    the four new pools as numpy arrays."""
    keep = pos.numpy() >= 0
    p = pos.numpy()[keep]
    b_idx = np.nonzero(keep)[0]
    blk = tables.numpy()[b_idx, p // BL]
    rows = [to_jax(x)[keep][None] for x in (k, v)]
    kq, vq, ks, vs = jax_paged_quantize_scatter(
        *rows, jnp.asarray(blk[None]), jnp.asarray((p % BL)[None]), *map(to_jax, pools),
        interpret=True)
    out = jax_paged_flash_attention(to_jax(q), kq, vq, jnp.asarray(tables.numpy()),
                                    jnp.asarray(pos.numpy()), k_scale=ks, v_scale=vs,
                                    split_s=split_s, interpret=True)
    return np.asarray(out.astype(jnp.float32)), (kq, vq, ks, vs)


def assert_pools_equal_outside_trash(got, want):
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(bits(g_)[1:], bits(w_)[1:])


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("c", [1, 8])
@pytest.mark.parametrize("g", [1, 4])
def test_plain_version_matches_jax_scatter_then_attention(kv, c, g):
    """fp32 q and rows: the pools bit-equal outside the trash block (with C
    > 1 the inactive lane writes each trash slot twice, in no fixed order),
    every output within 1e-4 but the inactive lane's at C > 1, which reads
    that trash; the padding row writes nothing and comes out 0."""
    q, k, v, pools, tables, pos = append_inputs(kv, c, g, F32)
    before = [t.clone() for t in pools]
    want, want_pools = jax_scatter_then_attend(q, k, v, before, tables, pos,
                                               split_s=2 if c == 1 else 1)
    paged_flash.reset_launch_counts()
    kq, vq, ks, vs = pools
    got = paged_flash.paged_quantize_scatter_attention(q, k, v, kq, vq, ks, vs, tables,
                                                       pos).numpy()
    assert not any(paged_flash.quant_launch_counts.values())  # the plain version
    assert not any(paged_flash.route_launch_counts.values())
    assert_pools_equal_outside_trash((kq, vq, ks, vs), want_pools)
    live = 3 if c == 1 else 2
    np.testing.assert_allclose(got[:live], want[:live], rtol=1e-4, atol=1e-4)
    if c > 1:
        assert not got[1, -1].any() and not want[1, -1].any()
    changed = [int((bits(a)[1:] != bits(b_)[1:]).any(axis=tuple(range(1, a.dim()))).sum())
               for a, b_ in zip((kq, vq, ks, vs), before)]
    # lane 0's C rows and lane 1's (C - 1) landed in C + (C - 1) slots
    assert all(n <= 2 * c for n in changed) and min(changed) > 0


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("c", [1, 8])
def test_tensor_core_scheme_on_the_appended_pools_within_one_bf16_ulp(kv, c):
    """bf16 q and rows, G = 4, as the model runs the append route: the
    pools the op wrote under ``emulate_tc``, the quantized tensor-core
    kernels' arithmetic, against the Pallas kernel in interpret mode over
    the same bytes: every output within one bf16 ulp, plus 2^-16 of its
    row's largest |value| for the scheme's ~16 bits of p·vs (an output
    that its row's terms cancel down to ~1e-5 carries that absolute
    error). (JAX's own scatter is held bit-equal above on fp32 rows; bf16
    rows put x·2^-e on fp8 rounding ties, where XLA's CPU ``exp2`` is a few
    ulps off.)"""
    q, k, v, pools, tables, pos = append_inputs(kv, c, 4, BF16, seed=1)
    before = [t.clone() for t in pools]
    paged_flash.paged_quantize_scatter_attention(q, k, v, *pools, tables, pos)
    kq, vq, ks, vs = pools
    assert all(not torch.equal(a[1:], b_[1:]) for a, b_ in zip(pools, before))
    want = jax_paged_flash_attention(to_jax(q), *map(to_jax, (kq, vq)),
                                     jnp.asarray(tables.numpy()), jnp.asarray(pos.numpy()),
                                     k_scale=to_jax(ks), v_scale=to_jax(vs), split_s=1,
                                     interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = emulate_tc(q, kq, vq, ks, vs, tables, pos).float().numpy()
    diff = np.abs(got - want)
    row_max = np.abs(want).max(axis=-1, keepdims=True)
    tol = bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + 2.0 ** -16 * row_max
    assert np.all(diff <= tol), (diff - tol).max()
    assert np.abs(want).max() > 0.1


def test_destinations_equal_paged_index():
    """``append_destinations`` is ``PagedIndex.build``'s (blk, off) for every
    row with a position, on ragged chains and trash rows; a padding row
    reads as position 0."""
    rng = np.random.default_rng(3)
    tables = torch.from_numpy(rng.integers(0, 40, (4, 9)).astype(np.int32))
    pos = torch.from_numpy(rng.integers(0, 9 * 5, (4, 7)))
    blk, off = paged_flash.append_destinations(tables, pos, 5)
    index = PagedIndex.build(pos, tables, 5)
    assert torch.equal(blk, index.blk) and torch.equal(off, index.off)
    pad = pos.clone()
    pad[1, 3] = -1
    blk_p, off_p = paged_flash.append_destinations(tables, pad, 5)
    assert blk_p[1, 3] == tables[1, 0] and off_p[1, 3] == 0


def test_two_launch_spelling_sends_padding_rows_to_the_trash_block():
    """``scatter_then_attend`` (kernel 9, then the attention) on the CPU:
    the same output and pools as the op, but for the trash block's slot 0,
    which takes the padding row."""
    q, k, v, pools, tables, pos = append_inputs("fp8", 8, 1, F32, seed=2)
    pos[2] = -1  # the inactive lane all padding: the trash takes only padding rows
    mine = [t.clone() for t in pools]
    two = [t.clone() for t in pools]
    out = paged_flash.paged_quantize_scatter_attention(q, k, v, *mine, tables, pos)
    out2 = paged_flash.scatter_then_attend(q, k, v, *two, tables, pos)
    assert torch.equal(out, out2)
    assert_pools_equal_outside_trash(mine, two)
    assert all(torch.equal(a[0, 1:], b[0, 1:]) for a, b in zip(mine, two))
    assert torch.equal(mine[0][0], pools[0][0])  # the op wrote no padding row
    assert not torch.equal(two[0][0, 0], pools[0][0, 0])


def test_op_checks_its_operands():
    q, k, v, pools, tables, pos = append_inputs("int8", 1, 1, F32)
    with pytest.raises(ValueError, match="k, v must be"):
        paged_flash.paged_quantize_scatter_attention(q, k[:, :, :1], v, *pools, tables, pos)
    with pytest.raises(ValueError, match="quantized pools"):
        paged_flash.paged_quantize_scatter_attention(
            q, k, v, pools[0].float(), pools[1].float(), None, None, tables, pos)
    with pytest.raises(ValueError, match="split_s"):
        paged_flash.paged_quantize_scatter_attention(q, k, v, *pools, tables, pos, split_s=0)


# ---------------------------------------------------------------------------
# what the wrappers hand the library
# ---------------------------------------------------------------------------


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


def fake_operands(pool_dtype=torch.float8_e4m3fn, q_dtype=BF16):
    b, c, h, h_kv, d, bl, w, n_blocks = 2, 3, 8, 2, 64, 16, 5, 11
    q = torch.zeros((b, c, h, d), dtype=q_dtype)
    qkv = torch.zeros((b, c, 3, h_kv, d), dtype=BF16)  # the fused projection's views
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    k_pool = torch.zeros((n_blocks, bl, h_kv, d), dtype=pool_dtype)
    sdt = F32 if pool_dtype == torch.int8 else torch.int8
    scales = [torch.zeros((n_blocks, bl, h_kv), dtype=sdt) for _ in "kv"]
    tables = torch.zeros((b, w), dtype=torch.int32)
    qpos = torch.zeros((b, c), dtype=torch.int32)
    return q, k, v, k_pool, k_pool.clone(), scales, tables, qpos


@pytest.fixture
def fake_lib(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(paged_flash, "_library", lambda: lib)
    monkeypatch.setattr(paged_flash, "_stream", lambda t: ctypes.c_void_p(None))
    return lib


@pytest.mark.parametrize("pool_dtype", [torch.int8, torch.float8_e4m3fn, torch.float8_e5m2])
@pytest.mark.parametrize("split_s", [1, 3])
def test_append_launch_hands_the_new_rows_and_counts_one_launch(fake_lib, pool_dtype, split_s):
    """The append route is one call of the tensor-core entry point with
    the new rows' pointers, (batch, chunk, head) strides in elements and
    dtype code after the scale; it counts one launch of its kernel on the
    pool's variant and the tensor-core route, and one under
    ``append_key``."""
    q, k, v, kp, vp, (ks, vs), tables, qpos = fake_operands(pool_dtype)
    paged_flash.reset_launch_counts()
    out = paged_flash._launch(q, kp, vp, tables, qpos, None, split_s, ks, vs,
                              new=(paged_flash._in_rows(k), paged_flash._in_rows(v)))
    assert out.shape == q.shape and out.dtype == BF16
    kernel = paged_flash.SWEEP if split_s == 1 else paged_flash.SPLIT
    name, args = fake_lib.calls[-1]
    assert name == f"pdt_paged_attention_{'sweep' if split_s == 1 else 'split'}_tc"
    at = 20 if split_s == 1 else 25  # after the scale
    assert args[at].value == k.data_ptr() and tuple(args[at + 1:at + 4]) == k.stride()[:3]
    assert args[at + 4].value == v.data_ptr() and tuple(args[at + 5:at + 8]) == v.stride()[:3]
    assert args[at + 8] == 1  # bf16
    assert {key: n for key, n in paged_flash.route_launch_counts.items() if n} == {
        paged_flash.route_key(kernel, paged_flash.TENSOR_CORES): 1,
        paged_flash.append_key(kernel, pool_dtype): 1}
    assert {key: n for key, n in paged_flash.quant_launch_counts.items() if n} == {
        paged_flash.variant(kernel, pool_dtype): 1}


def test_plain_launch_passes_no_new_rows(fake_lib):
    q, _, _, kp, vp, (ks, vs), tables, qpos = fake_operands()
    paged_flash.reset_launch_counts()
    paged_flash.launch_sweep(q, kp, vp, tables, qpos, 0.125, k_scale=ks, v_scale=vs)
    args = fake_lib.calls[-1][1]
    assert [args[20].value, args[24].value] == [None, None]
    assert not any(n for key, n in paged_flash.route_launch_counts.items()
                   if paged_flash.APPEND in key)


def test_append_route_refuses_the_walk(fake_lib):
    """fp32 q runs the CUDA-core walk, which has no append route: handing
    it new rows raises rather than dropping them."""
    q, k, v, kp, vp, (ks, vs), tables, qpos = fake_operands(q_dtype=F32)
    with pytest.raises(ValueError, match="append route"):
        paged_flash.launch_sweep(q, kp, vp, tables, qpos, 0.125, k_scale=ks, v_scale=vs,
                                 new=(k, v))
    assert not fake_lib.calls


def test_new_rows_are_read_16_bytes_at_a_time():
    """The fused projection's views pass as they are; a view whose rows
    are not 16-byte aligned is copied."""
    qkv = torch.zeros((2, 3, 3, 2, 64), dtype=BF16)
    assert paged_flash._in_rows(qkv[:, :, 1]).data_ptr() == qkv[:, :, 1].data_ptr()
    odd = torch.zeros((2, 3, 2, 68), dtype=BF16)[..., 4:]  # 8-byte offset rows
    got = paged_flash._in_rows(odd)
    assert got.is_contiguous() and torch.equal(got, odd)


# ---------------------------------------------------------------------------
# the model's path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_model_on_quantized_pools_goes_through_the_op(kv, monkeypatch):
    """A paged serve with ``gather_impl="kernel"`` on the CPU writes every
    layer's rows through ``paged_quantize_scatter_attention``, never
    through ``paged_quantize_scatter``, and streams exactly as the dense
    spelling (the scatter's plain version, then the plain attention)."""
    cfg = tiny_config(max_seq_len=64)
    state = params_from_jax(init_params(cfg, seed=0))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 11, 3)]

    def serve(impl):
        s = Scheduler(cfg, state, 2, block_len=8, prefill_chunk=8, kv_dtype=kv,
                      gather_impl=impl, device="cpu")
        ids = [s.submit(p, 4) for p in prompts]
        out = s.drain()
        return [out[i] for i in ids]

    want = serve("dense")
    calls = []
    op = paged_flash.paged_quantize_scatter_attention

    def counted(*a, **k):
        calls.append(a[0].shape)
        return op(*a, **k)

    def refused(*a, **k):
        raise AssertionError("paged_quantize_scatter on the kernel path")

    monkeypatch.setattr(paged_flash, "paged_quantize_scatter_attention", counted)
    monkeypatch.setattr(paged_flash, "paged_quantize_scatter", refused)
    assert serve("kernel") == want
    assert len(calls) > 0 and len(calls) % cfg.num_layers == 0


# ---------------------------------------------------------------------------
# chip_smoke.py's append-route checks, rehearsed on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def chip_smoke(monkeypatch):
    """``chip_smoke.py`` loaded as a module, its append-route shapes cut to
    CPU sizes with their structure kept: an inactive lane, a chunk, D =
    128 with GQA, GQA R = 80 with padding rows."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def small(torch, dev="cuda"):
        decode = cs.decode_inputs(torch, F32, b=3, h=4, h_kv=4, w=8, seed=12, dev=dev)
        decode["block_tables"][-1] = 0
        decode["q_positions"][-1] = 0
        chunk = cs.decode_inputs(torch, F32, b=2, c=8, h=4, h_kv=4, w=8, seed=13, dev=dev,
                                 positions=np.stack([np.arange(8), 40 + np.arange(8)]))
        pos = np.full((3, 20), -1)
        pos[0] = 100 + np.arange(20)
        pos[1, :7] = 40 + np.arange(7)
        return (("decode, the last lane inactive", decode), ("chunk", chunk),
                ("D=128", cs.decode_inputs(torch, F32, b=2, c=2, h=4, h_kv=2, d=128, w=8,
                                           seed=14, dev=dev)),
                ("R=80", cs.decode_inputs(torch, F32, b=3, c=20, h=8, h_kv=2, w=8, seed=15,
                                          positions=pos, dev=dev)))

    monkeypatch.setattr(cs, "append_shapes", small)
    return cs


def test_chip_smoke_append_checks_rehearse_on_cpu(chip_smoke, capsys):
    """Phase (b)'s append-route checks on the plain versions: every shape,
    pool dtype and split_s passes, and each reports its pools, its output
    against the two-launch route's and its repeat."""
    failures = []
    errs = chip_smoke.check_append_route(torch, failures, dev="cpu")
    assert failures == []
    assert set(errs) == {paged_flash.variant(paged_flash.QUANTIZE, kv_pool_dtype(kv))
                         for kv in KV}
    out = capsys.readouterr().out
    assert out.count("pools bit-equal to the plain scatter's; output bit-equal to the "
                     "two-launch route's; two launches bitwise equal") == 3 * 4 * 3
    assert "FAIL" not in out and "DIFFER" not in out


def test_chip_smoke_append_check_fails_a_stray_pool_byte(chip_smoke, monkeypatch):
    """A route that writes one byte more than the plain scatter fails the
    check (outside the trash block, where padding rows may land)."""
    op = paged_flash.paged_quantize_scatter_attention

    def stray(q, k, v, k_pool, *rest, **kw):
        out = op(q, k, v, k_pool, *rest, **kw)
        k_pool.view(torch.uint8)[-1, -1, -1, -1] ^= 1
        return out

    monkeypatch.setattr(paged_flash, "paged_quantize_scatter_attention", stray)
    failures = []
    chip_smoke.check_append_route(torch, failures, dev="cpu")
    assert len(failures) == 3 * 4 * 3
