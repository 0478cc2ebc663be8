"""The port's flash attention and dense attention against the JAX package's.

The JAX flash kernels run as the JAX package's own tests run them on the
CPU: in the Pallas interpreter. The port runs its plain versions here,
the arithmetic its CUDA kernels repeat on the card (``chip_smoke.py``
holds the kernels to them). Inputs are made from a seed with numpy.

Tolerances: fp32 results agree to 1e-5 absolute (summation order only:
the interpreter sums tile by tile with an online softmax, the plain
version over whole rows). bf16 outputs agree to 2e-2, about two bf16
ulps at |O| ~ 1: the interpreter rounds p to bf16 against the running
row max, the plain version against the final one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.attention import dense_attention as jax_dense
from pytorch_distributed_tpu.ops.flash_attention import _flash_fwd
from pytorch_distributed_tpu.ops.flash_attention import flash_attention as jax_flash
from pytorch_distributed_tpu_torch.ops import flash_attention as fa
from pytorch_distributed_tpu_torch.ops.attention import NEG_INF, dense_attention
from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention

BLOCK = 16
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.0, atol=2e-2)


def qkv(b=2, l=32, h=2, d=16, lk=None, seed=0):
    rng = np.random.default_rng(seed)
    lk = lk or l
    return (rng.standard_normal((b, l, h, d), np.float32),
            rng.standard_normal((b, lk, h, d), np.float32),
            rng.standard_normal((b, lk, h, d), np.float32),
            rng.standard_normal((b, l, h, d), np.float32))


def jax_forward(q, k, v, causal, dtype=jnp.float32):
    """``_flash_fwd`` in interpret mode on block-padded [BH, L, D] inputs,
    back in the port's layouts: O [B, L, H, D], LSE [B, H, L]."""
    b, l, h, d = q.shape
    lk = k.shape[1]

    def to3(x, n):
        x = jnp.pad(jnp.asarray(x, dtype), ((0, 0), (0, (-n) % BLOCK), (0, 0), (0, 0)))
        return jnp.moveaxis(x, 2, 1).reshape(b * h, -1, d)

    o3, lse3 = _flash_fwd(to3(q, l), to3(k, lk), to3(v, lk), d ** -0.5, causal,
                          BLOCK, BLOCK, lk, True)
    o = np.asarray(o3, np.float32)[:, :l].reshape(b, h, l, d).transpose(0, 2, 1, 3)
    lse = np.asarray(lse3)[:, :l, 0].reshape(b, h, l)
    return o, lse


def t(x, dtype=torch.float32, grad=False):
    return torch.tensor(x, dtype=dtype, requires_grad=grad)


@pytest.mark.parametrize("l,lk", [(32, 32), (30, 30), (24, 50)])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_pallas_fp32(causal, l, lk):
    """O and LSE, fp32, block-multiple and ragged lengths, Lq != Lk."""
    q, k, v, _ = qkv(l=l, lk=lk)
    want_o, want_lse = jax_forward(q, k, v, causal)
    o, lse = fa.flash_forward(t(q), t(k), t(v), causal=causal, scale=16 ** -0.5)
    np.testing.assert_allclose(o.numpy(), want_o, **F32_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_pallas_bf16(causal):
    """bf16: q scaled in bf16, p rounded to bf16 before PV, as Pallas."""
    q, k, v, _ = qkv(l=30, seed=1)
    want_o, want_lse = jax_forward(q, k, v, causal, jnp.bfloat16)
    bf = [t(x).bfloat16() for x in (q, k, v)]
    o, lse = fa.flash_forward(*bf, causal=causal, scale=16 ** -0.5)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), want_o, **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("l", [32, 30])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_fused_pallas(causal, l):
    """dQ, dK, dV against ``jax.vjp`` of the fused backward with fp32 dQ
    partials (the port sums dQ in fp32), fp32, with the same cotangent."""
    q, k, v, do = qkv(l=l, seed=2)
    out, vjp = jax.vjp(
        lambda a, b, c: jax_flash(a, b, c, causal=causal, block_q=BLOCK, block_k=BLOCK,
                                  bwd_impl="fused", partials_f32=True, interpret=True),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = t(q, grad=True), t(k, grad=True), t(v, grad=True)
    o = flash_attention(tq, tk, tv, causal=causal)
    o.backward(t(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), **F32_TOL)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_fully_masked_rows_give_zero_not_nan():
    """k_offset 5 hides every key from query rows 0-4: O = 0, LSE =
    NEG_INF, zero gradients from those rows, against JAX dense_attention
    with the same offsets (values and vjp, fp32)."""
    q, k, v, do = qkv(l=12, seed=3)
    out, vjp = jax.vjp(
        lambda a, b, c: jax_dense(a, b, c, causal=True, q_offset=0, k_offset=5),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = t(q, grad=True), t(k, grad=True), t(v, grad=True)
    o = flash_attention(tq, tk, tv, causal=True, q_offset=0, k_offset=5)
    o.backward(t(do))
    assert torch.isfinite(o).all() and (o[:, :5] == 0).all()
    _, lse = fa.flash_forward(t(q), t(k), t(v), causal=True, scale=16 ** -0.5, shift=-5)
    assert (lse[:, :, :5] == NEG_INF).all() and (lse[:, :, 5:] > NEG_INF).all()
    assert (tq.grad[:, :5] == 0).all()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), **F32_TOL)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("causal,q_off,k_off", [(False, 0, 0), (True, 0, 0),
                                                (True, 3, 0), (True, 0, 7)])
def test_dense_attention_matches_jax(causal, q_off, k_off):
    """Values in fp32 and bf16 (output rounding only) and fp32 grads."""
    q, k, v, do = qkv(l=20, seed=4)
    fn = lambda a, b, c: jax_dense(a, b, c, causal=causal, q_offset=q_off,  # noqa: E731
                                   k_offset=k_off)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = t(q, grad=True), t(k, grad=True), t(v, grad=True)
    o = dense_attention(tq, tk, tv, causal=causal, q_offset=q_off, k_offset=k_off)
    o.backward(t(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), **F32_TOL)
    for got, w in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    ob = dense_attention(*(t(x).bfloat16() for x in (q, k, v)), causal=causal,
                         q_offset=q_off, k_offset=k_off)
    want_b = fn(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    np.testing.assert_allclose(ob.float().numpy(), np.asarray(want_b, np.float32),
                               **BF16_TOL)


def test_flash_grads_equal_autograd_through_dense():
    """The written-out backward against autograd through the port's own
    dense attention: an independent derivation of the same gradient."""
    q, k, v, do = qkv(l=30, seed=5)
    grads = []
    for fn in (flash_attention, dense_attention):
        ts = [t(x, grad=True) for x in (q, k, v)]
        fn(*ts, causal=True).backward(t(do))
        grads.append([x.grad for x in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_wrapper_runs_the_plain_version_on_cpu_only():
    q, k, v, do = qkv(l=16, seed=6)
    fa.reset_launch_counts()
    o = flash_attention(*(t(x, grad=True) for x in (q, k, v)), causal=True)
    o.backward(t(do))
    assert fa.launch_counts == {fa.FWD: 0, fa.BWD: 0, fa.BWD_DKV: 0, fa.BWD_DQ: 0}
    meta = [t(x).to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_forward(*meta, causal=True, scale=0.25)
    with pytest.raises(ValueError, match="differ"):
        flash_attention(t(q), t(k)[:, :, :1], t(v)[:, :, :1])
    with pytest.raises(ValueError, match=r"\[B, Lq, H, D\]"):
        flash_attention(t(q)[0], t(k), t(v))


def test_kernel_operand_checks():
    """What the CUDA wrapper refuses before a launch (checked here on CPU
    tensors, as the checks read only dtype, shape and strides)."""
    ok = torch.zeros(2, 8, 2, 64)
    fa._check_cuda_operands(ok, ok, ok)
    with pytest.raises(ValueError, match="head dim 16"):
        fa._check_cuda_operands(*[torch.zeros(2, 8, 2, 16)] * 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check_cuda_operands(*[ok.half()] * 3)
    with pytest.raises(TypeError, match="dtypes"):
        fa._check_cuda_operands(ok, ok.bfloat16(), ok)
    with pytest.raises(ValueError, match="unit stride"):
        fa._check_cuda_operands(ok.transpose(2, 3), ok, ok)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._check_cuda_operands(torch.zeros(2, 8, 2, 65)[..., 1:], ok, ok)
    with pytest.raises(ValueError, match="non-empty"):
        fa._check_cuda_operands(torch.zeros(2, 0, 2, 64), ok, ok)


def _addressed(t, geometry):
    """The elements a tensor map of ``geometry`` reads for ``t``, gathered
    from t's storage through the map's dims and byte strides."""
    d, h, l, b, sh, sl, sb = geometry[:7]
    e = t.element_size()
    assert sh % 16 == sl % 16 == sb % 16 == 0  # TMA's stride rule
    flat = torch.as_strided(t, (t.untyped_storage().nbytes() // e,), (1,), 0)
    idx = (t.storage_offset() + torch.arange(b)[:, None, None, None] * (sb // e)
           + torch.arange(l)[None, :, None, None] * (sl // e)
           + torch.arange(h)[None, None, :, None] * (sh // e)
           + torch.arange(d)[None, None, None, :])
    return flat[idx]


@pytest.mark.parametrize("d", [64, 128])
def test_tensor_map_geometry_reads_fused_qkv_views(d):
    """q, k, v as the fused qkv projection hands them over: views of the
    JAX package's DenseGeneral((3, H, D)) output ``[B, L, 3, H, D]``. Each
    map reads exactly its operand, and its box is one 64 x 64 tile of one
    (batch, head), D / 64 boxes a row."""
    import flax.linen as nn

    b, l, h, e = 2, 70, 3, 32
    out = jax.eval_shape(lambda x: nn.DenseGeneral((3, h, d)).init_with_output(
        jax.random.PRNGKey(0), x)[0], jnp.zeros((b, l, e))).shape
    assert out == (b, l, 3, h, d)
    qkv = torch.randn(out).bfloat16()
    for i, x in enumerate(qkv.unbind(dim=2)):
        g = fa.tensor_map_geometry(x)
        assert g == (d, h, l, b, d * 2, 3 * h * d * 2, l * 3 * h * d * 2, 64, 1, 64, 1)
        assert torch.equal(_addressed(x, g), x)
        assert (x.data_ptr() - qkv.data_ptr()) == i * h * d * 2  # 16-byte aligned
        assert d % g[7] == 0 and g[7] == g[9] == fa.TILE


def test_tensor_map_geometry_reads_zigzag_chunk_views():
    """The ring's zigzag visit hands each half of a shard over as a view
    (``ring_flash._row_parts``): the map starts at the chunk and keeps the
    shard's strides, so no copy is made."""
    from pytorch_distributed_tpu_torch.ops.ring_flash import _row_parts

    shard = torch.randn(2, 1024, 3, 64).bfloat16()
    for part in _row_parts("zigzag", 1024):
        x = shard[:, part]
        g = fa.tensor_map_geometry(x)
        assert g[:4] == (64, 3, 512, 2) and g[4:7] == (128, 3 * 128, 1024 * 3 * 128)
        assert torch.equal(_addressed(x, g), x) and x.data_ptr() % 16 == 0


@pytest.mark.parametrize("lq", [1, 64, 130, 2048])
def test_row_stats_and_dq_workspace_sizes(lq):
    """LSE and Δ become one zero-padded ``[2, B·H, ceil(Lq/64)·64]`` buffer
    (every Q tile one aligned 256-byte copy); the fused backward's counters
    are one int32 per (batch·head, Q tile), zero; its fp32 dQ holds one
    contiguous 64 x D tile per counter, zeroed only where some Q tile sees
    no key (causal, shift < -63)."""
    b, h = 2, 3
    lse, delta = torch.randn(b, h, lq), torch.randn(b, h, lq)
    rows = fa.row_stats(lse, delta)
    n_qt = -(-lq // 64)
    assert rows.shape == (2, b * h, n_qt * 64) and rows.dtype == torch.float32
    assert torch.equal(rows[0, :, :lq], lse.reshape(b * h, lq))
    assert torch.equal(rows[1, :, :lq], delta.reshape(b * h, lq))
    assert not rows[:, :, lq:].any()
    for d in (64, 128):
        for causal, shift, zeroed in ((True, 0, False), (False, -500, False),
                                      (True, -63, False), (True, -64, True)):
            ws, turns = fa.dq_workspace(b, lq, h, d, causal, shift, "cpu")
            assert ws.shape == (b * h, n_qt, 64 * d) and ws.dtype == torch.float32
            assert turns.shape == (b * h, n_qt) and turns.dtype == torch.int32
            assert not turns.any()
            if zeroed:
                assert not ws.any()


@pytest.mark.parametrize("lq, d", [(70, 64), (128, 128)])
def test_dq_from_workspace_reads_the_kernels_thread_order(lq, d):
    """The fused kernel leaves each dQ tile in its consumer threads' order:
    float4 ``8x + j`` of thread ``32w + 4g + t`` holds rows 16w + g and
    16w + g + 8, columns 64x + 8j + 2t and + 1. Written so here, by loops
    over the threads, the tiles read back as ``[B, Lq, H, D]``, ragged
    rows cut, contiguous."""
    b, h = 2, 2
    want = torch.randn(b, lq, h, d)
    ws, _ = fa.dq_workspace(b, lq, h, d, True, 0, "cpu")
    pad = torch.zeros(b, ws.shape[1] * 64, h, d)
    pad[:, :lq] = want
    for bh in range(b * h):
        bb, hh = divmod(bh, h)
        for qt in range(ws.shape[1]):
            tile = ws[bh, qt].view(-1, 128, 4)
            for tid in range(128):
                w, g, t = tid // 32, tid % 32 // 4, tid % 4
                r = qt * 64 + 16 * w + g
                for x in range(d // 64):
                    for j in range(8):
                        c = 64 * x + 8 * j + 2 * t
                        tile[8 * x + j, tid] = torch.stack(
                            [pad[bb, r, hh, c], pad[bb, r, hh, c + 1], pad[bb, r + 8, hh, c],
                             pad[bb, r + 8, hh, c + 1]])
    got = fa.dq_from_workspace(ws, b, lq, torch.bfloat16)
    assert got.is_contiguous() and torch.equal(got, want.bfloat16())
