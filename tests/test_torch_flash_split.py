"""Kernel 6, the split FlashAttention backward, on the CPU: its plain
version against the JAX package's ``_flash_bwd`` and the ``bwd_impl``
switch of the port's ``flash_attention``.

The JAX split kernels (``_bwd_dq_kernel``, ``_bwd_dkv_kernel``) run in the
Pallas interpreter, as the JAX package's own tests run them on the CPU, at
blocks of 16 over L = 32 (and a ragged 30, zero-padded with its keys past
30 masked), on the O and LSE of the JAX forward, which both sides then
share. The port's CUDA kernels run only on the card, where
``chip_smoke.py`` holds them to the same plain version.

Tolerances: fp32, 1e-4 relative and 1e-5 absolute on gradients of order 1
(summation order only: the interpreter sums 16-wide tiles, the plain
version whole rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.flash_attention import _flash_bwd, _flash_fwd
from pytorch_distributed_tpu.ops.flash_attention import compute_delta as jax_compute_delta
from pytorch_distributed_tpu.ops.flash_attention import flash_attention as jax_flash
from pytorch_distributed_tpu.ops.ring_flash import ring_flash_attention as jax_ring_flash
from pytorch_distributed_tpu_torch.ops import flash_attention as fa
from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention
from pytorch_distributed_tpu_torch.ops.ring_flash import ring_flash_attention

BLOCK = 16
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def qkv(b=2, l=32, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, h, d), np.float32) for _ in range(4)]


def to3(x, n):
    """[B, L, H, D] → the JAX kernels' [BH, L_pad, D], zero-padded to blocks."""
    b, _, h, d = x.shape
    x = jnp.pad(jnp.asarray(x), ((0, 0), (0, (-n) % BLOCK), (0, 0), (0, 0)))
    return jnp.moveaxis(x, 2, 1).reshape(b * h, -1, d)


def from3(x3, b, h, l):
    x = np.asarray(x3, np.float32)[:, :l]
    return x.reshape(b, h, l, -1).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("l", [32, 30])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_split_pallas(causal, l):
    """dQ (the ``_bwd_dq_kernel`` sweep over key blocks) and dK, dV (the
    ``_bwd_dkv_kernel`` sweep over query blocks) against the plain version
    on the same O and LSE."""
    q, k, v, do = qkv(l=l, seed=1)
    b, _, h, d = q.shape
    scale = d ** -0.5
    o3, lse3 = _flash_fwd(to3(q, l), to3(k, l), to3(v, l), scale, causal, BLOCK, BLOCK, l,
                          True)
    dq3, dk3, dv3 = _flash_bwd(to3(q, l), to3(k, l), to3(v, l), o3, lse3, to3(do, l), scale,
                               causal, (BLOCK, BLOCK), (BLOCK, BLOCK), l, True)
    o = torch.from_numpy(from3(o3, b, h, l).copy())
    lse = torch.from_numpy(np.asarray(lse3)[:, :l, 0].reshape(b, h, l).copy())
    got = fa.flash_backward_reference(*(torch.from_numpy(x) for x in (q, k, v)), o, lse,
                                      torch.from_numpy(do), causal=causal, scale=scale)
    for g, w in zip(got, (dq3, dk3, dv3)):
        np.testing.assert_allclose(g.numpy(), from3(w, b, h, l), **GRAD_TOL)


def test_precomputed_delta_matches_jax_compute_delta():
    """Δ = rowsum(dO ⊙ O) as the ring precomputes it, against the JAX
    ``compute_delta`` (exact: one fp32 product and sum per row), and a
    backward given it equals one that computes it."""
    q, k, v, do = qkv(l=20, seed=2)
    b, l, h, d = q.shape
    o = np.random.default_rng(3).standard_normal(q.shape, np.float32)
    want = np.asarray(jax_compute_delta(to3(do, l), to3(o, l)))[:, :l, 0].reshape(b, h, l)
    delta = fa.compute_delta(torch.from_numpy(do), torch.from_numpy(o))
    assert delta.is_contiguous() and delta.shape == (b, h, l)
    np.testing.assert_allclose(delta.numpy(), want, rtol=1e-6, atol=1e-6)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    _, lse = fa.flash_forward(*t, causal=True, scale=0.25)
    for impl in fa.BWD_IMPLS:
        given = fa.flash_backward(*t, torch.from_numpy(o), lse, torch.from_numpy(do),
                                  causal=True, scale=0.25, bwd_impl=impl, delta=delta)
        own = fa.flash_backward(*t, torch.from_numpy(o), lse, torch.from_numpy(do),
                                causal=True, scale=0.25, bwd_impl=impl)
        for a, c in zip(given, own):
            torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_split_and_fused_give_the_same_gradients_on_cpu(causal):
    """On CPU tensors both backwards run the one plain version: equal
    gradients, no kernel launched, and the split's gradients match JAX's
    split vjp."""
    q, k, v, do = qkv(l=30, seed=4)
    grads = {}
    fa.reset_launch_counts()
    for impl in fa.BWD_IMPLS:
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        flash_attention(*ts, causal=causal, bwd_impl=impl).backward(torch.from_numpy(do))
        grads[impl] = [t.grad for t in ts]
    assert all(n == 0 for n in fa.launch_counts.values())
    for a, c in zip(grads["fused"], grads["split"]):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    _, vjp = jax.vjp(lambda a, b_, c: jax_flash(a, b_, c, causal=causal, block_q=BLOCK,
                                                block_k=BLOCK, bwd_impl="split",
                                                interpret=True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    for g, w in zip(grads["split"], vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_a_bad_bwd_impl_raises_as_in_jax():
    q, k, v, _ = qkv(l=8)
    with pytest.raises(ValueError) as jax_err:
        jax_flash(*(jnp.asarray(x) for x in (q, k, v)), bwd_impl="bogus", interpret=True)
    with pytest.raises(ValueError) as err:
        flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), bwd_impl="bogus")
    assert str(err.value) == str(jax_err.value)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    with pytest.raises(ValueError, match="must be 'split'"):
        fa.flash_backward(*t, t[0], torch.zeros(2, 2, 8), t[0], causal=True, scale=1.0,
                          bwd_impl="bogus")
    with pytest.raises(ValueError) as jax_ring_err:
        jax_ring_flash(*(jnp.asarray(x) for x in (q, k, v)), bwd_impl="bogus", interpret=True)
    with pytest.raises(ValueError) as ring_err:
        ring_flash_attention(*t, bwd_impl="bogus")
    assert str(ring_err.value) == str(jax_ring_err.value)


def test_split_kernel_operands_follow_the_fused_contract():
    """The split launcher takes what the fused one takes: its operand checks
    are ``_check_cuda_operands``, and Δ and LSE go to the kernels as one
    zero-padded ``[2, B·H, 64]`` buffer of rows even when the ring hands over
    a zigzag chunk's slice of them."""
    t = torch.zeros(2, 8, 2, 64)
    lse = torch.arange(2 * 2 * 16, dtype=torch.float32).view(2, 2, 16)[:, :, 8:]
    assert not lse.is_contiguous()
    args, rows = fa._backward_operands(t, t, t, t, lse, t, None)
    assert rows.shape == (2, 4, 64) and rows.is_contiguous()
    assert torch.equal(rows[0, :, :8], lse.reshape(4, 8)) and not rows[:, :, 8:].any()
    assert not rows[1].any()  # Δ = rowsum(dO ⊙ O) of zeros
    assert len(args) == 10  # four operands with their tensor maps, then the rows and their ld
    assert args[-1] == 64
    with pytest.raises(ValueError, match="head dim"):
        fa._check_cuda_operands(*[torch.zeros(2, 8, 2, 32)] * 5)
