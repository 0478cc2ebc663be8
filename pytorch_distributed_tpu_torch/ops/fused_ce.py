"""Fused (chunked) linear + softmax cross-entropy
(``pytorch_distributed_tpu/ops/fused_ce.py``).

The weighted CE sum of ``x @ W^T`` without the fp32 ``[N, V]`` logits ever
existing: the rows go through in blocks of ``block_n``; each block's
logits are reduced at once to per-row ``lse`` and label logit ``z``. The
backward recomputes each block's logits and feeds ``softmax − onehot``
straight into the dx and dW products, so its peak is one block too. The
JAX version is a ``lax.scan`` with a custom vjp and no Pallas kernel; this
is a ``torch.autograd.Function`` in plain PyTorch. With ``vocab_axis``
(Megatron vocab-parallel heads) each rank holds its rows of the head: the
rows' local ``lse`` and label logit combine across the axis (a max and a
sum all-reduce of every row's statistics at once, where JAX reduces each
block's), and dx is summed over the axis the row-parallel way.

Operands are rounded to the compute dtype and the products accumulate and
come out in fp32 (``_matmul_f32``). A bf16 value is exact in TF32, so on
the card the product of the rounded operands runs as an fp32 matmul with
TF32 allowed: the bf16 product with fp32 accumulation, not bf16 logits.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch.parallel.collectives import all_reduce_


@contextlib.contextmanager
def _tf32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _rounded(t: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the compute dtype, held in fp32."""
    return t.to(cdt).float()


def _matmul_f32(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``a @ b`` of operands already rounded to ``cdt``: fp32 products and
    accumulation (TF32 on the card, exact for bf16 values)."""
    if cdt == torch.float32:
        return a @ b
    with _tf32_matmul():
        return a @ b


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, labels, weights, block_n: int, cdt: torch.dtype, axis):
        n, v_local = x.shape[0], weight.shape[0]
        w_t = _rounded(weight, cdt).t()
        # this rank's ids of the labels: out of range on other vocab shards
        loc = labels.long() - (axis.index * v_local if axis is not None else 0)
        hit = (loc >= 0) & (loc < v_local)
        safe = loc.clamp(0, v_local - 1)
        lse = torch.empty(n, dtype=torch.float32, device=x.device)
        z = torch.empty(n, dtype=torch.float32, device=x.device)
        for lo in range(0, n, block_n):
            logits = _matmul_f32(_rounded(x[lo:lo + block_n], cdt), w_t, cdt)
            lse[lo:lo + block_n] = torch.logsumexp(logits, dim=-1)
            z[lo:lo + block_n] = logits.gather(1, safe[lo:lo + block_n, None])[:, 0]
        if axis is not None:
            # the shards' statistics: lse = m + log Σ_r exp(lse_r - m) with
            # m the max over shards; z from the one shard that holds the
            # label (two all-reduces for every row at once)
            m = all_reduce_(lse.clone(), dist.ReduceOp.MAX, axis.group)
            sums = all_reduce_(torch.stack([torch.exp(lse - m),
                                            torch.where(hit, z, torch.zeros_like(z))]),
                               group=axis.group)
            lse, z = m + torch.log(sums[0]), sums[1]
        ctx.save_for_backward(x, weight, safe, hit, weights, lse)
        ctx.args = (block_n, cdt, axis)
        return ((lse - z) * weights.float()).sum()

    @staticmethod
    def backward(ctx, g):
        x, weight, safe, hit, weights, lse = ctx.saved_tensors
        block_n, cdt, axis = ctx.args
        n = x.shape[0]
        w = _rounded(weight, cdt)
        dx = torch.empty(x.shape, dtype=torch.float32 if axis is not None else x.dtype,
                         device=x.device)
        dw = torch.zeros(weight.shape, dtype=torch.float32, device=weight.device)
        scale = weights.float() * g
        onehot = -hit.float()  # softmax - onehot; a label on another shard hits nothing
        for lo in range(0, n, block_n):
            x_i = _rounded(x[lo:lo + block_n], cdt)
            p = torch.exp(_matmul_f32(x_i, w.t(), cdt) - lse[lo:lo + block_n, None])
            p.scatter_add_(1, safe[lo:lo + block_n, None], onehot[lo:lo + block_n, None])
            dl = _rounded(p * scale[lo:lo + block_n, None], cdt)
            dx[lo:lo + block_n] = _matmul_f32(dl, w, cdt)
            dw += _matmul_f32(dl.t(), x_i, cdt)
        if axis is not None:
            # row-parallel: each shard's part of dx, summed; dW stays local
            dx = all_reduce_(dx, group=axis.group).to(x.dtype)
        return dx, dw.to(weight.dtype), None, None, None, None, None


def fused_linear_cross_entropy(x: torch.Tensor, weight: torch.Tensor,
                               labels: torch.Tensor, weights: torch.Tensor, *,
                               block_n: int = 512,
                               compute_dtype: torch.dtype = torch.bfloat16,
                               vocab_axis=None) -> torch.Tensor:
    """Weighted softmax-CE SUM of ``x @ weight^T`` against ``labels``.

    ``x [N, E]`` or ``[B, L, E]`` (post-ln_f hidden states); ``weight
    [V, E]`` the LM head's ``nn.Linear`` weight (the transpose of the JAX
    ``[E, V]`` kernel) at its storage dtype, so dW accumulates and returns
    in fp32 for fp32 parameters; ``labels``/``weights`` ``[N]`` or
    ``[B, L]``. ``vocab_axis`` (a ``parallel.mesh.AxisGroup``): the head
    is vocab-parallel, ``weight`` this rank's ``[V/T, E]`` rows of the
    vocabulary (rank i holds ids ``[i·V/T, (i+1)·V/T)``) and ``labels``
    global ids; the ranks' softmax statistics combine and dx is summed
    over the axis, so every rank returns the same loss and the whole dx.
    Returns the scalar fp32 sum, differentiable in x and weight; divide by
    the token count outside."""
    if x.dim() == 3:
        x = x.reshape(-1, x.shape[-1])
    if vocab_axis is not None and vocab_axis.size == 1:
        vocab_axis = None
    return _FusedCE.apply(x, weight, labels.reshape(-1), weights.reshape(-1),
                          min(block_n, max(x.shape[0], 1)), compute_dtype, vocab_axis)
