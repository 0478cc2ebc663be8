"""Fused (chunked) linear + softmax cross-entropy
(``pytorch_distributed_tpu/ops/fused_ce.py``).

The weighted CE sum of ``x @ W^T`` without the fp32 ``[N, V]`` logits ever
existing: the rows go through in blocks of ``block_n``; each block's
logits are reduced at once to per-row ``lse`` and label logit ``z``. The
backward recomputes each block's logits and feeds ``softmax − onehot``
straight into the dx and dW products, so its peak is one block too. The
JAX version is a ``lax.scan`` with a custom vjp and no Pallas kernel; this
is a ``torch.autograd.Function`` in plain PyTorch. Its ``vocab_axis``
(vocab-parallel heads) is not ported.

Operands are rounded to the compute dtype and the products accumulate and
come out in fp32 (``_matmul_f32``). A bf16 value is exact in TF32, so on
the card the product of the rounded operands runs as an fp32 matmul with
TF32 allowed: the bf16 product with fp32 accumulation, not bf16 logits.
"""

from __future__ import annotations

import contextlib

import torch


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
    def forward(ctx, x, weight, labels, weights, block_n: int, cdt: torch.dtype):
        n = x.shape[0]
        w_t = _rounded(weight, cdt).t()
        lse = torch.empty(n, dtype=torch.float32, device=x.device)
        z = torch.empty(n, dtype=torch.float32, device=x.device)
        for lo in range(0, n, block_n):
            logits = _matmul_f32(_rounded(x[lo:lo + block_n], cdt), w_t, cdt)
            lse[lo:lo + block_n] = torch.logsumexp(logits, dim=-1)
            z[lo:lo + block_n] = logits.gather(
                1, labels[lo:lo + block_n].long()[:, None])[:, 0]
        ctx.save_for_backward(x, weight, labels, weights, lse)
        ctx.args = (block_n, cdt)
        return ((lse - z) * weights.float()).sum()

    @staticmethod
    def backward(ctx, g):
        x, weight, labels, weights, lse = ctx.saved_tensors
        block_n, cdt = ctx.args
        n = x.shape[0]
        w = _rounded(weight, cdt)
        dx = torch.empty_like(x)
        dw = torch.zeros(weight.shape, dtype=torch.float32, device=weight.device)
        scale = weights.float() * g
        for lo in range(0, n, block_n):
            x_i = _rounded(x[lo:lo + block_n], cdt)
            p = torch.exp(_matmul_f32(x_i, w.t(), cdt) - lse[lo:lo + block_n, None])
            p[torch.arange(p.shape[0], device=p.device),
              labels[lo:lo + block_n].long()] -= 1.0  # softmax - onehot
            dl = _rounded(p * scale[lo:lo + block_n, None], cdt)
            dx[lo:lo + block_n] = _matmul_f32(dl, w, cdt).to(x.dtype)
            dw += _matmul_f32(dl.t(), x_i, cdt)
        return dx, dw.to(weight.dtype), None, None, None, None


def fused_linear_cross_entropy(x: torch.Tensor, weight: torch.Tensor,
                               labels: torch.Tensor, weights: torch.Tensor, *,
                               block_n: int = 512,
                               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Weighted softmax-CE SUM of ``x @ weight^T`` against ``labels``.

    ``x [N, E]`` or ``[B, L, E]`` (post-ln_f hidden states); ``weight
    [V, E]`` the LM head's ``nn.Linear`` weight (the transpose of the JAX
    ``[E, V]`` kernel) at its storage dtype, so dW accumulates and returns
    in fp32 for fp32 parameters; ``labels``/``weights`` ``[N]`` or
    ``[B, L]``. Returns the scalar fp32 sum, differentiable in x and
    weight; divide by the token count outside."""
    if x.dim() == 3:
        x = x.reshape(-1, x.shape[-1])
    return _FusedCE.apply(x, weight, labels.reshape(-1), weights.reshape(-1),
                          min(block_n, max(x.shape[0], 1)), compute_dtype)
