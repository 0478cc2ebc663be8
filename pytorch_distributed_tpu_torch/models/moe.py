"""Mixture-of-Experts MLP (``pytorch_distributed_tpu/models/moe.py``), one
card (``ep_size == 1``; expert parallelism is not ported).

Routing is the JAX package's ``topk_dispatch`` exactly: a router in fp32
without bias, softmax probabilities, the top ``k`` experts of each token
(ties to the lower expert index, as ``lax.top_k``), capacity ``C =
max(ceil(cf · k · T / E), 1)`` filled in choice-rank order (every first
choice before any second one, tokens in arrival order within a rank),
assignments past capacity dropped; gates the chosen probability for k = 1
and the chosen probabilities renormalised to sum 1 for k > 1. The aux loss
is ``E · Σ_e (first-choice fraction) · (mean probability)``, pre-weighted
by ``aux_loss_weight``; ``dropped_frac`` is the share of tokens with no
surviving route (their output is the residual alone).

Where the JAX module multiplies one-hot ``[T, E, C]`` dispatch and combine
tensors (2.7 GB a layer at 8 × 2048 tokens, 8 experts, top-2), this one
spells the same routing with index tensors: each (token, rank) gets its
expert and its slot ``expert · C + position`` (``topk_routes``), the expert
buffers ``[E, C, D]`` are the token rows copied to their slots
(``index_copy``), and the output is each token's gated sum of its slots'
rows (``index_select``). Every
shape is static, so a decode tick still captures into one CUDA graph. The
experts are tanh-GELU MLPs without biases, ``w_up [E, D, F]`` and ``w_down
[E, F, D]`` in the flax layout, cast to the compute dtype at use.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn


class Routes(NamedTuple):
    """One layer's routing of ``T`` tokens to ``E`` experts of capacity
    ``C``, top ``k``: ``expert [T, k]`` (int64), ``slot [T, k]`` (``expert
    · C + position``, or ``E · C`` where the assignment was dropped),
    ``keep [T, k]`` (bool), ``gates [T, k]`` (fp32, 0 where dropped),
    ``aux`` (the unweighted load-balancing loss) and ``dropped_frac``."""

    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gates: torch.Tensor
    aux: torch.Tensor
    dropped_frac: torch.Tensor


def capacity_of(capacity_factor: float, top_k: int, tokens: int, n_experts: int) -> int:
    """Slots an expert holds: ``max(ceil(cf · k · T / E), 1)``."""
    return max(math.ceil(capacity_factor * top_k * tokens / n_experts), 1)


def stable_top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the ``k`` largest of each row, descending, a tie to
    the lower index (``torch.topk`` orders ties arbitrarily). ``k``
    rounds of ``argmax``, which returns the first maximum."""
    vals, idx = [], []
    p = probs
    for _ in range(k):
        i = torch.argmax(p, dim=-1)
        vals.append(torch.gather(probs, -1, i[:, None])[:, 0])
        idx.append(i)
        p = p.scatter(-1, i[:, None], float("-inf"))
    return torch.stack(vals, -1), torch.stack(idx, -1)


def expert_masks(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``[n, T]`` int64: row e marks the tokens whose ``idx`` is e. A
    comparison, not ``F.one_hot`` (which checks its range on the host,
    where a CUDA graph capture cannot wait); laid out experts-major so that
    the arrival-order scan runs along the contiguous token axis."""
    return (idx[None, :] == torch.arange(n, device=idx.device)[:, None]).long()


def topk_routes(router_logits: torch.Tensor, capacity: int, k: int = 1) -> Routes:
    """The routing of ``topk_dispatch`` (module docstring) as index
    tensors, from ``router_logits [T, E]`` (cast to fp32)."""
    t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    topv, topi = stable_top_k(probs, k)
    gates = topv if k == 1 else topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    counts = torch.zeros(e, dtype=torch.long, device=probs.device)
    pos, keep = [], []
    for r in range(k):
        mask = expert_masks(topi[:, r], e)  # [E, T]
        # a token's place in its expert's buffer: earlier ranks' tokens
        # first (counts), then arrival order
        p_r = ((torch.cumsum(mask, 1) - 1 + counts[:, None]) * mask).sum(0)
        k_r = p_r < capacity
        counts = counts + (mask * k_r[None, :]).sum(1)
        pos.append(p_r)
        keep.append(k_r)
    pos, keep = torch.stack(pos, -1), torch.stack(keep, -1)
    slot = torch.where(keep, topi * capacity + pos, torch.full_like(pos, e * capacity))
    first = expert_masks(topi[:, 0], e).float()
    aux = e * torch.sum(first.mean(1) * probs.mean(0))
    dropped = (~keep.any(-1)).float().mean()
    return Routes(topi, slot, keep, gates * keep, aux, dropped)


class MoEMLP(nn.Module):
    """The MoE replacement of a block's MLP. ``forward(x [B, L, D])`` →
    ``[B, L, D]`` in ``dtype``; after each call ``aux_loss`` holds the
    pre-weighted aux loss and ``dropped_frac`` the layer's drop share (the
    JAX module's sowed ``aux_loss`` and ``moe_stats``), both fp32 scalars
    of that call. ``capacity_factor`` may be replaced for a while
    (``relaxed_capacity``)."""

    def __init__(self, n_experts: int, embed_dim: int, mlp_dim: int, *,
                 capacity_factor: float = 1.25, aux_loss_weight: float = 0.01,
                 top_k: int = 1, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor, self.aux_loss_weight = capacity_factor, aux_loss_weight
        self.dtype = dtype
        # the router computes in fp32 on fp32 weights (the flax Dense's
        # dtype and param dtype), whatever the experts' dtype
        self.router = nn.Linear(embed_dim, n_experts, bias=False, dtype=torch.float32)
        self.w_up = nn.Parameter(torch.empty(n_experts, embed_dim, mlp_dim, dtype=param_dtype))
        self.w_down = nn.Parameter(torch.empty(n_experts, mlp_dim, embed_dim, dtype=param_dtype))
        self.aux_loss = None
        self.dropped_frac = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        t, e = b * l, self.n_experts
        x_flat = x.reshape(t, d)
        cap = capacity_of(self.capacity_factor, self.top_k, t, e)
        routes = topk_routes(self.router(x_flat.float()), cap, self.top_k)
        self.aux_loss = self.aux_loss_weight * routes.aux
        self.dropped_frac = routes.dropped_frac
        dt = self.dtype
        k = self.top_k
        slots = routes.slot.reshape(-1)  # [T·k]; a dropped one is slot E·C
        # dispatch: each (token, rank) row copied to its slot, an empty slot
        # zero; slot E·C collects the dropped rows and is cut off. Its
        # backward gathers, and the combine's gather adds back at most one
        # (token, rank) a kept slot, so neither sums duplicates in an
        # arbitrary order (advanced indexing's backward sorted the thousands
        # of duplicates and took 15 ms a layer at 8 x 2048 tokens)
        rows = x_flat.to(dt)[:, None].expand(t, k, d).reshape(t * k, d)
        xe = x_flat.new_zeros((e * cap + 1, d), dtype=dt).index_copy(0, slots, rows)
        h = F.gelu(torch.bmm(xe[:-1].view(e, cap, d), self.w_up.to(dt)), approximate="tanh")
        ye = torch.bmm(h, self.w_down.to(dt)).reshape(e * cap, d)
        ye = torch.cat([ye, ye.new_zeros((1, d))])  # the dropped slot reads zeros
        # combine: the gates rounded to the compute dtype, as JAX casts the
        # combine tensor; the k terms summed in fp32
        g = routes.gates.to(dt).float()
        out = (ye.index_select(0, slots).view(t, k, d).float() * g[..., None]).sum(1)
        return out.to(dt).reshape(b, l, d)


def moe_layers(model: nn.Module) -> Iterator[MoEMLP]:
    return (m for m in model.modules() if isinstance(m, MoEMLP))


def eval_capacity_factor(config) -> float:
    """The capacity factor MoE evaluation runs at (the JAX
    ``make_lm_eval_step``): 4 × the training one, at most ``n_experts``,
    so padding rows cannot displace real tokens' routes."""
    return min(4.0 * config.capacity_factor, float(config.n_experts))


@contextlib.contextmanager
def relaxed_capacity(model: nn.Module, capacity_factor: float):
    """Every MoE layer of ``model`` at ``capacity_factor`` inside the
    block, at its own after it."""
    layers = list(moe_layers(model))
    saved = [m.capacity_factor for m in layers]
    for m in layers:
        m.capacity_factor = capacity_factor
    try:
        yield
    finally:
        for m, cf in zip(layers, saved):
            m.capacity_factor = cf
