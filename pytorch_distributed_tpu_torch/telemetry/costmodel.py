"""The swap-vs-recompute decision of the pressure tier
(``pytorch_distributed_tpu/telemetry/costmodel.py:85-196``).

The JAX module's cost cards (XLA cost analysis joined with measured wall)
are not ported; only the host↔device link probe and the decision that
reads it are.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import torch

#: env overrides for the host↔device link (GB/s): they pin the
#: swap-vs-recompute decision, for tests on a machine without a card
LINK_ENV_H2D = "PDT_PEAK_H2D_GBS"
LINK_ENV_D2H = "PDT_PEAK_D2H_GBS"

_link_cache: Optional[Tuple[float, float]] = None


def _probe_link(probe_mb: int, reps: int) -> Tuple[float, float]:
    """Median bytes/s of ``probe_mb`` MiB copies from a pinned host buffer
    to the card and back; ``(0, 0)`` without a card."""
    if not torch.cuda.is_available():
        return 0.0, 0.0
    host = torch.ones(probe_mb << 20, dtype=torch.uint8).pin_memory()
    dev = host.to("cuda")
    back = torch.empty_like(host).pin_memory()

    def med(copy) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            copy()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return host.numel() / max(sorted(times)[len(times) // 2], 1e-9)

    return (med(lambda: dev.copy_(host, non_blocking=True)),
            med(lambda: back.copy_(dev, non_blocking=True)))


def link_bandwidth(probe_mb: int = 4,
                   reps: int = 3) -> Tuple[Optional[float], Optional[float]]:
    """``(h2d_bytes_s, d2h_bytes_s)`` of the host↔card link: the
    ``PDT_PEAK_H2D_GBS``/``PDT_PEAK_D2H_GBS`` overrides first, else one
    measured probe per process (pinned buffer, CUDA copies, median of
    ``reps``), cached. None for a side that could not be measured (no
    card), so the decision falls back to its stated default."""
    global _link_cache
    h2d_env = os.environ.get(LINK_ENV_H2D)
    d2h_env = os.environ.get(LINK_ENV_D2H)
    if h2d_env and d2h_env:
        return float(h2d_env) * 1e9, float(d2h_env) * 1e9
    if _link_cache is None:
        _link_cache = _probe_link(probe_mb, reps)
    h2d = float(h2d_env) * 1e9 if h2d_env else (_link_cache[0] or None)
    d2h = float(d2h_env) * 1e9 if d2h_env else (_link_cache[1] or None)
    return h2d, d2h


@dataclasses.dataclass(frozen=True)
class SwapDecision:
    """One preemption's swap-vs-recompute verdict with the predicted costs
    that made it."""

    choice: str  # "swap" | "recompute"
    swap_s: Optional[float]
    recompute_s: Optional[float]
    bytes_to_move: int
    chunks: int
    reason: str


def swap_vs_recompute(
    bytes_to_move: int,
    *,
    chunks: int = 0,
    chunk_wall_s: Optional[float] = None,
    h2d_bytes_s: Optional[float] = None,
    d2h_bytes_s: Optional[float] = None,
) -> SwapDecision:
    """The measured crossover: swap costs the chain's bytes through the
    link both ways (to host now, back at the restore); recompute costs the
    resume prefill's chunks times the measured wall of one chunk call.
    Link rates default from ``link_bandwidth()``. When one side is
    unmeasured the other wins; when neither is, swap is the default."""
    if h2d_bytes_s is None or d2h_bytes_s is None:
        h2d0, d2h0 = link_bandwidth()
        h2d_bytes_s = h2d_bytes_s if h2d_bytes_s is not None else h2d0
        d2h_bytes_s = d2h_bytes_s if d2h_bytes_s is not None else d2h0
    swap_s = (bytes_to_move * (1.0 / h2d_bytes_s + 1.0 / d2h_bytes_s)
              if h2d_bytes_s and d2h_bytes_s else None)
    recompute_s = (chunks * chunk_wall_s
                   if chunk_wall_s is not None and chunks > 0 else None)
    if swap_s is None and recompute_s is None:
        choice, reason = "swap", "unmeasured-default"
    elif recompute_s is None:
        choice, reason = "swap", "recompute-unmeasured"
    elif swap_s is None:
        choice, reason = "recompute", "link-unmeasured"
    else:
        choice = "swap" if swap_s <= recompute_s else "recompute"
        reason = "measured-crossover"
    return SwapDecision(choice=choice, swap_s=swap_s, recompute_s=recompute_s,
                        bytes_to_move=int(bytes_to_move), chunks=chunks,
                        reason=reason)
