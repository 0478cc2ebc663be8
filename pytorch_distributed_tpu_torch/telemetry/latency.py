"""Exact host-side latency series with percentile summaries
(``pytorch_distributed_tpu/telemetry/latency.py``): TTFT, inter-token
gaps, queue wait and tick wall, in seconds."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def percentiles(values: Sequence[float],
                qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
    """``{"p50": ..., "p95": ...}`` by numpy's linear interpolation; an
    empty input gives an empty dict."""
    vals = np.asarray(list(values), dtype=np.float64)
    if vals.size == 0:
        return {}
    return {f"p{q:g}": float(np.percentile(vals, q)) for q in qs}


class LatencySeries:
    """Seconds, windowed: ``count``, mean and max are cumulative;
    percentiles cover the last ``window`` observations (the buffer holds
    at most ``2 * window``)."""

    def __init__(self, name: str = "", window: int = 4096):
        self.name = name
        self.window = int(window)
        self.values: List[float] = []
        self.count = 0
        self._sum = 0.0
        self._max = 0.0

    def observe(self, seconds: float) -> None:
        s = float(seconds)
        self.values.append(s)
        self.count += 1
        self._sum += s
        self._max = max(self._max, s)
        if len(self.values) >= 2 * self.window:
            del self.values[: len(self.values) - self.window]

    def summary(self, prefix: str = "") -> dict:
        """``{prefix_count, prefix_mean_s, prefix_max_s, prefix_p50_s,
        prefix_p95_s, prefix_p99_s}`` (counts only for an empty series)."""
        p = f"{prefix}_" if prefix else ""
        out = {f"{p}count": self.count}
        if not self.values:
            return out
        out[f"{p}mean_s"] = self._sum / self.count
        out[f"{p}max_s"] = self._max
        for q, v in percentiles(self.values[-self.window:]).items():
            out[f"{p}{q}_s"] = v
        return out
