"""Prometheus text exposition of a flat metrics dict
(``pytorch_distributed_tpu/telemetry/export.py`` ``prometheus_text``:36):
what the gateway's ``/metrics`` renders. The JAX package's standalone
``MetricsExporter`` server is not ported."""

from __future__ import annotations


def _sanitize(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return out if not out[:1].isdigit() else f"_{out}"


def prometheus_text(metrics: dict, prefix: str = "pdt") -> str:
    """Flat metrics dict → Prometheus text exposition. Numbers emit as
    gauges (bools as 0/1); non-numeric values, NaN and infinities are
    skipped: the format has no string type."""
    lines = []
    for key in sorted(metrics):
        value = metrics[key]
        if isinstance(value, bool):
            value = int(value)
        if not isinstance(value, (int, float)):
            continue
        if value != value or value in (float("inf"), float("-inf")):
            continue
        name = f"{_sanitize(prefix)}_{_sanitize(key)}"
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"
