from pytorch_distributed_tpu_torch.telemetry.export import prometheus_text
from pytorch_distributed_tpu_torch.telemetry.latency import LatencySeries, percentiles

__all__ = ["LatencySeries", "percentiles", "prometheus_text"]
