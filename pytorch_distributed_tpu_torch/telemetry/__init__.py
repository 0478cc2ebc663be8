from pytorch_distributed_tpu_torch.telemetry.latency import LatencySeries, percentiles

__all__ = ["LatencySeries", "percentiles"]
