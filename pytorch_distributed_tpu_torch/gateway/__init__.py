"""HTTP/SSE front door over the serving fleet (``pytorch_distributed_tpu/gateway``):
``server.Gateway`` mounts ``POST /v1/generate`` (SSE token streaming),
``GET /v1/health`` and ``GET /metrics`` over a ``fleet.FleetRouter``;
``client`` is the stdlib client that drives it."""

from pytorch_distributed_tpu_torch.gateway.client import (
    GatewayError,
    SSEStream,
    generate,
    health,
    metrics_text,
    open_stream,
)
from pytorch_distributed_tpu_torch.gateway.server import Gateway

__all__ = ["Gateway", "GatewayError", "SSEStream", "generate", "health", "metrics_text",
           "open_stream"]
