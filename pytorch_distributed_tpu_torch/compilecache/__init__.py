"""Cold-start elimination for the serve: the program registry and the
warmup runtime (``pytorch_distributed_tpu/compilecache``). A serve
enumerates every program it will need (``registry``) and captures them
as CUDA graphs ahead of traffic in priority order (``warmup``), so the
first request into each bucket pays no capture. The persistent XLA
cache (``aot.py``) and the trainers' registry have no counterpart yet.
"""

from pytorch_distributed_tpu_torch.compilecache.registry import (
    CoverageError,
    ProgramRegistry,
    ProgramSpec,
    run_fingerprint,
    serving_registry,
)
from pytorch_distributed_tpu_torch.compilecache.warmup import WarmupRunner

__all__ = [
    "CoverageError",
    "ProgramRegistry",
    "ProgramSpec",
    "WarmupRunner",
    "run_fingerprint",
    "serving_registry",
]
