"""Rank-aware printing (``pytorch_distributed_tpu/utils/logging.py``).

The reference prints on rank 0 only and flushes every print
(``restnet_ddp.py:66-70,145-146``); the rank is the port's
``parallel.distributed`` rank (0 without a process group). The port's
modules log warnings through ``logging.getLogger(
"pytorch_distributed_tpu_torch")``; the JAX module's ``get_logger``,
which gives that logger a stdout handler, has no caller here.
"""

from __future__ import annotations

from pytorch_distributed_tpu_torch.parallel.distributed import is_primary


def is_rank0() -> bool:
    return is_primary()


def rank0_print(*args, **kwargs) -> None:
    """``print(..., flush=True)`` on rank 0 only (ref ``restnet_ddp.py:70``)."""
    if is_rank0():
        kwargs.setdefault("flush", True)
        print(*args, **kwargs)
