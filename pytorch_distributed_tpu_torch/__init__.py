"""PyTorch and CUDA port of ``pytorch_distributed_tpu``, for an NVIDIA H100.

Slice 1 is paged LM serving: ``serving.Scheduler`` → ``serving.PagedEngine``
→ ``models.TransformerLM`` in paged mode, whose attention runs the
hand-written CUDA kernels of ``csrc/paged_attention.cu`` through
``ops.paged_flash``. The package imports torch and numpy only, never JAX
or the JAX package. Entry points run on CUDA unless ``device="cpu"`` is
passed.
"""

from pytorch_distributed_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
