"""PyTorch and CUDA port of ``pytorch_distributed_tpu``, for an NVIDIA H100.

Its paths, each through hand-written CUDA kernels for Hopper:

- paged LM serving with float or int8/fp8 pools, prefix sharing and
  preemption: ``serving.Scheduler`` → ``serving.PagedEngine`` →
  ``models.TransformerLM`` (``csrc/paged_attention.cu``);
- LM training: ``train.LMTrainer`` → ``models.TransformerLM`` with flash
  attention (``csrc/flash_attention.cu``), on one card or on a data × seq
  grid of ranks (``parallel``) with ring attention over the same kernels
  (``ops.ring_flash``, the split backward with ``bwd_impl="split"``);
- single-card ResNet training: ``recipes.resnet_single`` →
  ``train.Trainer`` → ``models.ResNet``, whose fused bottleneck blocks
  reduce through ``csrc/bottleneck_tail.cu``.

The package imports torch and numpy only, never JAX or the JAX package.
Entry points run on CUDA unless ``device="cpu"`` is passed.
"""

from pytorch_distributed_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
