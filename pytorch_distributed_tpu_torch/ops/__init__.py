"""Ops of the port: attention over the paged KV cache (``ops.attention``,
the CUDA wrappers in ``ops.paged_flash``), FlashAttention
(``ops.flash_attention``) and ring attention over it (``ops.ring_flash``),
the bottleneck tail's reductions (``ops.bottleneck_tail``), the losses,
metrics, optimizers, schedules and precision policy of the trainers."""
