"""Attention over the paged KV cache: the plain version
(``ops.attention``) and the CUDA kernels' wrappers (``ops.paged_flash``)."""
