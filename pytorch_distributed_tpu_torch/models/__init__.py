from pytorch_distributed_tpu_torch.models.convert import (
    init_params,
    paged_cache_from_jax,
    paged_cache_to_jax,
    params_from_jax,
    params_to_jax,
)
from pytorch_distributed_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    tiny_config,
)

__all__ = ["TransformerConfig", "TransformerLM", "tiny_config", "init_params",
           "params_from_jax", "params_to_jax", "paged_cache_from_jax",
           "paged_cache_to_jax"]
