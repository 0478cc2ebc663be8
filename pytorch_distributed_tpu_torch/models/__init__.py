from pytorch_distributed_tpu_torch.models.convert import (
    init_params,
    init_resnet_params,
    paged_cache_from_jax,
    paged_cache_to_jax,
    params_from_jax,
    params_to_jax,
    resnet_params_from_jax,
    resnet_params_to_jax,
    scaler_from_jax,
)
from pytorch_distributed_tpu_torch.models.generate import generate
from pytorch_distributed_tpu_torch.models.resnet import (
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
)
from pytorch_distributed_tpu_torch.models.transformer import (
    TransformerConfig,
    TransformerLM,
    tiny_config,
)

__all__ = ["ResNet", "TransformerConfig", "TransformerLM", "generate", "tiny_config",
           "init_params", "init_resnet_params", "params_from_jax", "params_to_jax",
           "paged_cache_from_jax", "paged_cache_to_jax", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet_params_from_jax", "resnet_params_to_jax", "scaler_from_jax"]
