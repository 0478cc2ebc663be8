from pytorch_distributed_tpu_torch.data.loader import DataLoader, to_device
from pytorch_distributed_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_tpu_torch.data.synthetic import (
    SyntheticImageClassification,
    image_collate,
)
from pytorch_distributed_tpu_torch.data.tokens import SyntheticTokens, TokenArrayDataset

__all__ = ["DataLoader", "DistributedSampler", "SyntheticImageClassification",
           "SyntheticTokens", "TokenArrayDataset", "image_collate", "to_device"]
