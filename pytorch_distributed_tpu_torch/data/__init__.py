from pytorch_distributed_tpu_torch.data.loader import DataLoader, to_device
from pytorch_distributed_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_tpu_torch.data.tokens import SyntheticTokens, TokenArrayDataset

__all__ = ["DataLoader", "DistributedSampler", "SyntheticTokens",
           "TokenArrayDataset", "to_device"]
