from pytorch_distributed_tpu_torch.data.imagenet import ImageNet
from pytorch_distributed_tpu_torch.data.loader import DataLoader, measure_throughput, to_device
from pytorch_distributed_tpu_torch.data.packed_record import (
    PackedRecordReader,
    PackedRecordWriter,
)
from pytorch_distributed_tpu_torch.data.raw import RawImageNet, write_imagenet_raw_split
from pytorch_distributed_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_tpu_torch.data.synthetic import (
    SyntheticImageClassification,
    image_collate,
)
from pytorch_distributed_tpu_torch.data.tokens import SyntheticTokens, TokenArrayDataset

__all__ = ["DataLoader", "DistributedSampler", "ImageNet", "PackedRecordReader",
           "PackedRecordWriter", "RawImageNet", "SyntheticImageClassification",
           "SyntheticTokens", "TokenArrayDataset", "image_collate", "measure_throughput",
           "to_device", "write_imagenet_raw_split"]
