"""ImageNet over TPRC packed records (``pytorch_distributed_tpu/data/
imagenet.py``).

Stands in for ``hfai.datasets.ImageNet(split, transform)`` and its
``.loader(...)`` (``restnet_ddp.py:107-109,117-119``). One TPRC file a
split, ``<data_dir>/{train,val}.tprc``, whose records are ``u32 label ||
JPEG bytes``; ``write_imagenet_split`` packs any ``(bytes, label)``
iterator (``tools/pack_imagenet.py`` walks an ImageFolder). A sample is
decoded by PIL on the host and comes out float32, normalized by the
transform; the loader's worker threads decode in parallel.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Callable, Iterable, Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.data import transforms as T
from pytorch_distributed_tpu_torch.data.loader import DataLoader
from pytorch_distributed_tpu_torch.data.packed_record import (
    PackedRecordReader,
    PackedRecordWriter,
)

_LABEL = struct.Struct("<I")

DEFAULT_DATA_DIR = os.environ.get("PDT_IMAGENET_DIR",
                                  os.path.expanduser("~/datasets/imagenet-tprc"))


def write_imagenet_split(path: str, samples: Iterable[Tuple[bytes, int]],
                         with_crc: bool = True) -> int:
    """Pack ``(jpeg_bytes, label)`` pairs into one TPRC split file;
    returns the record count."""
    count = 0
    with PackedRecordWriter(path, with_crc=with_crc) as w:
        for jpeg, label in samples:
            w.write(_LABEL.pack(label) + jpeg)
            count += 1
    return count


class ImageNet:
    """A packed JPEG split: ``dataset[i]`` decodes record i into
    ``(image [H, W, 3] float32, label)``, through the reference's train or
    val pipeline by default."""

    def __init__(self, split: str = "train", transform: Optional[Callable] = None,
                 data_dir: str = DEFAULT_DATA_DIR, use_native: bool | None = None,
                 verify_crc: bool = False):
        self.split = split
        self.path = os.path.join(data_dir, f"{split}.tprc")
        if not os.path.exists(self.path):
            raise FileNotFoundError(
                f"packed split not found: {self.path} — build it with "
                "pytorch_distributed_tpu_torch.tools.pack_imagenet or "
                "data.imagenet.write_imagenet_split()")
        self.reader = PackedRecordReader(self.path, use_native=use_native)
        # the per-read CRC costs read bandwidth and the atomic writer cannot
        # publish a torn file, so the hot loop skips it (verify_all sweeps)
        self.verify_crc = verify_crc
        if transform is None:
            transform = T.train_transform() if split == "train" else T.eval_transform()
        self.transform = transform

    def __len__(self) -> int:
        return len(self.reader)

    def _decode(self, record: bytes, rng: np.random.Generator):
        from PIL import Image

        (label,) = _LABEL.unpack(record[:_LABEL.size])
        img = Image.open(io.BytesIO(record[_LABEL.size:])).convert("RGB")
        if self.transform is not None:
            img = self.transform(img, rng)
        return np.asarray(img, np.float32), int(label)

    def getitem_rng(self, i: int, rng: np.random.Generator):
        """Sample ``i`` augmented from ``rng``, which the loader derives
        from (seed, epoch, index): a resumed run sees the same crops."""
        return self._decode(self.reader.read(int(i), self.verify_crc), rng)

    def __getitem__(self, i: int):
        return self.getitem_rng(i, np.random.default_rng())

    def loader(self, batch_size: int, sampler=None, num_workers: int = 4,
               drop_last: bool = True, prefetch: int = 2, **_compat) -> DataLoader:
        """The reference's ``train_dataset.loader(...)`` (``restnet_ddp.py:109``);
        ``pin_memory`` and the like are accepted and ignored."""
        return DataLoader(self, batch_size, sampler=sampler, num_workers=num_workers,
                          drop_last=drop_last, prefetch=prefetch)
