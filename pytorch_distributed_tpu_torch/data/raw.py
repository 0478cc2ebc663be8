"""Pre-decoded raw image records, the decode-free input path
(``pytorch_distributed_tpu/data/raw.py``).

JPEG decoding costs milliseconds an image on a host core; a raw split
pays it once, at packing: each record is ``label u32 | h u16 | w u16`` and
``h·w·3`` uint8 RGB pixels, the image's shorter side resized to
``image_size`` and center-cropped square. ``RawImageNet`` reads it with
the reference's augmentations:

- ``rrc``: torchvision's RandomResizedCrop and flip semantics on the
  stored image (PIL), not on the original JPEG — the one deviation of
  this path;
- ``crop``: a random ``crop_size`` window and flip, numpy only;
- ``none``: the center ``crop_size`` window (validation).

Samples are uint8, a quarter of float32's bytes to the card; the train
and eval steps normalize on the device (``train.step.prepare_image``).
With ``crop`` and ``none`` a whole batch is read, cropped, flipped and
collated by one call of the C++ core (``collate_batch``), no PIL.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Iterable, Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.data import transforms as T
from pytorch_distributed_tpu_torch.data.native import SizeMismatch
from pytorch_distributed_tpu_torch.data.packed_record import (
    PackedRecordReader,
    PackedRecordWriter,
)
from pytorch_distributed_tpu_torch.resilience.retry import retry_call

_HDR = struct.Struct("<IHH")  # label u32 | height u16 | width u16


def encode_raw_record(image: np.ndarray, label: int) -> bytes:
    """uint8 HWC RGB image and label → one raw record."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected uint8 HWC RGB, got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    return _HDR.pack(int(label), h, w) + image.tobytes()


def decode_raw_record(record: bytes) -> Tuple[np.ndarray, int]:
    label, h, w = _HDR.unpack(record[:_HDR.size])
    arr = np.frombuffer(record, np.uint8, count=h * w * 3, offset=_HDR.size)
    return arr.reshape(h, w, 3), int(label)


def write_imagenet_raw_split(path: str | os.PathLike, samples: Iterable[tuple],
                             image_size: int = 256) -> int:
    """Pack ``(jpeg_bytes | PIL.Image | uint8 array, label)`` pairs as raw
    records: decoded, the shorter side resized to ``image_size``,
    center-cropped square. A uint8 array already ``image_size`` square is
    stored as it is, without PIL; everything else goes through PIL.
    Returns the record count; a crash publishes nothing."""
    resize = T.Resize(image_size)
    crop = T.CenterCrop(image_size)
    n = 0
    with PackedRecordWriter(os.fspath(path)) as w:
        for item, label in samples:
            if isinstance(item, np.ndarray):
                img = item
                if img.shape[:2] != (image_size, image_size):
                    from PIL import Image

                    img = np.asarray(crop(resize(Image.fromarray(img))).convert("RGB"),
                                     np.uint8)
            else:
                from PIL import Image

                pil = item
                if isinstance(pil, (bytes, bytearray, memoryview)):
                    pil = Image.open(io.BytesIO(pil))
                img = np.asarray(crop(resize(pil.convert("RGB"))), np.uint8)
            w.write(encode_raw_record(img, int(label)))
            n += 1
    return n


class _RandomCropFlip:
    """A random ``size`` window and a horizontal flip, numpy on uint8."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        h, w = arr.shape[:2]
        s = self.size
        top = int(rng.integers(0, h - s + 1)) if h > s else 0
        left = int(rng.integers(0, w - s + 1)) if w > s else 0
        out = arr[top:top + s, left:left + s]
        if rng.random() < 0.5:
            out = out[:, ::-1]
        return np.ascontiguousarray(out)


class _RRCFlip:
    """torchvision's RandomResizedCrop and flip on the stored image,
    uint8 out."""

    def __init__(self, size: int):
        self.rrc = T.RandomResizedCrop(size)
        self.flip = T.RandomHorizontalFlip()

    def __call__(self, arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        from PIL import Image

        img = self.flip(self.rrc(Image.fromarray(arr), rng), rng)
        return np.asarray(img.convert("RGB"), np.uint8)


class _EvalCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, arr: np.ndarray, rng=None) -> np.ndarray:
        h, w = arr.shape[:2]
        s = self.size
        top, left = (h - s) // 2, (w - s) // 2
        return np.ascontiguousarray(arr[top:top + s, left:left + s])


class RawImageNet:
    """A raw split, ``<data_dir>/<split>.rawtprc``: ``(image [crop, crop,
    3] uint8, label)`` samples. ``aug``: ``rrc`` (train default),
    ``crop`` or ``none`` (val default)."""

    def __init__(self, split: str = "train", data_dir: str = ".", crop_size: int = 224,
                 aug: Optional[str] = None, use_native: bool | None = None,
                 verify_crc: bool = False):
        self.split = split
        self.path = os.path.join(data_dir, f"{split}.rawtprc")
        if not os.path.exists(self.path):
            raise FileNotFoundError(
                f"raw packed split not found: {self.path} — build it with "
                "pytorch_distributed_tpu_torch.tools.pack_imagenet --raw or "
                "data.raw.write_imagenet_raw_split()")
        self.reader = PackedRecordReader(self.path, use_native=use_native)
        self.verify_crc = verify_crc  # see ImageNet.verify_crc
        self._hw = None  # the stored image size, read from the first record asked for
        self._native_declined = False  # latched on a split of several sizes
        #: batches ``collate_batch`` made in the native core (the checks read it)
        self.native_batches = 0
        if aug is None:
            aug = "rrc" if split == "train" else "none"
        if aug == "rrc":
            self.transform = _RRCFlip(crop_size)
        elif aug == "crop":
            self.transform = _RandomCropFlip(crop_size)
        elif aug == "none":
            self.transform = _EvalCrop(crop_size)
        else:
            raise ValueError(f"unknown aug {aug!r}; known: rrc, crop, none")

    def __len__(self) -> int:
        return len(self.reader)

    def getitem_rng(self, i: int, rng: np.random.Generator):
        arr, label = decode_raw_record(self.reader.read(int(i), self.verify_crc))
        return self.transform(arr, rng), label

    def __getitem__(self, i: int):
        return self.getitem_rng(i, np.random.default_rng())

    def collate_batch(self, indices, make_rng):
        """The whole batch in one call of the C++ core (``tpr_crop_batch``):
        read, crop, flip and collate, threaded, outside the GIL.

        ``make_rng(i)`` is the per-sample augmentation rng, drawn in the
        order ``_RandomCropFlip`` draws, so the batch is bit-equal to the
        per-sample path's. Returns None, and the loader takes the
        per-sample path, where this path does not apply: no native reader,
        ``rrc`` (PIL), a per-read CRC asked for (the C++ crop does not
        check it), a stored image smaller than the crop, or a split whose
        records differ in size (latched: the core checks every header)."""
        nat = self.reader._native
        if (nat is None or self._native_declined or self.verify_crc
                or not isinstance(self.transform, (_RandomCropFlip, _EvalCrop))):
            return None
        s = self.transform.size
        if self._hw is None:
            arr, _ = decode_raw_record(self.reader.read(int(indices[0]), False))
            self._hw = arr.shape[:2]
        h, w = self._hw
        if h < s or w < s:
            return None
        n = len(indices)
        if isinstance(self.transform, _RandomCropFlip):
            tops, lefts, flips = [], [], []
            for i in indices:
                rng = make_rng(i)
                tops.append(int(rng.integers(0, h - s + 1)) if h > s else 0)
                lefts.append(int(rng.integers(0, w - s + 1)) if w > s else 0)
                flips.append(bool(rng.random() < 0.5))
        else:
            tops, lefts, flips = [(h - s) // 2] * n, [(w - s) // 2] * n, [False] * n
        try:
            # a transient pread failure is retried; a size mismatch is
            # structural and goes to the per-sample path unretried
            images, labels = retry_call(nat.crop_batch, indices, tops, lefts, flips, s, h, w,
                                        no_retry_on=(SizeMismatch,), what="raw batch crop")
        except SizeMismatch:
            self._native_declined = True
            return None
        self.native_batches += 1
        return {"image": images, "label": labels}

    def loader(self, batch_size: int, sampler=None, num_workers: int = 4,
               drop_last: bool = True, prefetch: int = 2, **_compat):
        from pytorch_distributed_tpu_torch.data.loader import DataLoader

        return DataLoader(self, batch_size, sampler=sampler, num_workers=num_workers,
                          drop_last=drop_last, prefetch=prefetch)
