"""Host-side image transforms, NHWC (``pytorch_distributed_tpu/data/
transforms.py``): the same sampling and the same PIL calls, so the same
rng gives the same pixels in both packages.

They stand in for the reference's torchvision pipelines (train:
RandomResizedCrop(224) + RandomHorizontalFlip + ToTensor + Normalize;
val: Resize(256) + CenterCrop(224) + ToTensor + Normalize,
``restnet_ddp.py:101-116``). ``ToArray`` gives float32 HWC in [0, 1];
``Normalize`` uses the reference's channel statistics. PIL is imported
only by a transform that runs, so a process that never decodes or
resizes (the raw split's ``crop`` and ``none`` paths) needs no PIL.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _pil():
    from PIL import Image

    return Image


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x, rng: np.random.Generator | None = None):
        rng = rng if rng is not None else np.random.default_rng()
        for t in self.transforms:
            x = t(x, rng)
        return x


def _to_pil(x):
    if isinstance(x, _pil().Image):
        return x
    raise TypeError(f"expected PIL image, got {type(x)}")


class RandomResizedCrop:
    """torchvision's RandomResizedCrop: area in [0.08, 1.0], aspect in
    [3/4, 4/3], 10 tries, then a center crop at the clamped aspect."""

    def __init__(self, size: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
        self.size = size
        self.scale = scale
        self.ratio = ratio

    def _sample_box(self, width, height, rng):
        area = width * height
        log_ratio = (math.log(self.ratio[0]), math.log(self.ratio[1]))
        for _ in range(10):
            target_area = area * rng.uniform(*self.scale)
            aspect = math.exp(rng.uniform(*log_ratio))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if 0 < w <= width and 0 < h <= height:
                i = rng.integers(0, height - h + 1)
                j = rng.integers(0, width - w + 1)
                return int(i), int(j), h, w
        in_ratio = width / height
        if in_ratio < self.ratio[0]:
            w = width
            h = int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            h = height
            w = int(round(h * self.ratio[1]))
        else:
            w, h = width, height
        return (height - h) // 2, (width - w) // 2, h, w

    def __call__(self, img, rng: np.random.Generator):
        img = _to_pil(img)
        i, j, h, w = self._sample_box(img.width, img.height, rng)
        return img.resize((self.size, self.size), _pil().BILINEAR, box=(j, i, j + w, i + h))


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, rng: np.random.Generator):
        img = _to_pil(img)
        if rng.random() < self.p:
            return img.transpose(_pil().FLIP_LEFT_RIGHT)
        return img


class Resize:
    """The short side to ``size``, keeping the aspect (torchvision's int
    argument)."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, rng=None):
        img = _to_pil(img)
        w, h = img.width, img.height
        if w <= h:
            new_w, new_h = self.size, max(int(round(h * self.size / w)), 1)
        else:
            new_h, new_w = self.size, max(int(round(w * self.size / h)), 1)
        return img.resize((new_w, new_h), _pil().BILINEAR)


class CenterCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img, rng=None):
        img = _to_pil(img)
        left = (img.width - self.size) // 2
        top = (img.height - self.size) // 2
        return img.crop((left, top, left + self.size, top + self.size))


class ToArray:
    """PIL → float32 HWC in [0, 1] (torchvision's ToTensor without the CHW
    transpose: the models take NHWC)."""

    def __call__(self, img, rng=None):
        return np.asarray(_to_pil(img).convert("RGB"), np.float32) / 255.0


class Normalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, arr, rng=None):
        return (arr - self.mean) / self.std


def train_transform(size: int = 224, normalize: bool = True) -> Compose:
    """The reference's train pipeline (``restnet_ddp.py:101-106``)."""
    ts = [RandomResizedCrop(size), RandomHorizontalFlip(), ToArray()]
    if normalize:
        ts.append(Normalize())
    return Compose(ts)


def eval_transform(size: int = 224, resize: int = 256, normalize: bool = True) -> Compose:
    """The reference's val pipeline (``restnet_ddp.py:111-116``)."""
    ts = [Resize(resize), CenterCrop(size), ToArray()]
    if normalize:
        ts.append(Normalize())
    return Compose(ts)
