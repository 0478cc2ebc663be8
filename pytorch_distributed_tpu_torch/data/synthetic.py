"""Synthetic image classification (``pytorch_distributed_tpu/data/synthetic.py``).

Samples are drawn on demand from the index with the JAX package's seeds,
so ``dataset[i]`` is the same array in both packages: labels cycle through
the classes, and each image is unit-normal noise shifted by a
class-dependent mean, so a model can learn it.
"""

from __future__ import annotations

import numpy as np


class SyntheticImageClassification:
    """``dataset[i]`` → ``(image [H, W, 3] float32, label int)``."""

    def __init__(self, size: int = 1024, image_size: int = 224, num_classes: int = 1000,
                 seed: int = 0):
        self.size = size
        self.image_size = image_size
        self.num_classes = num_classes
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, i: int):
        if not 0 <= i < self.size:
            raise IndexError(i)
        label = i % self.num_classes
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        img = rng.normal(0.0, 1.0, (self.image_size, self.image_size, 3))
        img += (label / max(self.num_classes - 1, 1)) - 0.5
        return img.astype(np.float32), label


def image_collate(samples) -> dict:
    """``(image, label)`` samples → ``{"image": [B, H, W, 3], "label": [B]
    int32}``; float images collate to float32, uint8 ones stay uint8 (the
    train step normalizes those on the device)."""
    images = np.stack([s[0] for s in samples])
    if images.dtype != np.uint8:
        images = images.astype(np.float32)
    return {"image": images, "label": np.asarray([s[1] for s in samples], np.int32)}
