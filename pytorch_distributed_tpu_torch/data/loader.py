"""A minimal single-process batch loader for the trainers.

The JAX package's ``data/loader.py`` pulls in its ``resilience`` package,
whose ``__init__`` imports JAX, so it is not reused. This one keeps what
the trainers need: batches in sampler order, seekable by batch,
collated by ``collate_fn`` (``train.lm_trainer.lm_collate``,
``data.synthetic.image_collate``), with
``drop_last``, as pinned host tensors when ``pin_memory`` is set;
``to_device`` copies them without blocking. Worker threads, prefetch and
retries come with a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data.sampler import DistributedSampler


class DataLoader:
    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 sampler: Optional[DistributedSampler] = None,
                 drop_last: bool = True, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = sampler or DistributedSampler(len(dataset), shuffle=False)
        self.drop_last = drop_last
        self.pin_memory = pin_memory

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def iter_batches(self, start_batch: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """The current epoch's batches from batch ``start_batch`` on."""
        indices = np.fromiter(self.sampler.iter_from(start_batch * self.batch_size),
                              np.int64)
        usable = len(indices)
        if self.drop_last:
            usable -= usable % self.batch_size
        for lo in range(0, usable, self.batch_size):
            batch = self.collate_fn([self.dataset[int(i)]
                                     for i in indices[lo:lo + self.batch_size]])
            out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
            if self.pin_memory:
                out = {k: v.pin_memory() for k, v in out.items()}
            yield out

    def __iter__(self):
        return self.iter_batches(0)


def to_device(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """Each tensor on ``device``; from pinned memory the copies do not
    block the host."""
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}
