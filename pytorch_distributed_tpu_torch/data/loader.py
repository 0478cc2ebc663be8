"""A minimal single-process batch loader for the trainers.

The JAX package's ``data/loader.py`` pulls in its ``resilience`` package,
whose ``__init__`` imports JAX, so it is not reused. This one keeps what
the trainers need: batches in sampler order, seekable by batch,
collated by ``collate_fn`` (``train.lm_trainer.lm_collate``,
``data.synthetic.image_collate``), with
``drop_last``, as pinned host tensors when ``pin_memory`` is set;
``to_device`` copies them without blocking. Worker threads, prefetch and
retries come with a later slice.

Data parallelism: the JAX trainers sample by node and batch the node's
replicas together (``train/trainer.py``:169-205); each local replica then
takes contiguous rows of the node batch (``shard_batch``:143 lays it over
the local devices). ``DataLoader(part=(i, n))`` is such a node batch of
``batch_size`` rows of which local replica ``i`` of ``n`` collates only
its own, ``rank_rows``; a partial last batch is wrap-padded to a multiple
of ``n`` with ``wrap_partial`` (the JAX ``validate``'s ``np.resize``, its
duplicates counted), else each replica takes what is left of its rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data.sampler import DistributedSampler


def rank_rows(n_rows: int, batch_size: int, part: Tuple[int, int],
              wrap_partial: bool = False) -> np.ndarray:
    """Positions in a node batch of ``n_rows`` (of ``batch_size`` when
    full) that local replica ``part[0]`` of ``part[1]`` takes: rows
    ``[i·k, (i+1)·k)`` with ``k = batch_size / n``. ``wrap_partial`` first
    repeats a partial batch's rows cyclically to a multiple of ``n`` and
    splits that evenly (``np.resize``); otherwise a replica takes what
    exists of its rows, perhaps none."""
    i, n = part
    rows = np.arange(n_rows)
    if wrap_partial and n_rows < batch_size:
        rows = np.resize(rows, n_rows + (-n_rows) % n)
        k = len(rows) // n
    else:
        k = batch_size // n
    return rows[i * k:(i + 1) * k]


class DataLoader:
    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 sampler: Optional[DistributedSampler] = None,
                 drop_last: bool = True, pin_memory: bool = False,
                 part: Tuple[int, int] = (0, 1), wrap_partial: bool = False):
        if batch_size % part[1]:
            raise ValueError(f"a node batch of {batch_size} does not split over "
                             f"{part[1]} replicas")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.sampler = sampler or DistributedSampler(len(dataset), shuffle=False)
        self.drop_last = drop_last
        self.pin_memory = pin_memory
        self.part = part
        self.wrap_partial = wrap_partial

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def iter_rows(self, start_batch: int = 0) -> Iterator[np.ndarray]:
        """For each node batch of the current epoch from ``start_batch`` on,
        the positions in the sampler's epoch (``sampler.local_indices()``)
        of the rows this replica takes (``rank_rows``)."""
        first = start_batch * self.batch_size
        usable = len(self.sampler) - first
        if self.drop_last:
            usable -= usable % self.batch_size
        for lo in range(0, max(usable, 0), self.batch_size):
            n = min(self.batch_size, usable - lo)
            yield first + lo + rank_rows(n, self.batch_size, self.part, self.wrap_partial)

    def collate(self, indices) -> Dict[str, torch.Tensor]:
        """The samples of dataset ``indices``, collated into host tensors."""
        batch = self.collate_fn([self.dataset[int(i)] for i in indices])
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self.pin_memory:
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def iter_batches(self, start_batch: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """This replica's batches of the current epoch from batch
        ``start_batch`` on."""
        indices = self.sampler.local_indices()
        for rows in self.iter_rows(start_batch):
            yield self.collate(indices[rows])

    def __iter__(self):
        return self.iter_batches(0)


def to_device(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """Each tensor on ``device``; from pinned memory the copies do not
    block the host."""
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}
