"""Per-replica index sharding with ``torch.utils.data.DistributedSampler``
semantics and a seekable start (``pytorch_distributed_tpu/data/sampler.py``):
the same index sequences as the JAX package's for the same arguments.

The index list pads to a multiple of ``num_replicas`` by repeating from
the front (or truncates with ``drop_last``), replica ``rank`` takes
``indices[rank::num_replicas]``, and ``set_epoch`` reseeds the shuffle
with ``seed + epoch`` (numpy's generator, not torch's bitstream).
"""

from __future__ import annotations

import numpy as np


class DistributedSampler:
    def __init__(self, dataset_size: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last and dataset_size % num_replicas:
            self.num_samples = dataset_size // num_replicas
        else:
            self.num_samples = -(-dataset_size // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _global_indices(self) -> np.ndarray:
        if self.shuffle:
            indices = np.random.default_rng(self.seed + self.epoch).permutation(
                self.dataset_size)
        else:
            indices = np.arange(self.dataset_size)
        if self.drop_last:
            return indices[:self.total_size]
        if self.total_size > len(indices):
            pad = self.total_size - len(indices)
            reps = -(-pad // max(len(indices), 1))
            indices = np.concatenate([indices] + [indices] * reps)[:self.total_size]
        return indices

    def local_indices(self) -> np.ndarray:
        """This replica's shard, ``indices[rank::num_replicas]``."""
        return self._global_indices()[self.rank::self.num_replicas]

    def local_padding_mask(self) -> np.ndarray:
        """Bool ``[num_samples]``: True where this replica's position holds
        a wrap-padding duplicate (``local_padding_mask``:88), so metric
        code can zero its weight."""
        return np.arange(self.rank, self.total_size, self.num_replicas) >= self.dataset_size

    def __iter__(self):
        return iter(self.local_indices().tolist())

    def __len__(self) -> int:
        return self.num_samples

    def iter_from(self, start_index: int):
        """The shard from its ``start_index``-th sample, reading nothing
        before it."""
        return iter(self.local_indices()[start_index:].tolist())
