"""The batch loader of both trainers (``pytorch_distributed_tpu/data/
loader.py``), with the port's data-parallel rows and pinned host tensors.

As in JAX:

- worker *threads* fetch a batch's samples (PIL decoding and the native
  reader release the GIL); one more thread, the producer, runs ahead of
  the consumer through a bounded queue of ``prefetch`` batches;
- each sample's augmentation rng derives from (loader seed, sampler
  epoch, dataset index) (``_make_rng``), so a resumed or retried fetch
  and every rank reproduce the same crops and flips;
- a dataset with ``collate_batch`` (``data.raw.RawImageNet``) makes the
  whole batch itself, in one native call, when the loader's collate is
  the default ``image_collate``; a custom collate always runs;
- each fetch passes the ``data.fetch`` fault site and is retried, up to
  ``retries`` times, on an ``OSError`` (an injected fault is one);
- ``iter_batches(start_batch)`` seeks by index, reading nothing before.

The port's own: the JAX trainers sample by node and batch the node's
replicas together (``train/trainer.py``:169-205), each local replica then
taking contiguous rows of the node batch (``shard_batch``:143). Here
``DataLoader(part=(i, n))`` is such a node batch of ``batch_size`` rows
of which local replica ``i`` of ``n`` fetches only its own,
``rank_rows``; a partial last batch is wrap-padded to a multiple of ``n``
with ``wrap_partial`` (the JAX ``validate``'s ``np.resize``, its
duplicates counted), else each replica takes what is left of its rows.
Batches are dicts of host tensors, pinned by the producer when
``pin_memory`` is set (PyTorch's caching host allocator keeps a block
until its copies are done); ``to_device`` copies them without blocking.

Iterating is a generator that owns its threads: close it (the trainers
do, in a ``finally``) and the producer is stopped and joined and the
worker pool shut down.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data.sampler import DistributedSampler
from pytorch_distributed_tpu_torch.data.synthetic import image_collate
from pytorch_distributed_tpu_torch.resilience.faults import fault_point
from pytorch_distributed_tpu_torch.resilience.retry import retry_call

#: the names of the loader's threads: the producer, and the workers' prefix
PRODUCER_THREAD = "pdt-loader"
WORKER_THREADS = "pdt-loader-worker"


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
    def __init__(self, dataset, batch_size: int, collate_fn: Callable = image_collate,
                 sampler: Optional[DistributedSampler] = None,
                 drop_last: bool = True, pin_memory: bool = False,
                 part: Tuple[int, int] = (0, 1), wrap_partial: bool = False,
                 num_workers: int = 0, prefetch: int = 2, seed: int = 0, retries: int = 2):
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
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.seed = seed
        self.retries = retries

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

    def _make_rng(self, i: int) -> np.random.Generator:
        """The per-sample augmentation rng, from (seed, epoch, dataset
        index): the one definition both the per-sample and the whole-batch
        path draw from."""
        return np.random.default_rng([self.seed, getattr(self.sampler, "epoch", 0), i])

    def _getitem(self, i: int):
        if hasattr(self.dataset, "getitem_rng"):
            return self.dataset.getitem_rng(i, self._make_rng(i))
        return self.dataset[i]

    def collate(self, indices, pool: Optional[ThreadPoolExecutor] = None
                ) -> Dict[str, torch.Tensor]:
        """The samples of dataset ``indices`` collated into host tensors,
        pinned with ``pin_memory``: by the dataset's ``collate_batch`` where
        it applies, else sample by sample (on ``pool``'s threads if given)
        through ``collate_fn``."""
        ints = [int(i) for i in indices]
        batch = None
        if self.collate_fn is image_collate and hasattr(self.dataset, "collate_batch"):
            batch = self.dataset.collate_batch(ints, self._make_rng)
        if batch is None:
            samples = (list(pool.map(self._getitem, ints)) if pool is not None
                       else [self._getitem(i) for i in ints])
            batch = self.collate_fn(samples)
        out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if self.pin_memory:
            out = {k: v.pin_memory() for k, v in out.items()}
        return out

    def _fetch(self, indices, pool) -> Dict[str, torch.Tensor]:
        # the data.fetch fault site: a raise here stands in for a transient
        # read failure, which _fetch_retried absorbs; the per-sample rng
        # makes the re-fetch bit-equal to the first try
        fault_point("data.fetch")
        return self.collate(indices, pool)

    def _fetch_retried(self, indices, pool) -> Dict[str, torch.Tensor]:
        """``_fetch`` under the bounded backoff: an ``OSError`` re-fetches
        the same batch; anything else propagates at once."""
        return retry_call(self._fetch, indices, pool, retries=self.retries, seed=self.seed,
                          what="batch fetch")

    def iter_batches(self, start_batch: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """This replica's batches of the current epoch from batch
        ``start_batch`` on. Each call owns its worker pool and producer;
        closing the generator stops and joins them."""
        indices = self.sampler.local_indices()
        jobs = (indices[rows] for rows in self.iter_rows(start_batch))
        pool = (ThreadPoolExecutor(self.num_workers, thread_name_prefix=WORKER_THREADS)
                if self.num_workers > 0 else None)
        try:
            if self.prefetch <= 1:
                for idx in jobs:
                    yield self._fetch_retried(idx, pool)
                return
            q: queue.Queue = queue.Queue(maxsize=self.prefetch)
            stop = threading.Event()
            end = object()
            # the producer pins; it takes the consumer's card so that the
            # host allocator works in that card's context
            card = (torch.cuda.current_device()
                    if self.pin_memory and torch.cuda.is_available() else None)

            def producer():
                try:
                    if card is not None:
                        torch.cuda.set_device(card)
                    for idx in jobs:
                        if stop.is_set():
                            return
                        q.put(self._fetch_retried(idx, pool))
                except BaseException as e:  # raised again by the consumer
                    q.put(e)
                    return
                q.put(end)

            t = threading.Thread(target=producer, name=PRODUCER_THREAD, daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is end:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                stop.set()
                # once stop is set the producer puts at most its batch in
                # flight and one sentinel, which the drained queue (room for
                # prefetch >= 2) takes, so the join cannot block on a put
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
                t.join()
        finally:
            if pool is not None:
                # a closed iterator leaves no fetch running against a
                # dataset its caller may close next
                pool.shutdown(wait=True, cancel_futures=True)

    def __iter__(self):
        return self.iter_batches(0)


def to_device(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """Each tensor on ``device``; from pinned memory the copies do not
    block the host."""
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def measure_throughput(loader: DataLoader, epochs: int = 1) -> float:
    """Items a second over whole fresh epochs: each ``iter_batches`` starts
    with an empty queue and its own pool, so no batch made before the
    clock started counts."""
    total = 0
    t0 = time.perf_counter()
    for _ in range(max(epochs, 1)):
        for batch in loader.iter_batches(0):
            total += len(batch["label"])
    dt = time.perf_counter() - t0
    if total == 0:
        raise ValueError("loader produced no batches; nothing to measure")
    return total / dt
