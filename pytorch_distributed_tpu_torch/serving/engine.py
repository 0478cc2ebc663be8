"""The paged serving engine: chunked prefill and decode over one
block-pooled KV cache (``pytorch_distributed_tpu/serving/engine.py``).

- **chunk prefill** (``run_chunks``): one forward prefills one
  fixed-length chunk for each of up to ``k`` requests. Each job carries
  its start position and its slice of the block table, so the cost
  follows the prompt bucket, never the pool size. The job count pads to a
  power of two (padding jobs go to slot ``n_slots`` and are dropped) and
  the table slice to the narrowest power-of-two block count covering every
  chunk's end, so shapes come from a small fixed set.
- **decode** (``decode``): one token for every slot, sampled from the
  logits buffer. Inactive lanes' writes go to the trash block through
  host-masked tables, so a recycled block is never written by a dead lane.

The JAX engine donates the pool and the logits buffer to its programs;
here the model writes the pools in place and the engine copies new
logits rows into its buffer in place, so neither is ever copied whole.

The engine owns the pools, the logits buffer, the allocator and the
tables; the caller (``serving.scheduler.Scheduler``) decides what to
admit and when to decode.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.models.generate import (
    _sample,
    _validate_sampling,
    _validate_serving_config,
)
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.serving.kv_pool import (
    TRASH_BLOCK,
    BlockAllocator,
    blocks_needed,
    init_paged_cache,
)


def _pow2_bucket(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class ChunkJob(NamedTuple):
    """One prompt chunk to prefill: ``tokens`` is the chunk (zero-padded to
    the engine's chunk length), ``start`` its absolute position,
    ``last_idx`` the in-chunk index of the prompt's last real token
    (meaningful only when ``is_last``)."""

    slot: int
    tokens: np.ndarray  # [chunk] int32
    start: int
    is_last: bool
    last_idx: int


class PagedEngine:
    """Model, pools, logits buffer, allocator and block tables for paged
    continuous batching.

    ``params`` is a state dict of ``models.transformer.TransformerLM``
    (``models.convert.params_from_jax`` makes one from flax weights).
    ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` to run on the CPU. ``gather_impl`` replaces the
    config's read path: ``"kernel"`` (the CUDA kernels) or ``"dense"``
    (the plain PyTorch version, a switch for comparisons)."""

    def __init__(self, config, params, n_slots: int, *,
                 n_blocks: Optional[int] = None, block_len: int = 16,
                 prefill_chunk: int = 128, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 gather_impl: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 split_s: Optional[int] = None, device=None):
        _validate_serving_config(config)
        _validate_sampling(config, temperature, top_k)
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if gather_impl is not None and gather_impl != config.gather_impl:
            config = dataclasses.replace(config, gather_impl=gather_impl)
        if split_s is not None and split_s != config.split_s:
            config = dataclasses.replace(config, split_s=split_s)
        self.device = resolve_device(device)
        self.config = config
        self.n_slots = n_slots
        self.block_len = block_len
        self.chunk = prefill_chunk
        self.temperature = temperature
        self.top_k = top_k
        # per-slot table width: enough blocks for a max_seq_len request
        self.table_width = -(-config.max_seq_len // block_len)
        if n_blocks is None:
            # every slot can hold max_seq_len, plus the trash block
            n_blocks = n_slots * self.table_width + 1
        self.allocator = BlockAllocator(n_blocks)
        self.tables = np.full((n_slots, self.table_width), TRASH_BLOCK, np.int32)
        self.cache = init_paged_cache(config, n_blocks, block_len,
                                      kv_dtype=kv_dtype, device=self.device)
        self.logits = torch.zeros((n_slots, config.vocab_size),
                                  dtype=torch.float32, device=self.device)
        with torch.device(self.device):
            model = TransformerLM(config)
        model.load_state_dict(params)
        self.model = model.eval().requires_grad_(False)

    def _to_device(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    # ---- slot-level operations ----

    def blocks_for(self, prompt_len: int, max_new_tokens: int) -> int:
        return blocks_needed(prompt_len, max_new_tokens, self.block_len, self.chunk)

    def admit(self, slot: int, prompt_len: int, max_new_tokens: int) -> bool:
        """Allocate ``slot``'s chain and write its table row. False (state
        unchanged) when the pool cannot serve it: the OOM the scheduler
        queues on."""
        need = self.blocks_for(prompt_len, max_new_tokens)
        if need > self.table_width:
            raise ValueError(
                f"request needs {need} blocks > table width {self.table_width} "
                f"(max_seq_len {self.config.max_seq_len} / block_len "
                f"{self.block_len})")
        chain = self.allocator.alloc(slot, need)
        if chain is None:
            return False
        self.tables[slot] = TRASH_BLOCK
        self.tables[slot, :need] = chain
        return True

    def release(self, slot: int) -> None:
        """Free the slot's chain and point its row at the trash block."""
        self.allocator.free(slot)
        self.tables[slot] = TRASH_BLOCK

    def release_all(self) -> None:
        for owner in self.allocator.owners():
            self.allocator.free(owner)
        self.tables[:] = TRASH_BLOCK

    # ---- chunked prefill ----

    def bucket_for(self, jobs: List[ChunkJob]) -> Tuple[int, int]:
        """The (padded job count, table-slice width) ``run_chunks`` uses."""
        k_pad = _pow2_bucket(len(jobs))
        max_end = max(j.start + self.chunk for j in jobs)
        wp = min(_pow2_bucket(-(-max_end // self.block_len)), self.table_width)
        return k_pad, wp

    def run_chunks(self, jobs: List[ChunkJob]) -> None:
        """Prefill one chunk for each job in one forward. Chunks of one
        prompt go in order (chunk n+1 reads chunk n's KV from the pool).
        A job's final chunk writes the logits row of its prompt's last
        token: the distribution of the first decoded token."""
        if not jobs:
            return
        c = self.chunk
        for j in jobs:
            if len(j.tokens) != c:
                raise ValueError(
                    f"chunk job for slot {j.slot} has {len(j.tokens)} tokens; "
                    f"engine chunk length is {c}")
        k_pad, wp = self.bucket_for(jobs)
        tokens = np.zeros((k_pad, c), np.int64)
        starts = np.zeros((k_pad,), np.int64)
        tables = np.full((k_pad, wp), TRASH_BLOCK, np.int32)
        slots = np.full((k_pad,), self.n_slots, np.int64)  # padding: dropped
        is_last = np.zeros((k_pad,), bool)
        last_idx = np.zeros((k_pad,), np.int64)
        for i, j in enumerate(jobs):
            tokens[i] = j.tokens
            starts[i] = j.start
            tables[i] = self.tables[j.slot, :wp]
            slots[i] = j.slot
            is_last[i] = j.is_last
            last_idx[i] = j.last_idx
        with torch.no_grad():
            rows = self.model(
                self._to_device(tokens, torch.long),
                self._to_device(starts, torch.long),
                self._to_device(tables, torch.int32),
                self.cache,
                logits_index=self._to_device(last_idx, torch.long),
            )[:, 0]
            keep = np.nonzero(is_last & (slots < self.n_slots))[0]
            if keep.size:
                self.logits[self._to_device(slots[keep], torch.long)] = (
                    rows[self._to_device(keep, torch.long)])

    # ---- decode ----

    def decode_launch(self, positions: np.ndarray, active: np.ndarray,
                      generator: Optional[torch.Generator] = None):
        """Enqueue one decode tick for every slot without waiting for it:
        returns ``(device_tokens [n_slots], new_positions)``. Inactive
        lanes read and write through trash-only table rows at position 0
        and keep their positions."""
        positions = np.asarray(positions, np.int64)
        active = np.asarray(active, bool)
        masked = np.where(active[:, None], self.tables, TRASH_BLOCK)
        with torch.no_grad():
            tokens = _sample(self.logits, self.temperature, self.top_k, generator)
            out = self.model(
                tokens[:, None].long(),
                self._to_device(np.where(active, positions, 0), torch.long),
                self._to_device(masked, torch.int32),
                self.cache,
            )
            self.logits.copy_(out[:, 0])
        return tokens, np.where(active, positions + 1, positions)

    def decode_collect(self, tokens: torch.Tensor,
                       positions: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a ``decode_launch`` and bring its tokens to the host."""
        return tokens.cpu().numpy(), positions

    def decode(self, positions: np.ndarray, active: np.ndarray,
               generator: Optional[torch.Generator] = None):
        """One decode tick: ``(tokens [n_slots], new_positions)`` on the
        host."""
        return self.decode_collect(*self.decode_launch(positions, active,
                                                       generator))
