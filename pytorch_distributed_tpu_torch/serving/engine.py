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
- **quantized pools** (``kv_dtype``): int8 or fp8 pools with their scales
  (``serving.kv_pool``); the model quantizes as it scatters.
- **prefix sharing** (``prefix_cache=True``, ``admit_shared``): an
  admission takes the indexed blocks of its longest full-block prefix by
  reference and prefills only the rest; a full-cover hit copies the
  boundary block first (copy-on-write).
- **swap** (``swap_out_begin``/``swap_out_finish``, ``swap_in_chain``): a
  chain moves to host RAM through pinned buffers and back.

The JAX engine donates the pool and the logits buffer to its programs;
here the model writes the pools in place and the engine copies new
logits rows into its buffer in place, so neither is ever copied whole.

The engine owns the pools, the logits buffer, the allocator and the
tables; the caller (``serving.scheduler.Scheduler``) decides what to
admit and when to decode.
"""

from __future__ import annotations

import dataclasses
import time
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
    KV_DTYPES,
    SWAPPING_IN,
    SWAPPING_OUT,
    TRASH_BLOCK,
    BlockAllocator,
    HostBlockStore,
    HostChain,
    LayerCache,
    PrefixIndex,
    blocks_needed,
    blocks_needed_suffix,
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


class PendingSwap(NamedTuple):
    """A swap-out in flight (``swap_out_begin``): the chain's blocks and
    the slot's logits row being copied into host buffers, and the CUDA
    event recorded after the copies (None on the CPU, where they are
    done). Until ``swap_out_finish`` the chain stays allocated and
    ``swapping-out``."""

    slot: int
    chain_len: int
    blocks: List[LayerCache]  # host tensors [chain_len, block_len, ...]
    logits_row: torch.Tensor  # host [vocab_size]
    event: Optional[torch.cuda.Event]


class PrefixHit(NamedTuple):
    """One prefix-sharing admission (``PagedEngine.admit_shared``):
    ``covered`` tokens ride existing blocks (prefill starts there),
    ``shared`` chain blocks are increfed index blocks, and ``cow`` marks
    the full-cover hit whose boundary block was copied."""

    covered: int
    shared: int
    cow: bool


class PagedEngine:
    """Model, pools, logits buffer, allocator and block tables for paged
    continuous batching.

    ``params`` is a state dict of ``models.transformer.TransformerLM``
    (``models.convert.params_from_jax`` makes one from flax weights).
    ``device`` defaults to CUDA and raises without a card; pass
    ``device="cpu"`` to run on the CPU. ``gather_impl`` replaces the
    config's read path: ``"kernel"`` (the CUDA kernels) or ``"dense"``
    (the plain PyTorch version, a switch for comparisons). ``kv_dtype``
    picks the pool dtype (``serving.kv_pool.KV_DTYPES``);
    ``prefix_cache`` arms the prefix index."""

    def __init__(self, config, params, n_slots: int, *,
                 n_blocks: Optional[int] = None, block_len: int = 16,
                 prefill_chunk: int = 128, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 gather_impl: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False,
                 split_s: Optional[int] = None, device=None):
        _validate_serving_config(config)
        _validate_sampling(config, temperature, top_k)
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} must be one of {KV_DTYPES}")
        if gather_impl is not None and gather_impl != config.gather_impl:
            config = dataclasses.replace(config, gather_impl=gather_impl)
        if split_s is not None and split_s != config.split_s:
            config = dataclasses.replace(config, split_s=split_s)
        self.device = resolve_device(device)
        self.config = config
        self.kv_dtype = kv_dtype
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
        self.prefix_cache = bool(prefix_cache)
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(block_len, self.allocator) if prefix_cache else None)
        self._cow_copies = 0
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

    def _check_width(self, need: int) -> None:
        if need > self.table_width:
            raise ValueError(
                f"request needs {need} blocks > table width {self.table_width} "
                f"(max_seq_len {self.config.max_seq_len} / block_len "
                f"{self.block_len})")

    def _alloc_evict(self, owner: int, shared: List[int], n_new: int,
                     keep: List[int] = ()) -> Optional[List[int]]:
        """``alloc_mixed``, with the prefix index as the first valve: on
        OOM, evict enough index-only blocks for the shortfall and retry
        once. Only when the index has nothing left to give does the OOM
        reach the caller (queue, then preemption). ``keep``: index blocks
        this admission is about to share or copy, which eviction must
        spare (the JAX engine can evict them and then fail to share a dead
        block)."""
        chain = self.allocator.alloc_mixed(owner, shared, n_new)
        if chain is None and self.prefix is not None:
            short = n_new - self.allocator.available
            if short > 0 and self.prefix.evict(short, keep=keep) > 0:
                chain = self.allocator.alloc_mixed(owner, shared, n_new)
        return chain

    def _set_row(self, slot: int, chain: List[int]) -> None:
        self.tables[slot] = TRASH_BLOCK
        self.tables[slot, :len(chain)] = chain

    def admit(self, slot: int, prompt_len: int, max_new_tokens: int) -> bool:
        """Allocate ``slot``'s chain and write its table row. False (state
        unchanged) when the pool cannot serve it: the OOM the scheduler
        queues on."""
        need = self.blocks_for(prompt_len, max_new_tokens)
        self._check_width(need)
        chain = self._alloc_evict(slot, [], need)
        if chain is None:
            return False
        self._set_row(slot, chain)
        return True

    def _require_prefix(self) -> None:
        if self.prefix is None:
            raise RuntimeError("this engine was built without prefix_cache=True")

    def admit_shared(self, slot: int, tokens,
                     max_new_tokens: int) -> Optional[PrefixHit]:
        """Admit through the prefix index: the longest full-block match of
        ``tokens`` rides shared blocks, only the rest is allocated, and
        prefill starts at ``covered``. Streams stay token-identical to an
        engine without sharing because:

        - at least one prompt token is always prefilled again, so the last
          chunk writes the slot's logits row as a cold prefill would. On a
          full-cover match that token lies inside the last matched block:
          the block is first copied into a fresh block this chain owns
          (copy-on-write, every pool tensor and scale), then position
          ``L-1`` is written again with the same values;
        - ``covered`` is cut back until the chunk-padded tail fits
          ``max_seq_len``, the bound a cold admission's padding obeys.

        Returns the ``PrefixHit`` (``covered == 0`` on a miss), or None on
        pool OOM with nothing increfed."""
        self._require_prefix()
        prompt_len = len(tokens)
        self._check_width(self.blocks_for(prompt_len, max_new_tokens))
        bl, c = self.block_len, self.chunk
        matched = self.prefix.lookup(tokens)
        covered = len(matched) * bl
        cow = False
        if covered >= prompt_len:
            covered = prompt_len - 1
            cow = covered % bl != 0
        while covered > 0 and (covered + -(-(prompt_len - covered) // c) * c
                               > self.config.max_seq_len):
            covered = (covered - 1) // bl * bl
            cow = False
        if covered <= 0:
            covered, cow = 0, False
        n_shared = covered // bl
        need = blocks_needed_suffix(covered, prompt_len, max_new_tokens, bl, c)
        chain = self._alloc_evict(slot, matched[:n_shared], need - n_shared,
                                  keep=matched[:n_shared + cow])
        if chain is None:
            return None
        self._set_row(slot, chain)
        if cow:
            self._copy_block(matched[n_shared], chain[n_shared])
            self._cow_copies += 1
        return PrefixHit(covered=covered, shared=n_shared, cow=cow)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy pool block ``src`` onto ``dst`` in every pool tensor of
        every layer, scales included, in place."""
        for layer in self.cache:
            for t in layer:
                if t is not None:
                    t[dst] = t[src]

    def prefix_insert(self, slot: int, tokens, upto: int) -> int:
        """Index ``slot``'s full blocks covering ``tokens[:upto]``; returns
        the number newly indexed."""
        self._require_prefix()
        return self.prefix.insert(tokens, self.allocator.chain(slot), upto)

    def prefix_metrics(self) -> dict:
        """Sharing counters for ``Scheduler.metrics()``."""
        out = {
            "prefix_cache": self.prefix_cache,
            "prefix_cow_copies": self._cow_copies,
            "prefix_shared_blocks": self.allocator.shared_blocks,
            "blocks_fresh_allocated": self.allocator.fresh_allocated,
            "blocks_shared_reused": self.allocator.shared_reused,
        }
        if self.prefix is not None:
            out.update(self.prefix.metrics())
        else:
            out.update(prefix_index_blocks=0, prefix_lookups=0, prefix_hits=0,
                       prefix_hit_rate=0.0, prefix_inserts=0, prefix_evictions=0)
        return out

    def release(self, slot: int) -> None:
        """Free the slot's chain and point its row at the trash block."""
        self.allocator.free(slot)
        self.tables[slot] = TRASH_BLOCK

    def release_all(self) -> None:
        """Free every chain, then drop the prefix index's references (in
        that order, so a block both hold is decrefed once by each)."""
        for owner in self.allocator.owners():
            self.allocator.free(owner)
        if self.prefix is not None:
            self.prefix.clear()
        self.tables[:] = TRASH_BLOCK

    # ---- swap to host RAM and back ----

    def chain_bytes(self, n_blocks: int) -> int:
        """Bytes ``n_blocks`` pool blocks hold across every pool tensor
        (scales included) plus one logits row: what a swap moves."""
        per_block = sum(t[0].numel() * t.element_size()
                        for layer in self.cache for t in layer if t is not None)
        return n_blocks * per_block + self.logits[0].numel() * self.logits.element_size()

    def _host_empty(self, like: torch.Tensor, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=like.dtype, device="cpu",
                           pin_memory=self.device.type == "cuda")

    def swap_out_begin(self, slot: int) -> PendingSwap:
        """Start moving ``slot``'s chain to host RAM: gather its blocks
        (every pool tensor) and the slot's logits row into pinned host
        buffers with asynchronous copies, and record an event after them.
        The chain stays allocated and ``swapping-out``: nothing is freed
        until ``swap_out_finish`` commits, so a failure leaves the stream
        resident."""
        chain = self.allocator.chain(slot)
        if not chain:
            raise ValueError(f"slot {slot} holds no block chain to swap")
        self.allocator.set_state(slot, SWAPPING_OUT)
        try:
            idx = torch.tensor(chain, dtype=torch.long).to(self.device)
            blocks = []
            for layer in self.cache:
                host = []
                for t in layer:
                    if t is None:
                        host.append(None)
                        continue
                    h = self._host_empty(t, (len(chain),) + tuple(t.shape[1:]))
                    h.copy_(t[idx], non_blocking=True)
                    host.append(h)
                blocks.append(LayerCache(*host))
            row = self._host_empty(self.logits, self.logits.shape[1:])
            row.copy_(self.logits[slot], non_blocking=True)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        except BaseException:
            self.allocator.clear_state(slot)
            raise
        return PendingSwap(slot, len(chain), blocks, row, event)

    def swap_out_finish(self, pending: PendingSwap, store: HostBlockStore,
                        rid: int) -> HostChain:
        """Wait for the copies, commit the chain to ``store`` under ``rid``,
        then free the device chain. A failure before the commit (a full
        store raises ``OSError``) closes the window with the chain still
        resident."""
        slot = pending.slot
        try:
            if pending.event is not None:
                pending.event.synchronize()
            nbytes = pending.logits_row.numel() * pending.logits_row.element_size() + sum(
                t.numel() * t.element_size()
                for layer in pending.blocks for t in layer if t is not None)
            chain = HostChain(blocks=pending.blocks, logits_row=pending.logits_row,
                              n_blocks=pending.chain_len, block_len=self.block_len,
                              nbytes=nbytes)
            if not store.put(rid, chain):
                raise OSError(f"host store rejected rid {rid}'s chain "
                              f"({nbytes} bytes over budget)")
        finally:
            self.allocator.clear_state(slot)
        self.release(slot)
        return chain

    def swap_in_chain(self, slot: int, chain: HostChain) -> bool:
        """Restore a host chain into ``slot``: allocate fresh blocks, copy
        the chain and its logits row from host RAM, scatter them in place
        and write the table row. False (state unchanged) when the pool
        cannot supply the blocks: the caller keeps the host copy and
        retries."""
        if chain.block_len != self.block_len:
            raise ValueError(f"cannot swap block_len={chain.block_len} blocks into "
                             f"a block_len={self.block_len} pool")
        ids = self._alloc_evict(slot, [], chain.n_blocks)
        if ids is None:
            return False
        self.allocator.set_state(slot, SWAPPING_IN)
        try:
            idx = torch.tensor(ids, dtype=torch.long).to(self.device)
            for layer, host in zip(self.cache, chain.blocks):
                for t, h in zip(layer, host):
                    if t is not None:
                        t[idx] = h.to(self.device, non_blocking=True)
            self.logits[slot] = chain.logits_row.to(self.device, non_blocking=True)
        except BaseException:
            self.allocator.clear_state(slot)
            self.allocator.free(slot)
            raise
        self.allocator.clear_state(slot)
        self._set_row(slot, ids)
        return True

    # ---- chunked prefill ----

    def bucket_for(self, jobs: List[ChunkJob]) -> Tuple[int, int]:
        """The (padded job count, table-slice width) ``run_chunks`` uses."""
        k_pad = _pow2_bucket(len(jobs))
        max_end = max(j.start + self.chunk for j in jobs)
        wp = min(_pow2_bucket(-(-max_end // self.block_len)), self.table_width)
        return k_pad, wp

    def run_chunks(self, jobs: List[ChunkJob]) -> float:
        """Prefill one chunk for each job in one forward. Chunks of one
        prompt go in order (chunk n+1 reads chunk n's KV from the pool).
        A job's final chunk writes the logits row of its prompt's last
        token: the distribution of the first decoded token. Returns the
        host wall of the call (it does not wait for the card)."""
        if not jobs:
            return 0.0
        t0 = time.perf_counter()
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
        return time.perf_counter() - t0

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
