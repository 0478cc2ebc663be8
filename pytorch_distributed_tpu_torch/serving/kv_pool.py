"""Block-pooled KV cache: the allocator and the pools
(``pytorch_distributed_tpu/serving/kv_pool.py``).

Every resident request's KV lives in fixed-size blocks drawn from one
shared pool ``[n_blocks, block_len, H_kv, D]`` per layer; a request's
logical positions ``[w·block_len, (w+1)·block_len)`` live in the block
its table row names at column ``w``. Admission allocates fresh blocks and
writes only the new prompt's KV.

Block 0 is the TRASH block: never allocated, it takes the writes of
inactive decode lanes, so a recycled block is never hit by a dead lane.
Reads through trash entries are masked: their logical positions lie past
every live query position.

Allocation is host-side and deterministic: a LIFO free list, refcounted
blocks, and ``None`` on insufficient capacity so the scheduler queues the
request (OOM → queue). Prefix sharing, host offload, swap states and
quantized pools come with later slices.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

TRASH_BLOCK = 0


def blocks_needed(prompt_len: int, max_new_tokens: int, block_len: int,
                  chunk: int) -> int:
    """Blocks a request must own before admission: enough for the
    chunk-padded prefill writes (the final chunk's padding lands in owned
    blocks, dead until decode overwrites it) and for the decode frontier
    ``prompt_len + max_new_tokens``."""
    padded_end = math.ceil(prompt_len / chunk) * chunk
    return math.ceil(max(padded_end, prompt_len + max_new_tokens) / block_len)


class BlockAllocator:
    """Free-list allocator over pool blocks ``1 .. n_blocks-1`` (0 is the
    trash block), with one chain per owner (a slot id) and a refcount per
    block.

    ``alloc`` is all-or-nothing: the chain, or ``None`` with nothing
    changed. ``free`` decrefs the owner's chain; blocks that reach zero
    return to the free list LIFO, so the next allocation reuses the most
    recently freed blocks. A decref of a dead block is a double free and
    raises."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (block 0 is the trash block), got {n_blocks}")
        self.n_blocks = n_blocks
        # LIFO: pop from the end, so the first allocations hand out 1, 2, 3...
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._chains: Dict[int, List[int]] = {}
        self._refs: Dict[int, int] = {}  # live block -> refcount

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def owners(self) -> List[int]:
        return list(self._chains)

    def ref(self, block: int) -> int:
        """The block's live refcount (0 = free)."""
        return self._refs.get(block, 0)

    def alloc(self, owner: int, n: int) -> Optional[List[int]]:
        """``n`` fresh blocks for ``owner``, or ``None`` (state unchanged)
        when fewer than ``n`` are free."""
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if owner in self._chains:
            raise ValueError(f"owner {owner} already holds a chain")
        if len(self._free) < n:
            return None  # deterministic OOM: the caller queues
        chain = [self._free.pop() for _ in range(n)]
        for b in chain:
            self._refs[b] = 1
        self._chains[owner] = chain
        return list(chain)

    def incref(self, block: int) -> None:
        if block not in self._refs:
            raise ValueError(f"incref of dead block {block}")
        self._refs[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; at zero the block returns to the free list
        (True)."""
        n = self._refs.get(block)
        if n is None:
            raise RuntimeError(f"double free: block {block} has no live references")
        if n == 1:
            del self._refs[block]
            self._free.append(block)
            return True
        self._refs[block] = n - 1
        return False

    def free(self, owner: int) -> None:
        """Decref ``owner``'s chain (a no-op for an owner without one)."""
        chain = self._chains.pop(owner, None)
        if chain:
            for b in reversed(chain):
                self.decref(b)


def init_paged_cache(config, n_blocks: int, block_len: int,
                     kv_dtype: Optional[str] = None,
                     device: torch.device | str = "cpu"):
    """Zero pools for ``TransformerLM(config)``: one ``(key, value)`` pair
    per layer, each ``[n_blocks, block_len, H_kv, D]`` in ``config.dtype``."""
    if block_len < 1:
        raise ValueError(f"block_len must be >= 1, got {block_len}")
    if kv_dtype is not None:
        raise NotImplementedError(
            f"kv_dtype={kv_dtype!r}: quantized KV pools (int8/fp8, with the "
            "quantize-on-scatter kernel) come with the port's second serving "
            "slice")
    shape = (n_blocks, block_len, config.num_heads, config.head_dim)
    return [
        (torch.zeros(shape, dtype=config.dtype, device=device),
         torch.zeros(shape, dtype=config.dtype, device=device))
        for _ in range(config.num_layers)
    ]
