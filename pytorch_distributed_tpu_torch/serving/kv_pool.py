"""Block-pooled KV cache: quantization, the allocator, the pools, the
prefix index and the host tier (``pytorch_distributed_tpu/serving/kv_pool.py``).

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
request (OOM → queue).

- **Quantized pools** (``kv_dtype``): int8 values with one fp32 scale per
  written row and head, or fp8 (e4m3 / e5m2) values with one int8
  power-of-two exponent per row and head. The scales sit beside the pools
  as ``key_scale``/``value_scale`` ``[n_blocks, block_len, H_kv]``, so a
  block id names the same rows in all four tensors and sharing, copying
  and swapping move them together.
- **Prefix sharing**: ``PrefixIndex`` is a radix tree over full prompt
  blocks; admissions that match a prefix take its blocks by reference
  (``BlockAllocator.alloc_mixed``) and prefill only the rest.
- **The host tier**: a preempted chain can leave for host RAM
  (``HostBlockStore``) and come back; while it is in transit the
  allocator refuses to free it (``set_state``/``clear_state``).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, NamedTuple, Optional

import torch

from pytorch_distributed_tpu_torch.models.transformer import LayerCache

TRASH_BLOCK = 0

#: chain swap states (``BlockAllocator.state``); a chain with no entry is
#: resident, the two transit states bracket the copies to and from host RAM
RESIDENT = "resident"
SWAPPING_OUT = "swapping-out"
SWAPPING_IN = "swapping-in"
SWAP_STATES = (SWAPPING_OUT, SWAPPING_IN)

#: pool dtypes ``init_paged_cache`` takes: None keeps the model's dtype;
#: "int8" stores int8 K/V plus fp32 scales per (block, slot, head),
#: 2D/(D+4) the blocks of a bf16 pool in the same bytes; "fp8" (e4m3) and
#: "fp8_e5m2" store fp8 K/V plus int8 exponents, 2D/(D+1)
KV_DTYPES = (None, "int8", "fp8", "fp8_e5m2")
FP8_DTYPES = {"fp8": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}
QUANTIZED_DTYPES = (torch.int8, torch.float8_e4m3fn, torch.float8_e5m2)
INT8_SCALE = 1.0 / 127.0  # rounded to fp32 where it is used, as jnp.float32(1/127)
AMAX_FLOOR = 1e-8
EXPONENT_LIMIT = 126


def kv_pool_dtype(kv_dtype: str) -> torch.dtype:
    """Storage dtype for a non-None ``KV_DTYPES`` name."""
    if kv_dtype == "int8":
        return torch.int8
    if kv_dtype in FP8_DTYPES:
        return FP8_DTYPES[kv_dtype]
    raise ValueError(f"kv_dtype {kv_dtype!r} must be one of {KV_DTYPES} (None "
                     "keeps the model compute dtype)")


def is_quantized_pool(dtype: torch.dtype) -> bool:
    """True iff ``dtype`` is a quantized pool storage dtype (int8 or fp8):
    the layer cache then carries scales and the read path dequantizes."""
    return dtype in QUANTIZED_DTYPES


def pool_scale_dtype(pool_dtype: torch.dtype) -> torch.dtype:
    """The scales' dtype: fp32 multipliers for int8 pools, int8
    power-of-two exponents for fp8 pools."""
    return torch.float32 if pool_dtype == torch.int8 else torch.int8


def pow2(k: torch.Tensor) -> torch.Tensor:
    """``2**k`` in fp32 for integer ``k`` in [-126, 127], built from the
    exponent bits, so exact on every device. (XLA's CPU ``exp2`` is off by
    a few ulps on integers; the JAX package's ``2**e`` multipliers carry
    that error, these do not.)"""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def scale_factors(scales: torch.Tensor) -> torch.Tensor:
    """fp32 dequantization multipliers from a scale tensor: ``2**e`` for
    the int8 exponents of fp8 pools, the fp32 multipliers of int8 pools as
    they are."""
    if scales.dtype == torch.int8:
        return pow2(scales)
    return scales


def quantize_rows(xf: torch.Tensor, pool_dtype: torch.dtype):
    """Row-wise quantization of fp32 ``xf [..., H_kv, D]`` to a pool dtype;
    returns ``(q, scales [..., H_kv])``. The quantize-on-scatter kernel
    (``ops.paged_flash.paged_quantize_scatter``) computes the same bits.

    - int8: ``scale = amax · fp32(1/127)`` (a multiply, as the JAX package
      spells it), ``q = clip(round_half_even(x / scale), ±127)``.
    - fp8: ``e = clip(ceil(log2(amax / fmax)), ±126)``, ``q = x · 2**-e``
      cast to fp8 (round to nearest even; ``x · 2**-e ≤ fmax``), ``e`` as
      int8. ``ceil(log2(amax / fmax))`` is taken exactly from the
      ``frexp`` of amax and fmax (``fmax = 0.875 · 2**k_f`` for both fp8
      formats), where the JAX package divides and calls ``log2``: the two
      agree wherever XLA's ``log2`` is exact enough for the ceiling.

    ``amax`` is the row's max |x|, floored at 1e-8."""
    amax = xf.abs().amax(dim=-1).clamp_min(AMAX_FLOOR)
    if pool_dtype == torch.int8:
        scales = amax * INT8_SCALE
        q = torch.round(xf / scales[..., None]).clamp_(-127, 127)
        return q.to(torch.int8), scales
    e = fp8_exponent(amax, pool_dtype)
    return (xf * pow2(-e)[..., None]).to(pool_dtype), e.to(torch.int8)


def fp8_exponent(amax: torch.Tensor, pool_dtype: torch.dtype) -> torch.Tensor:
    """``e = clip(ceil(log2(amax / fmax)), ±126)`` as int32, exactly: with
    ``amax = m · 2**k`` and ``fmax = m_f · 2**k_f`` (``frexp``, mantissas
    in [0.5, 1), ``m_f = 0.875``), the ratio's ceiling log is
    ``k - k_f + (m > m_f)``."""
    m_f, k_f = math.frexp(torch.finfo(pool_dtype).max)
    mant, k = torch.frexp(amax)
    return (k - k_f + (mant > m_f).to(k.dtype)).clamp_(-EXPONENT_LIMIT, EXPONENT_LIMIT)


def quantize_kv(x: torch.Tensor, pool_dtype: torch.dtype = torch.int8):
    """Per-(token, head) quantization of a K or V chunk ``[..., H_kv, D]``
    in any float dtype: ``quantize_rows`` on its fp32 values."""
    return quantize_rows(x.float(), pool_dtype)


def blocks_needed(prompt_len: int, max_new_tokens: int, block_len: int,
                  chunk: int) -> int:
    """Blocks a request must own before admission: enough for the
    chunk-padded prefill writes (the final chunk's padding lands in owned
    blocks, dead until decode overwrites it) and for the decode frontier
    ``prompt_len + max_new_tokens``."""
    return blocks_needed_suffix(0, prompt_len, max_new_tokens, block_len, chunk)


def blocks_needed_suffix(covered: int, prompt_len: int, max_new_tokens: int,
                         block_len: int, chunk: int) -> int:
    """``blocks_needed`` for a prefix hit: prefill starts at ``covered``,
    so the chunk padding runs from there. Counts the whole chain, shared
    blocks included."""
    padded_end = covered + math.ceil((prompt_len - covered) / chunk) * chunk
    return math.ceil(max(padded_end, prompt_len + max_new_tokens) / block_len)


class BlockAllocator:
    """Free-list allocator over pool blocks ``1 .. n_blocks-1`` (0 is the
    trash block), with one chain per owner (a slot id) and a refcount per
    block.

    ``alloc``/``alloc_mixed`` are all-or-nothing: the chain, or ``None``
    with nothing changed. ``alloc_mixed`` starts the chain with blocks
    that are already live (a prefix hit; each gains a reference). ``free``
    decrefs the owner's chain; blocks that reach zero return to the free
    list LIFO, so the next allocation reuses the most recently freed
    blocks. A decref of a dead block is a double free and raises, and a
    chain with an open swap window cannot be freed."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks must be >= 2 (block 0 is the trash block), got {n_blocks}")
        self.n_blocks = n_blocks
        # LIFO: pop from the end, so the first allocations hand out 1, 2, 3...
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._chains: Dict[int, List[int]] = {}
        self._refs: Dict[int, int] = {}  # live block -> refcount
        self._states: Dict[int, str] = {}  # owner -> open swap state
        self.fresh_allocated = 0
        self.shared_reused = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    def owners(self) -> List[int]:
        return list(self._chains)

    def chain(self, owner: int) -> List[int]:
        return list(self._chains.get(owner, ()))

    def ref(self, block: int) -> int:
        """The block's live refcount (0 = free)."""
        return self._refs.get(block, 0)

    @property
    def shared_blocks(self) -> int:
        """Blocks referenced more than once (by chains or the index)."""
        return sum(1 for n in self._refs.values() if n > 1)

    # ---- swap states ----

    def state(self, owner: int) -> str:
        return self._states.get(owner, RESIDENT)

    def set_state(self, owner: int, state: str) -> None:
        """Open a swap window on ``owner``'s live chain."""
        if state not in SWAP_STATES:
            raise ValueError(f"state {state!r} must be one of {SWAP_STATES} "
                             "(clear_state returns a chain to resident)")
        if owner not in self._chains:
            raise ValueError(f"owner {owner} holds no chain to mark {state}")
        self._states[owner] = state

    def clear_state(self, owner: int) -> None:
        """Close the swap window (back to resident). Idempotent."""
        self._states.pop(owner, None)

    def swapping(self) -> List[int]:
        """Owners with an open swap window."""
        return sorted(self._states)

    # ---- allocation ----

    def alloc(self, owner: int, n: int) -> Optional[List[int]]:
        """``n`` fresh blocks for ``owner``, or ``None`` (state unchanged)
        when fewer than ``n`` are free."""
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        return self.alloc_mixed(owner, [], n)

    def alloc_mixed(self, owner: int, shared: List[int],
                    n_new: int) -> Optional[List[int]]:
        """``owner``'s chain: the live ``shared`` blocks (each increfed)
        followed by ``n_new`` fresh ones; ``None`` with nothing increfed
        when the free list cannot supply them. Sharing a dead block
        raises."""
        if n_new < 0 or (n_new == 0 and not shared):
            raise ValueError(f"alloc_mixed needs shared blocks or n_new >= 1, "
                             f"got shared={len(shared)} n_new={n_new}")
        if owner in self._chains:
            raise ValueError(f"owner {owner} already holds a chain")
        if len(self._free) < n_new:
            return None  # deterministic OOM: the caller queues
        for b in shared:
            if b not in self._refs:
                raise ValueError(f"cannot share block {b}: not live (evicted or "
                                 "never allocated)")
        for b in shared:
            self._refs[b] += 1
        fresh = [self._free.pop() for _ in range(n_new)]
        for b in fresh:
            self._refs[b] = 1
        self.fresh_allocated += n_new
        self.shared_reused += len(shared)
        chain = list(shared) + fresh
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
        """Decref ``owner``'s chain (a no-op for an owner without one).
        Refuses a chain in transit: the copy in flight still reads or
        writes its blocks. A block another holder references survives."""
        state = self._states.get(owner)
        if state is not None:
            raise RuntimeError(f"owner {owner}'s chain is {state}: finish or "
                               "abort the swap before freeing it")
        chain = self._chains.pop(owner, None)
        if chain:
            for b in reversed(chain):
                self.decref(b)


def init_paged_cache(config, n_blocks: int, block_len: int,
                     kv_dtype: Optional[str] = None,
                     device: torch.device | str = "cpu") -> List[LayerCache]:
    """Zero pools for ``TransformerLM(config)``: one ``LayerCache`` per
    layer, key and value ``[n_blocks, block_len, H_kv, D]`` in
    ``config.dtype``, or in the ``kv_dtype`` storage dtype with scales
    ``[n_blocks, block_len, H_kv]`` (fp32 for int8, int8 exponents for
    fp8). Under tensor parallelism (``config.tp_size`` T) H_kv is a
    rank's ``kv_heads // T`` heads, the JAX ``paged_cache_specs`` split of
    the head dim (the scales' last): a rank's pool is 1/T of the
    replicated pool's bytes."""
    if block_len < 1:
        raise ValueError(f"block_len must be >= 1, got {block_len}")
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} must be one of {KV_DTYPES}")
    shape = (n_blocks, block_len, config.kv_heads // config.tp_size, config.head_dim)
    if kv_dtype is None:
        return [LayerCache(torch.zeros(shape, dtype=config.dtype, device=device),
                           torch.zeros(shape, dtype=config.dtype, device=device))
                for _ in range(config.num_layers)]
    pool_dt = kv_pool_dtype(kv_dtype)
    sc_dt = pool_scale_dtype(pool_dt)
    return [LayerCache(*(torch.zeros(shape, dtype=pool_dt, device=device)
                         for _ in range(2)),
                       *(torch.zeros(shape[:3], dtype=sc_dt, device=device)
                         for _ in range(2)))
            for _ in range(config.num_layers)]


def pool_block_bytes(config, block_len: int, kv_dtype: Optional[str] = None) -> int:
    """Bytes one pool block costs across every layer (K, V and any scales):
    the unit a fixed pool budget divides by (a rank's, under TP)."""
    cache = init_paged_cache(config, 1, block_len, kv_dtype, device="meta")
    return sum(t.numel() * t.element_size()
               for layer in cache for t in layer if t is not None)


# ---------------------------------------------------------------------------
# prefix index: radix reuse over the block pool
# ---------------------------------------------------------------------------


class _PrefixNode:
    """One full block in the radix tree: ``key`` is the block's token
    tuple (the edge from its parent), ``block`` the pool block id."""

    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[tuple, "_PrefixNode"] = {}
        self.last_used = 0


class PrefixIndex:
    """Radix index over full, immutable pool blocks keyed by their token
    paths.

    A node is one block; the edge from its parent is the tuple of the
    ``block_len`` tokens written into it, so a path from the root spells
    a prefix in whole blocks. ``lookup`` returns the longest matched
    chain of block ids; ``insert`` retains the full blocks of a prefilled
    prompt (one reference each) and keeps the FIRST block of a duplicate
    path. Only full prompt blocks enter, and chains write only forward of
    their covered prefix, so an indexed block never changes.

    ``evict`` drops least-recently-used leaves whose only reference is the
    index's (a block a chain still shares is pinned, and an interior node
    outlives its children): the first valve under pool pressure, before
    any live chain is preempted."""

    def __init__(self, block_len: int, allocator: BlockAllocator):
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        self.block_len = block_len
        self.allocator = allocator
        self._children: Dict[tuple, _PrefixNode] = {}  # root edges
        self._nodes = 0
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.inserts = 0
        self.evictions = 0

    def __len__(self) -> int:
        """Indexed blocks (= the index's references)."""
        return self._nodes

    @staticmethod
    def _key(tokens, start: int, stop: int) -> tuple:
        return tuple(int(t) for t in tokens[start:stop])

    def lookup(self, tokens) -> List[int]:
        """Block ids of the longest full-block prefix of ``tokens`` in the
        index (maybe empty); marks the matched path recently used."""
        self._clock += 1
        self.lookups += 1
        bl = self.block_len
        out: List[int] = []
        children = self._children
        for i in range(len(tokens) // bl):
            node = children.get(self._key(tokens, i * bl, (i + 1) * bl))
            if node is None:
                break
            node.last_used = self._clock
            out.append(node.block)
            children = node.children
        if out:
            self.hits += 1
        return out

    def insert(self, tokens, chain: List[int], upto: int) -> int:
        """Retain the full blocks covering ``tokens[:upto]`` under their
        token path; ``chain`` maps block index to pool block. A new node
        increfs its block; an existing node keeps its own. Returns the
        number of newly indexed blocks."""
        self._clock += 1
        bl = self.block_len
        nb = min(upto, len(tokens)) // bl
        if nb > len(chain):
            raise ValueError(f"insert upto {upto} needs {nb} blocks but the chain "
                             f"has {len(chain)}")
        added = 0
        children = self._children
        parent = None
        for i in range(nb):
            key = self._key(tokens, i * bl, (i + 1) * bl)
            node = children.get(key)
            if node is None:
                self.allocator.incref(chain[i])
                node = _PrefixNode(key, chain[i], parent)
                children[key] = node
                self._nodes += 1
                added += 1
                self.inserts += 1
            node.last_used = self._clock
            children = node.children
            parent = node
        return added

    def _evictable(self, keep) -> List[_PrefixNode]:
        out = []
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif self.allocator.ref(node.block) == 1 and node.block not in keep:
                out.append(node)
        return out

    def evict(self, n: int, keep=()) -> int:
        """Free up to ``n`` blocks, least recently used evictable leaf
        first (parents become leaves as their children go), sparing the
        blocks in ``keep``. Returns the blocks returned to the free list."""
        keep = set(keep)
        freed = 0
        while freed < n:
            leaves = self._evictable(keep)
            if not leaves:
                break
            node = min(leaves, key=lambda nd: nd.last_used)
            siblings = node.parent.children if node.parent is not None else self._children
            del siblings[node.key]
            self._nodes -= 1
            self.evictions += 1
            self.allocator.decref(node.block)
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every index reference; returns the count dropped."""
        dropped = 0
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            self.allocator.decref(node.block)
            dropped += 1
        self._children = {}
        self._nodes = 0
        return dropped

    def metrics(self) -> dict:
        return {
            "prefix_index_blocks": self._nodes,
            "prefix_lookups": self.lookups,
            "prefix_hits": self.hits,
            "prefix_hit_rate": self.hits / self.lookups if self.lookups else 0.0,
            "prefix_inserts": self.inserts,
            "prefix_evictions": self.evictions,
        }


# ---------------------------------------------------------------------------
# the host tier
# ---------------------------------------------------------------------------


class HostChain(NamedTuple):
    """One request's chain at rest in host RAM: per layer, a
    ``LayerCache`` of host tensors ``[n_blocks, block_len, ...]`` in chain
    order, plus the slot's logits row (the next token's distribution, so
    a restored lane resumes exactly). Block ids do not travel: the
    restore allocates a fresh chain."""

    blocks: object  # List[LayerCache] of host tensors
    logits_row: object  # host tensor [vocab_size]
    n_blocks: int
    block_len: int
    nbytes: int


class HostBlockStore:
    """Host-RAM tier for swapped-out chains, keyed by request id: exact
    byte accounting, an optional ``max_bytes`` budget (``put`` returns
    False when a chain does not fit) and a lock."""

    def __init__(self, max_bytes: Optional[int] = None):
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = max_bytes
        self._chains: Dict[int, HostChain] = {}
        self._bytes = 0
        self._lock = threading.Lock()

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def has_room(self, nbytes: int) -> bool:
        """Whether a chain of ``nbytes`` would fit the budget now."""
        if self.max_bytes is None:
            return True
        with self._lock:
            return self._bytes + nbytes <= self.max_bytes

    def put(self, rid: int, chain: HostChain) -> bool:
        """Store one chain; False (store unchanged) when over budget. A
        second chain for one rid raises."""
        with self._lock:
            if rid in self._chains:
                raise ValueError(f"rid {rid} already has a host chain")
            if self.max_bytes is not None and self._bytes + chain.nbytes > self.max_bytes:
                return False
            self._chains[rid] = chain
            self._bytes += chain.nbytes
            return True

    def get(self, rid: int) -> HostChain:
        with self._lock:
            return self._chains[rid]

    def pop(self, rid: int) -> HostChain:
        """Remove and return; called after a successful restore, so a
        failed one leaves the host copy in place."""
        with self._lock:
            chain = self._chains.pop(rid)
            self._bytes -= chain.nbytes
            return chain

    def __contains__(self, rid: int) -> bool:
        with self._lock:
            return rid in self._chains

    def __len__(self) -> int:
        with self._lock:
            return len(self._chains)

    def rids(self) -> List[int]:
        with self._lock:
            return sorted(self._chains)
