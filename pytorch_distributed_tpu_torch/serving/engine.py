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
  chain moves to host RAM through pinned buffers and back. Fault sites
  (``resilience.faults``): ``kv.swap_out_d2h`` before the wait for the
  copy to the host, ``kv.host_write`` before the commit to the host
  store, ``kv.swap_in_h2d`` before any write to the card.
- **handoff** (``handoff=True``; ``export_chain``/``import_chain``): the
  fleet's prefill-to-decode move of one request's chain and logits row
  into another engine's pool, on the same card or across cards. Fault
  sites ``serve.handoff_export`` and ``serve.handoff_import``.

**Programs.** The JAX engine runs each decode tick and each prefill
bucket as one compiled XLA program. Here each is one CUDA graph, captured
once and replayed with one launch: every kernel of the tick (the paged
attention kernels, cuBLAS's products, the elementwise work and the
sampling) replays from it. A program reads only static device buffers
(one int64 vector of its inputs, viewed as tokens, starts, tables, ...),
which the host fills through a pinned staging twin and one asynchronous
copy a call, and writes only engine-owned buffers outside the graphs'
shared memory pool: the pools, the logits buffer (whose extra dump row
takes the padding jobs' and inactive lanes' rows, as JAX's out-of-range
slot ``n_slots`` is dropped) and the tick's tokens. ``chunk_buckets`` and
the decode tick enumerate the programs ahead of traffic
(``compilecache.serving_registry``); ``warm_*`` prepares one, after an
inert run when ``execute=True``; a program not yet prepared is captured
at its first use. Graphs replay in order on the current stream of the
engine's card (made the current device for every launch) and share one
pool. On the CPU, or with ``cuda_graphs=False``, the same body runs
eagerly over the same static buffers. On CUDA a capture that fails
raises: nothing falls back to the eager path. Block copies, swaps and
the handoff's gather and scatter are one or two copies each and stay
eager. Nothing on the serving path waits for the card but the tick's own
event (``decode_collect``) and a program's last upload (``_stage``), so
engines sharing a card do not wait for each other's work.

The JAX engine donates the pool and the logits buffer to its programs;
here the model writes the pools in place and the engine writes new
logits rows into its buffer in place, so neither is ever copied whole.

**Tensor parallelism** (``mesh=``, a config with ``tp_size`` T; JAX
``PagedEngine(mesh=)``, whose programs run under ``shard_map``): every
model rank of the mesh builds the engine from the same global weights and
makes the same calls in the same order. A rank holds its parameter parts
(``models.generate.tp_state``) and a pool of its H_kv/T heads (the JAX
``paged_cache_specs``), so the chunk and decode programs run the paged
kernels at the local head count with the model's ``tp_copy`` /
``tp_reduce`` inside, and every rank holds the same logits, samples the
same tokens and keeps the same allocator and tables. Block copies and
swaps move the rank's head shard; the fleet's handoff is refused (the JAX
fleet refuses TP). A graph's NCCL collectives are captured with it on the
capture stream, after one all-reduce outside any capture has created the
communicator; a gloo group of ranks sharing one card stages every
collective through the host, which no graph can hold, so graphs are
refused there (``cuda_graphs=False`` runs it eagerly).

The engine owns the pools, the logits buffer, the allocator and the
tables; the caller (``serving.scheduler.Scheduler``) decides what to
admit and when to decode.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import types
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.ops import paged_flash
from pytorch_distributed_tpu_torch.resilience.faults import fault_point
from pytorch_distributed_tpu_torch.models.generate import (
    _sample,
    _validate_sampling,
    _validate_serving_config,
    tp_state,
)
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.parallel.collectives import all_reduce_
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


def _card(device: torch.device) -> torch.device:
    """``device`` with its index filled in (``cuda`` is the current card)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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


class KVExport(NamedTuple):
    """One request's KV detached from its source pool, the unit of the
    fleet's prefill-to-decode handoff (``export_chain``): ``blocks`` holds
    each layer's pool tensors (scales included) gathered to the chain,
    ``[n_blocks, block_len, ...]`` in chain order on the source's card, and
    ``logits_row`` the final chunk's logits, which the importer's first
    decode tick samples from; ``event`` is recorded after the gather (None
    on the CPU). Block ids do not travel: the importer allocates its own
    chain and remaps its table, so the two pools need only agree on
    geometry."""

    blocks: List[LayerCache]
    logits_row: torch.Tensor  # [vocab_size] fp32
    n_blocks: int
    block_len: int
    event: Optional[torch.cuda.Event]


class TickTokens(NamedTuple):
    """A launched decode tick's tokens on their way to the host
    (``decode_launch``): the host tensor the copy lands in and the CUDA
    event recorded after it (None on the CPU, where it is done)."""

    host: torch.Tensor  # [n_slots] int32
    event: Optional[torch.cuda.Event]


class _Program:
    """One program of the engine: its inputs as one static int64 device
    vector viewed field by field (``views``, what the body reads), the
    host twin it is filled through (``stage``, numpy views of a pinned
    tensor; the device vector itself on the CPU) with the event after the
    last copy from it, and, once prepared, its CUDA graph with the
    launches of the paged kernels its capture recorded."""

    def __init__(self, fields: Dict[str, Tuple[int, ...]], device: torch.device):
        n = sum(math.prod(shape) for shape in fields.values())
        self.dev = torch.zeros(n, dtype=torch.int64, device=device)
        self.host = (self.dev if device.type == "cpu"
                     else torch.zeros(n, dtype=torch.int64, pin_memory=True))
        views, self.stage = {}, {}
        off = 0
        for field, shape in fields.items():
            size = math.prod(shape)
            views[field] = self.dev[off:off + size].view(shape)
            self.stage[field] = self.host[off:off + size].numpy().reshape(shape)
            off += size
        self.views = types.SimpleNamespace(**views)
        self.copied: Optional[torch.cuda.Event] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: Tuple[dict, ...] = ()
        self.ready = False  # captured, or (eager) run or warmed once


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
    ``prefix_cache`` arms the prefix index; ``swap`` the swap to host RAM
    and its programs; ``handoff`` the chain export and import of the
    fleet's disaggregated serve. ``params`` may instead be a
    ``TransformerLM`` of this config on this device, shared as it is (the
    fleet's replicas on one card share one copy of the weights).
    ``seed`` seeds the engine's sampling generator.
    ``cuda_graphs=False`` runs the programs eagerly on CUDA too: a switch
    for comparisons, like ``gather_impl="dense"``. ``mesh`` serves a TP
    config on this model rank (module docstring; ``params`` the global
    state dict, or a ``TransformerLM`` at the rank's shapes).

    Every program the engine can run is enumerable ahead of traffic
    (``chunk_buckets``, the decode tick, ``handoff_buckets``,
    ``swap_buckets``):
    ``compilecache.serving_registry`` builds its registry from them, and
    the coverage guard (``ProgramRegistry.assert_covers`` over
    ``compiled_program_names()``) fails on a program it did not predict."""

    #: registry name of the shared decode program
    DECODE_PROGRAM = "decode_tick"
    #: registry name of the copy-on-write block duplication program
    BLOCK_COPY_PROGRAM = "kv_block_copy"

    def __init__(self, config, params, n_slots: int, *,
                 n_blocks: Optional[int] = None, block_len: int = 16,
                 prefill_chunk: int = 128, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 gather_impl: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False, swap: bool = False,
                 handoff: bool = False, split_s: Optional[int] = None, seed: int = 0,
                 cuda_graphs: bool = True, mesh=None, device=None):
        _validate_serving_config(config, mesh)
        _validate_sampling(config, temperature, top_k)
        self.tp = config.model_group() if config.tp_size > 1 else None
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
        if (self.tp is not None and cuda_graphs and self.device.type == "cuda"
                and dist.get_backend(self.tp.group) == dist.Backend.GLOO):
            raise ValueError(
                "cuda_graphs=True on a gloo model group: its ranks share a card and every "
                "tp_reduce is staged through the host, which no CUDA graph can hold; build "
                "the engine with cuda_graphs=False (or give each rank a card over NCCL)")
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
        # row n_slots is the dump row: padding jobs and inactive lanes
        # write there, so every program's logits scatter has one shape
        self._logits_buf = torch.zeros((n_slots + 1, config.vocab_size),
                                       dtype=torch.float32, device=self.device)
        self.logits = self._logits_buf[:n_slots]
        self._tick_tokens = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.prefix_cache = bool(prefix_cache)
        self.prefix: Optional[PrefixIndex] = (
            PrefixIndex(block_len, self.allocator) if prefix_cache else None)
        self._cow_copies = 0
        self.swap = bool(swap)
        self.handoff = bool(handoff)
        self._export_ran: set = set()
        self._import_ran: set = set()
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self._chunk_progs: Dict[Tuple[int, int], _Program] = {}
        self._decode_prog: Optional[_Program] = None
        self._swap_out_ran: set = set()
        self._swap_in_ran: set = set()
        self._copy_ran = False
        self._pool = None  # the graphs' shared memory pool, at the first capture
        self._capture_stream: Optional[torch.cuda.Stream] = None
        #: graphs captured, and the seconds their captures took
        self.captures = 0
        self.capture_s = 0.0
        if isinstance(params, TransformerLM):
            weights = next(params.parameters())
            if params.cfg != config or _card(weights.device) != _card(self.device):
                raise ValueError(
                    f"a shared model must be built from this engine's config on "
                    f"{self.device}; got one on {weights.device} with "
                    f"{'the same' if params.cfg == config else 'another'} config")
            self.model = params
        else:
            with torch.device(self.device):
                model = TransformerLM(config)
            model.load_state_dict(tp_state(config, params, mesh))
            self.model = model.eval().requires_grad_(False)

    def _on_card(self):
        """The engine's card as the current device, so its graphs replay and
        its events record on that card's current stream; nothing on the
        CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _index(self, ids: List[int]) -> torch.Tensor:
        """Block ids as a device index, uploaded from pinned memory without
        waiting for the card."""
        idx = torch.as_tensor(ids, dtype=torch.long)
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        return idx

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
        self._copy_ran = True

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

    def _require_swap(self) -> None:
        if not self.swap:
            raise RuntimeError(
                "this engine was built without swap=True: its registry does not "
                "predict kv_swap_out/kv_swap_in (offload-enabled schedulers set it)")

    def _gather_to_host(self, ids: List[int], row: int):
        """Blocks ``ids`` of every pool tensor and logits row ``row`` into
        pinned host buffers by asynchronous copies: ``(blocks, row, event
        after the copies or None on the CPU)``."""
        idx = self._index(ids)
        blocks = []
        for layer in self.cache:
            host = []
            for t in layer:
                if t is None:
                    host.append(None)
                    continue
                h = self._host_empty(t, (len(ids),) + tuple(t.shape[1:]))
                h.copy_(t[idx], non_blocking=True)
                host.append(h)
            blocks.append(LayerCache(*host))
        logits_row = self._host_empty(self.logits, self.logits.shape[1:])
        logits_row.copy_(self._logits_buf[row], non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return blocks, logits_row, event

    def _scatter(self, ids: List[int], blocks: List[LayerCache], row: int,
                 logits_row: torch.Tensor) -> None:
        """``blocks`` into pool blocks ``ids`` of every pool tensor and
        ``logits_row`` into logits row ``row``, in place, copied first where
        they lie elsewhere (host RAM, another card)."""
        idx = self._index(ids)
        for layer, src in zip(self.cache, blocks):
            for t, b in zip(layer, src):
                if t is not None:
                    t[idx] = b.to(self.device, non_blocking=True)
        self._logits_buf[row] = logits_row.to(self.device, non_blocking=True)

    def swap_out_begin(self, slot: int) -> PendingSwap:
        """Start moving ``slot``'s chain to host RAM: gather its blocks
        (every pool tensor) and the slot's logits row into pinned host
        buffers with asynchronous copies, and record an event after them.
        The chain stays allocated and ``swapping-out``: nothing is freed
        until ``swap_out_finish`` commits, so a failure leaves the stream
        resident."""
        self._require_swap()
        chain = self.allocator.chain(slot)
        if not chain:
            raise ValueError(f"slot {slot} holds no block chain to swap")
        self.allocator.set_state(slot, SWAPPING_OUT)
        try:
            with self._on_card():
                blocks, row, event = self._gather_to_host(chain, slot)
        except BaseException:
            self.allocator.clear_state(slot)
            raise
        self._swap_out_ran.add(self._chain_bucket(len(chain)))
        return PendingSwap(slot, len(chain), blocks, row, event)

    def swap_out_finish(self, pending: PendingSwap, store: HostBlockStore,
                        rid: int) -> HostChain:
        """Wait for the copies, commit the chain to ``store`` under ``rid``,
        then free the device chain. A failure before the commit (a full
        store raises ``OSError``, as do the ``kv.swap_out_d2h`` and
        ``kv.host_write`` fault sites) closes the window with the chain
        still resident."""
        slot = pending.slot
        try:
            fault_point("kv.swap_out_d2h")
            if pending.event is not None:
                pending.event.synchronize()
            nbytes = pending.logits_row.numel() * pending.logits_row.element_size() + sum(
                t.numel() * t.element_size()
                for layer in pending.blocks for t in layer if t is not None)
            chain = HostChain(blocks=pending.blocks, logits_row=pending.logits_row,
                              n_blocks=pending.chain_len, block_len=self.block_len,
                              nbytes=nbytes)
            fault_point("kv.host_write")
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
        retries. A failure while copying (the ``kv.swap_in_h2d`` fault
        site fires before any write) frees the fresh chain and raises,
        the host copy intact."""
        self._require_swap()
        if chain.block_len != self.block_len:
            raise ValueError(f"cannot swap block_len={chain.block_len} blocks into "
                             f"a block_len={self.block_len} pool")
        ids = self._alloc_evict(slot, [], chain.n_blocks)
        if ids is None:
            return False
        self.allocator.set_state(slot, SWAPPING_IN)
        try:
            fault_point("kv.swap_in_h2d")
            with self._on_card():
                self._scatter(ids, chain.blocks, slot, chain.logits_row)
        except BaseException:
            self.allocator.clear_state(slot)
            self.allocator.free(slot)
            raise
        self.allocator.clear_state(slot)
        self._set_row(slot, ids)
        self._swap_in_ran.add(self._chain_bucket(chain.n_blocks))
        return True

    # ---- the fleet's prefill-to-decode handoff ----

    def _require_handoff(self) -> None:
        if not self.handoff:
            raise RuntimeError(
                "this engine was built without handoff=True: its registry does not "
                "predict kv_export/kv_import (fleet routers enable it on every replica "
                "they own)")

    def _refuse_tp(self, what: str) -> None:
        if self.tp is not None:
            raise RuntimeError(
                f"{what}: a tensor-parallel engine holds one head shard of each chain; the "
                "fleet's handoff moves whole chains between single-device replicas (the "
                "fleet refuses tensor parallelism)")

    def export_chain(self, slot: int) -> KVExport:
        """Detach ``slot``'s KV for another engine's pool: gather the chain's
        blocks from every pool tensor (K and V, and the scales of a
        quantized pool) and the slot's logits row, then record an event.
        A pure read: the slot stays resident until ``release``, so an
        import that fails leaves this export valid for a retry."""
        self._refuse_tp("export_chain")
        self._require_handoff()
        # before the chain is read: the fleet counts the source as failed
        fault_point("serve.handoff_export")
        chain = self.allocator.chain(slot)
        if not chain:
            raise ValueError(f"slot {slot} holds no block chain to export")
        with self._on_card():
            blocks, row = self._gather(chain, slot)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        self._export_ran.add(self._chain_bucket(len(chain)))
        return KVExport(blocks, row, len(chain), self.block_len, event)

    def _gather(self, ids: List[int], row: int):
        """Blocks ``ids`` of every pool tensor and logits row ``row``, copied
        out on the card."""
        idx = self._index(ids)
        return ([LayerCache(*(None if t is None else t[idx] for t in layer))
                 for layer in self.cache], self._logits_buf[row].clone())

    def import_chain(self, slot: int, export: KVExport) -> bool:
        """Adopt an exported chain into ``slot``: allocate a fresh chain
        (evicting index blocks if need be), copy the blocks and the logits
        row in (across cards, a copy ordered after the export's gather by
        its event), and remap the slot's table row. False, state
        unchanged, when the pool cannot supply the chain: the caller keeps
        the export and retries. A failure after the allocation frees the
        fresh chain and raises, the export still valid."""
        self._refuse_tp("import_chain")
        self._require_handoff()
        # before any block is allocated here: the source stays exportable
        fault_point("serve.handoff_import")
        if export.block_len != self.block_len:
            raise ValueError(f"cannot import block_len={export.block_len} blocks into "
                             f"a block_len={self.block_len} pool")
        for layer, src in zip(self.cache, export.blocks):
            for t, b in zip(layer, src):
                if (t is None) != (b is None) or (t is not None and (
                        b.dtype != t.dtype or b.shape[1:] != t.shape[1:])):
                    raise ValueError("the export's pool layout differs from this pool's")
        chain = self._alloc_evict(slot, [], export.n_blocks)
        if chain is None:
            return False
        try:
            with self._on_card():
                if export.event is not None and _card(export.logits_row.device) != _card(
                        self.device):
                    torch.cuda.current_stream().wait_event(export.event)
                self._scatter(chain, export.blocks, slot, export.logits_row)
        except BaseException:
            self.allocator.free(slot)
            self.tables[slot] = TRASH_BLOCK
            raise
        self._set_row(slot, chain)
        self._import_ran.add(self._chain_bucket(export.n_blocks))
        return True

    # ---- program enumeration (compilecache.serving_registry) ----

    @staticmethod
    def chunk_program_name(k_pad: int, wp: int) -> str:
        """Stable registry identity of one chunk-prefill bucket."""
        return f"chunk_prefill[k={k_pad},w={wp}]"

    @staticmethod
    def export_program_name(n_pad: int) -> str:
        return f"kv_export[n={n_pad}]"

    @staticmethod
    def import_program_name(n_pad: int) -> str:
        return f"kv_import[n={n_pad}]"

    @staticmethod
    def swap_out_program_name(n_pad: int) -> str:
        return f"kv_swap_out[n={n_pad}]"

    @staticmethod
    def swap_in_program_name(n_pad: int) -> str:
        return f"kv_swap_in[n={n_pad}]"

    def bucket_for(self, jobs: List[ChunkJob]) -> Tuple[int, int]:
        """The (padded job count, table-slice width) bucket ``run_chunks``
        runs ``jobs`` in: the registry's enumeration and the scheduler's
        cold-request accounting read it from here."""
        k_pad = _pow2_bucket(len(jobs))
        max_end = max(j.start + self.chunk for j in jobs)
        wp = min(_pow2_bucket(-(-max_end // self.block_len)), self.table_width)
        return k_pad, wp

    def _widths(self) -> List[int]:
        """Powers of two below ``table_width``, then ``table_width``."""
        ws, w = [], 1
        while w < self.table_width:
            ws.append(w)
            w <<= 1
        ws.append(self.table_width)
        return sorted(set(ws))

    def chunk_buckets(self) -> List[Tuple[int, int]]:
        """Every (k_pad, wp) bucket ``bucket_for`` can give: job counts
        1..n_slots padded to powers of two, table slices the power-of-two
        widths clipped to ``table_width`` (admission refuses a prompt whose
        padded length exceeds ``max_seq_len``)."""
        ks, k = [], 1
        while k < self.n_slots:
            ks.append(k)
            k <<= 1
        ks.append(_pow2_bucket(self.n_slots))
        return [(k, w) for k in ks for w in self._widths()]

    def _chain_bucket(self, n: int) -> int:
        """A chain's swap or handoff bucket: its length's power of two,
        clipped to ``table_width``."""
        return min(_pow2_bucket(n), self.table_width)

    def swap_buckets(self) -> List[int]:
        """Every chain-length bucket of the swap programs (a chain never
        outgrows the table). Empty unless the engine was built with
        ``swap=True``."""
        return self._widths() if self.swap else []

    def handoff_buckets(self) -> List[int]:
        """Every chain-length bucket of the handoff's export and import
        (a chain never outgrows the table). Empty unless the engine was
        built with ``handoff=True``."""
        return self._widths() if self.handoff else []

    def has_chunk_program(self, k_pad: int, wp: int) -> bool:
        """True when the bucket is ready: captured (graphs), or run or
        warmed once (eager)."""
        prog = self._chunk_progs.get((k_pad, wp))
        return prog is not None and prog.ready

    @property
    def has_decode_program(self) -> bool:
        return self._decode_prog is not None and self._decode_prog.ready

    def compiled_program_names(self) -> List[str]:
        """Live program inventory for the registry coverage guard: every
        captured (eager: run) program, each once, and the handoff, swap and
        block copies that have run."""
        names = [self.chunk_program_name(k, w) for (k, w), prog in
                 sorted(self._chunk_progs.items()) if prog.ready]
        if self.has_decode_program:
            names.append(self.DECODE_PROGRAM)
        names += [self.export_program_name(n) for n in sorted(self._export_ran)]
        names += [self.import_program_name(n) for n in sorted(self._import_ran)]
        names += [self.swap_out_program_name(n) for n in sorted(self._swap_out_ran)]
        names += [self.swap_in_program_name(n) for n in sorted(self._swap_in_ran)]
        if self._copy_ran:
            names.append(self.BLOCK_COPY_PROGRAM)
        return names

    def graph_pool_bytes(self) -> Optional[int]:
        """Device bytes the graphs' shared pool holds (its segments in
        ``torch.cuda.memory_snapshot``); 0 before the first capture, None
        where the snapshot does not name segments' pools."""
        if self._pool is None:
            return 0
        segments = torch.cuda.memory_snapshot()
        if segments and "segment_pool_id" not in segments[0]:
            return None
        return sum(seg["total_size"] for seg in segments
                   if tuple(seg["segment_pool_id"]) == tuple(self._pool))

    # ---- warmup: prepare a program before traffic needs it ----

    def warm_chunk(self, k_pad: int, wp: int, execute: bool = True) -> float:
        """Prepare the (k_pad, wp) chunk program before traffic needs it;
        returns the capture's seconds. ``execute=True`` first runs it once
        with inert inputs: every job a padding job (its logits row goes to
        the dump row) whose table points at the trash block, so the live
        blocks and the logits of live slots stay bit-identical.
        ``execute=False`` captures without running. Call it between steps,
        on the serving thread. A prepared program is left as it is, and so
        is a bucket narrower than one chunk: the JAX enumeration keeps it
        (XLA clamps its out-of-range reads), but no job can reach it
        (``bucket_for``), and its inert run would read past its table."""
        if wp < min(_pow2_bucket(-(-self.chunk // self.block_len)), self.table_width):
            return 0.0
        prog = self._chunk_program(k_pad, wp)
        if prog.ready:
            return 0.0
        with self._on_card():
            self._stage_chunk(prog, [])
            return self._prepare(prog, self._chunk_body, execute)

    def warm_decode(self, execute: bool = True) -> float:
        """The decode tick's ``warm_chunk``: the inert run decodes with
        every lane inactive (trash-only tables, rows to the dump row, the
        generator's state put back after it)."""
        prog = self._decode_program()
        if prog.ready:
            return 0.0
        with self._on_card():
            self._stage_decode(prog, np.zeros(self.n_slots, np.int64),
                               np.zeros(self.n_slots, bool))
            return self._prepare(prog, self._decode_body, execute)

    def warm_block_copy(self, execute: bool = True) -> float:
        """Run the copy-on-write block copy inertly (the trash block onto
        itself) when ``execute``; it is a copy a pool tensor, eager, so
        there is nothing to capture."""
        self._require_prefix()
        if execute:
            self._copy_block(TRASH_BLOCK, TRASH_BLOCK)
        return 0.0

    def warm_export(self, n_pad: int, execute: bool = True) -> float:
        """Run one export bucket inertly when ``execute``: ``n_pad`` reads of
        the trash block from every pool tensor and slot 0's logits row,
        mutating nothing. Eager: nothing to capture."""
        self._require_handoff()
        if execute:
            with self._on_card():
                self._gather([TRASH_BLOCK] * n_pad, 0)
            self._export_ran.add(n_pad)
        return 0.0

    def warm_import(self, n_pad: int, execute: bool = True) -> float:
        """Run one import bucket inertly when ``execute``: zeros into the
        trash block ``n_pad`` times and into the dump logits row."""
        self._require_handoff()
        if execute:
            blocks = [LayerCache(*(None if t is None else
                                   torch.zeros((n_pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                                               device=self.device) for t in layer))
                      for layer in self.cache]
            with self._on_card():
                self._scatter([TRASH_BLOCK] * n_pad, blocks, self.n_slots,
                              torch.zeros_like(self.logits[0]))
            self._import_ran.add(n_pad)
        return 0.0

    def warm_swap_out(self, n_pad: int, execute: bool = True) -> float:
        """Run one swap-out bucket inertly when ``execute``: ``n_pad``
        copies of the trash block and slot 0's logits row to host RAM,
        mutating nothing. Eager: nothing to capture."""
        self._require_swap()
        if execute:
            with self._on_card():
                _, _, event = self._gather_to_host([TRASH_BLOCK] * n_pad, 0)
            if event is not None:
                event.synchronize()
            self._swap_out_ran.add(n_pad)
        return 0.0

    def warm_swap_in(self, n_pad: int, execute: bool = True) -> float:
        """Run one swap-in bucket inertly when ``execute``: zeros into the
        trash block ``n_pad`` times and into the dump logits row."""
        self._require_swap()
        if execute:
            blocks = [LayerCache(*(None if t is None else
                                   self._host_empty(t, (n_pad,) + tuple(t.shape[1:])).zero_()
                                   for t in layer))
                      for layer in self.cache]
            row = self._host_empty(self.logits, self.logits.shape[1:]).zero_()
            with self._on_card():
                self._scatter([TRASH_BLOCK] * n_pad, blocks, self.n_slots, row)
            self._swap_in_ran.add(n_pad)
        return 0.0

    # ---- programs: static inputs, the bodies, capture and replay ----

    def _chunk_program(self, k_pad: int, wp: int) -> _Program:
        prog = self._chunk_progs.get((k_pad, wp))
        if prog is None:
            prog = _Program({
                "tokens": (k_pad, self.chunk), "starts": (k_pad,), "tables": (k_pad, wp),
                "last_idx": (k_pad,), "slots": (k_pad,)}, self.device)
            self._chunk_progs[(k_pad, wp)] = prog
        return prog

    def _decode_program(self) -> _Program:
        if self._decode_prog is None:
            n = self.n_slots
            self._decode_prog = _Program({
                "positions": (n,), "dest": (n,), "tables": (n, self.table_width)},
                self.device)
        return self._decode_prog

    @staticmethod
    def _stage(prog: _Program) -> Dict[str, np.ndarray]:
        """The program's host staging views, once the last copy from them
        has left (so a second call before the card catches up cannot
        overwrite inputs still on their way)."""
        if prog.copied is not None:
            prog.copied.synchronize()
        return prog.stage

    def _upload(self, prog: _Program) -> None:
        """Copy the staged inputs into the program's static device buffer
        (one asynchronous copy from pinned memory; on the CPU they are
        already there)."""
        if self.device.type == "cuda":
            prog.dev.copy_(prog.host, non_blocking=True)
            prog.copied = torch.cuda.Event()
            prog.copied.record()

    def _stage_chunk(self, prog: _Program, jobs: List[ChunkJob]) -> None:
        """Stage ``jobs`` into a chunk program's inputs; the rows past them
        are padding jobs (zeros, trash-only tables, the dump logits row), as
        are the chunks that are not a prompt's last."""
        st = self._stage(prog)
        st["tokens"][:] = 0
        st["starts"][:] = 0
        st["tables"][:] = TRASH_BLOCK
        st["last_idx"][:] = 0
        st["slots"][:] = self.n_slots
        wp = st["tables"].shape[1]
        for i, j in enumerate(jobs):
            st["tokens"][i] = j.tokens
            st["starts"][i] = j.start
            st["tables"][i] = self.tables[j.slot, :wp]
            if j.is_last:
                st["slots"][i] = j.slot
                st["last_idx"][i] = j.last_idx
        self._upload(prog)

    def _stage_decode(self, prog: _Program, positions: np.ndarray,
                      active: np.ndarray) -> None:
        st = self._stage(prog)
        st["positions"][:] = np.where(active, positions, 0)
        st["dest"][:] = np.where(active, np.arange(self.n_slots), self.n_slots)
        st["tables"][:] = np.where(active[:, None], self.tables, TRASH_BLOCK)
        self._upload(prog)

    def _chunk_body(self, v) -> None:
        """One chunk prefill over the bucket's static inputs: the forward
        writes the chunk's K/V into the pools, and the logits row of each
        job's ``last_idx`` goes to its ``slots`` row (the dump row for
        padding jobs and chunks that are not a prompt's last)."""
        rows = self.model(v.tokens, v.starts, v.tables, self.cache,
                          logits_index=v.last_idx)[:, 0]
        self._logits_buf.index_copy_(0, v.slots, rows)

    def _decode_body(self, v) -> None:
        """One decode tick: sample every slot's token from the logits
        buffer, run it through the model at its position, write the new
        logits rows of the active lanes (``dest``; the dump row for the
        others) and the tokens into the engine's token buffer."""
        tokens = _sample(self.logits, self.temperature, self.top_k, self.generator)
        out = self.model(tokens[:, None].long(), v.positions, v.tables, self.cache)
        self._logits_buf.index_copy_(0, v.dest, out[:, 0])
        self._tick_tokens.copy_(tokens)

    def _prepare(self, prog: _Program, body, execute: bool) -> float:
        """Ready ``prog`` over the inert inputs just staged: an inert run
        first if ``execute`` (its launches not counted, the generator put
        back), then the capture (graphs). Returns the capture's seconds."""
        if execute:
            snap = paged_flash.launch_snapshot()
            state = self.generator.get_state()
            try:
                with torch.no_grad():
                    body(prog.views)
            finally:
                self.generator.set_state(state)
                paged_flash.restore_launches(snap)
        if self.cuda_graphs:
            return self._capture(prog, body)
        prog.ready = True
        return 0.0

    def _begin_capturing(self) -> None:
        """Once, before the first capture: the shared pool, the capture
        stream, cuBLAS's handle and workspace on that stream (created by a
        product outside any capture), under TP the model group's NCCL
        communicator (an all-reduce on that stream: every rank reaches its
        first capture at the same call), and the paged kernels' library and
        split scratch sized for every program at the rank's heads
        (``reserve_split_buffers``)."""
        self._pool = torch.cuda.graph_pool_handle()
        self._capture_stream = torch.cuda.Stream(self.device)
        dt = self.config.dtype
        with torch.cuda.stream(self._capture_stream), torch.no_grad():
            x = torch.ones((16, 16), dtype=dt, device=self.device)
            torch.nn.functional.linear(x, x, x[0])
            if self.tp is not None:
                all_reduce_(x, group=self.tp.group)
        self._capture_stream.synchronize()
        if self.config.gather_impl == "kernel":
            h = self.config.num_heads // self.config.tp_size
            calls = [(self.n_slots, 1, h, self.table_width, self.config.split_s)]
            calls += [(k, self.chunk, h, w, self.config.split_s)
                      for k, w in self.chunk_buckets()]
            pool = self.cache[0].key
            paged_flash.reserve_split_buffers(self._capture_stream.cuda_stream, pool.device,
                                              dt, pool, calls)

    def _capture(self, prog: _Program, body) -> float:
        """Capture ``body`` over ``prog``'s static inputs as its CUDA graph
        (nothing runs), with the launches it recorded kept for its
        replays and not counted now. Sampling at a temperature registers
        the engine's generator with the graph, so every replay draws
        anew. A capture that fails raises."""
        if self._pool is None:
            self._begin_capturing()
        graph = torch.cuda.CUDAGraph()
        if self.temperature > 0.0 and body == self._decode_body:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"torch {torch.__version__} cannot register a generator with a CUDA "
                    "graph (CUDAGraph.register_generator_state), so a captured sampling "
                    "tick would replay frozen draws; serve at temperature 0 or build the "
                    "engine with cuda_graphs=False")
            graph.register_generator_state(self.generator)
        snap = paged_flash.launch_snapshot()
        t0 = time.perf_counter()
        # under TP, NCCL's watchdog thread queries its events while this
        # thread captures: only this thread's calls are checked
        mode = "global" if self.tp is None else "thread_local"
        try:
            with torch.no_grad(), torch.cuda.graph(graph, pool=self._pool,
                                                   stream=self._capture_stream,
                                                   capture_error_mode=mode):
                body(prog.views)
            prog.launches = paged_flash.launches_since(snap)
        finally:
            paged_flash.restore_launches(snap)
        seconds = time.perf_counter() - t0
        prog.graph = graph
        prog.ready = True
        self.captures += 1
        self.capture_s += seconds
        return seconds

    def _run(self, prog: _Program, body) -> None:
        """Run ``prog`` on its staged inputs: replay its graph (capturing
        it first at its first use), adding the launches the capture
        recorded; eager, run the body."""
        if self.cuda_graphs:
            if prog.graph is None:
                self._capture(prog, body)
            prog.graph.replay()
            paged_flash.add_launches(prog.launches)
            return
        with torch.no_grad():
            body(prog.views)
        prog.ready = True

    # ---- chunked prefill ----

    def run_chunks(self, jobs: List[ChunkJob]) -> float:
        """Prefill one chunk for each job in one program. Chunks of one
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
        prog = self._chunk_program(*self.bucket_for(jobs))
        with self._on_card():
            self._stage_chunk(prog, jobs)
            self._run(prog, self._chunk_body)
        return time.perf_counter() - t0

    # ---- decode ----

    def decode_launch(self, positions: np.ndarray, active: np.ndarray):
        """Enqueue one decode tick for every slot without waiting for it:
        returns ``(TickTokens, new_positions)``. Inactive lanes read and
        write through trash-only table rows at position 0 and keep their
        positions; their logits rows are left as they are."""
        positions = np.asarray(positions, np.int64)
        active = np.asarray(active, bool)
        prog = self._decode_program()
        with self._on_card():
            self._stage_decode(prog, positions, active)
            self._run(prog, self._decode_body)
            host = torch.empty(self.n_slots, dtype=torch.int32,
                               pin_memory=self.device.type == "cuda")
            host.copy_(self._tick_tokens, non_blocking=True)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        return TickTokens(host, event), np.where(active, positions + 1, positions)

    def decode_collect(self, tokens: TickTokens,
                       positions: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a ``decode_launch``'s tokens and return them on the
        host."""
        if tokens.event is not None:
            tokens.event.synchronize()
        return tokens.host.numpy().copy(), positions

    def decode(self, positions: np.ndarray, active: np.ndarray):
        """One decode tick: ``(tokens [n_slots], new_positions)`` on the
        host."""
        return self.decode_collect(*self.decode_launch(positions, active))
