"""Continuous scheduler over the paged engine
(``pytorch_distributed_tpu/serving/scheduler.py``, its core, the prefix
path and the pressure tier).

Policy (continuous batching with chunked prefill):

- **FIFO admission**: each ``step()`` admits up to ``admit_per_step``
  queued requests in submit order, stopping at the first that cannot get
  a slot or a block chain (no head-of-line skipping). Every admitted
  prompt not yet prefilled advances by one chunk per step, all in one
  forward, so a long prompt interleaves with everyone else's decoding.
- **decode**: every prefilled slot with budget advances one token per
  step; ``eos_id`` retires a slot early. Retirement frees the chain at
  once.
- **OOM queues**: a request the pool cannot serve now stays queued.
  ``submit`` raises only for a request no configuration could serve.
- **prefix sharing** (``prefix_cache=True``): admission goes through
  ``PagedEngine.admit_shared``, so a prompt whose leading full blocks are
  indexed prefills only its tail; every full prompt block a chunk
  completes is indexed at once. Streams stay token-identical.
- **the pressure tier** (``offload=True``): ``preempt(rid)`` parks a
  decoding request, either swapping its chain to host RAM
  (``HostBlockStore``) or dropping it to be recomputed from the prompt
  plus the tokens it streamed, by the measured swap-vs-recompute
  comparison (``telemetry.costmodel.swap_vs_recompute``) unless
  ``swap_policy`` forces one. Parked requests are restored first in
  every step, before admissions, token-identical either way.
  ``preempt_on_oom`` preempts one least-recently-served victim per stuck
  queue head.
- **warmup** (``warmup``): every program the engine can run
  (``compilecache.serving_registry``) captured before traffic. A request
  whose chunk bucket or decode tick was captured (on the CPU or eager:
  first run) inside its lifetime is **cold**; ``metrics()`` counts them
  (``cold_requests``), the capture seconds (``compile_s``) and the TTFT of
  the warm ones alone (``ttft_warm_*``).

- **the tick as two halves** (``dispatch_tick`` / ``collect_tick``):
  dispatch runs the deadline sweep, the swap finalizations and restores,
  admissions, the prefill chunk and *launches* the decode tick; collect
  waits for its tokens and does the per-token work (latencies,
  retirement). ``step()`` is ``collect_tick(); dispatch_tick();
  collect_tick()``. A driver may run them lagged, ``collect_tick();
  dispatch_tick()`` per iteration, leaving one tick in flight between
  iterations (never two: dispatch raises while one is pending). On one
  scheduler collect(N-1) then dispatch(N) is the synchronous order, so
  the streams are the same; the overlap it allows comes from
  interleaving schedulers. Every mutation from outside the tick
  (``preempt``, ``preempt_lru``, ``cancel``, ``begin_drain``) collects
  the pending tick first and keeps its tokens for the next
  ``collect_tick``.
- **the request lifecycle**: ``cancel(rid)`` frees a request wherever it
  is (queued, mid-prefill, decoding, parked, mid swap-out); a
  ``deadline`` (``submit(deadline_s=)`` or an absolute
  ``time.perf_counter()`` ``deadline=``) expires it through the same path
  at the top of a dispatch. ``begin_drain`` / ``drain_graceful`` stop
  admission, run the admitted requests out and hand the queue back;
  ``harvest_requests`` / ``abandon`` tear a scheduler down with no block
  left behind. ``on_retire(rid, outcome)`` is called as a request leaves
  (``"complete"``, ``"cancelled"``, ``"deadline"``).

Fault sites (``resilience.faults``): ``serve.dispatch`` before any tick
work, ``serve.collect`` before a collect; the engine's ``kv.*`` sites in
the swaps. A failed swap-out reverts the preemption; a failed swap-in
leaves the request parked with its host copy, retried the next tick.

Metrics are exact host-side counters and latency series. The flight
recorder, request tracing, the block sanitizer and the fleet's handoff
states are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from pytorch_distributed_tpu_torch.resilience.faults import fault_point
from pytorch_distributed_tpu_torch.serving.engine import ChunkJob, PagedEngine
from pytorch_distributed_tpu_torch.serving.kv_pool import HostBlockStore
from pytorch_distributed_tpu_torch.telemetry.costmodel import (
    SwapDecision,
    swap_vs_recompute,
)
from pytorch_distributed_tpu_torch.telemetry.latency import LatencySeries

SWAP_POLICIES = ("auto", "swap", "recompute")


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray  # [L] int32 prompt (grows on a recompute restore)
    max_new_tokens: int
    submit_step: int
    submit_time: float
    slot: int = -1  # -1 while queued
    prefill_done: int = 0  # prompt tokens prefilled so far
    produced: int = 0
    admit_time: float = float("nan")
    first_token_time: float = float("nan")
    last_token_time: float = float("nan")
    # inter-token gaps after the first token
    token_gaps: List[float] = dataclasses.field(default_factory=list)
    # tokens streamed since the last recompute restore, kept under offload:
    # a recompute restore prefills them again as prompt
    generated: Optional[List[int]] = None
    # the decode position a swap restore resumes at
    resume_position: int = 0
    preempts: int = 0
    # a just-restored request is not a victim again before this step
    protect_until: int = -1
    # a program it rode (its chunk bucket, the decode tick) was captured
    # (on the CPU or eager: first run) inside its lifetime
    cold: bool = False
    # absolute time.perf_counter() instant after which the request expires
    # (outcome "deadline"); absolute, so a re-submission keeps the clock
    deadline: float = float("inf")

    @property
    def length(self) -> int:
        return int(len(self.tokens))


class TickHandle(NamedTuple):
    """A dispatched tick not yet collected. ``tokens``: the launched
    decode's ``TickTokens`` (its pinned host buffer lives until the
    collect), or None when no lane decoded. ``lanes``: the slots that
    decoded, the only ones the collect writes back; every one is still
    resident at the collect, because each mutation from outside the tick
    collects first."""

    tokens: object
    positions: Optional[np.ndarray]
    lanes: Tuple[int, ...]
    t_step0: float
    cold_decode: bool


class Scheduler:
    """``submit`` enqueues, ``step`` advances the system one tick and
    returns ``[(rid, token)]`` for the tokens it produced (or
    ``dispatch_tick`` / ``collect_tick``, the two halves), ``drain`` runs
    to empty. Runs on CUDA unless ``device="cpu"`` is passed; raises
    without a card. ``seed`` seeds the sampling generator (unused when
    greedy). ``host_store_max_bytes`` bounds the host tier.
    ``cuda_graphs=False`` runs the engine's programs eagerly (a switch for
    comparisons)."""

    def __init__(self, config, params, n_slots: int, *,
                 n_blocks: Optional[int] = None, block_len: int = 16,
                 prefill_chunk: int = 64, admit_per_step: int = 4,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 seed: int = 0, eos_id: Optional[int] = None,
                 gather_impl: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: bool = False,
                 offload: bool = False, preempt_on_oom: bool = False,
                 swap_policy: str = "auto", protect_ticks: int = 2,
                 host_store_max_bytes: Optional[int] = None,
                 split_s: Optional[int] = None, cuda_graphs: bool = True,
                 device=None):
        if swap_policy not in SWAP_POLICIES:
            raise ValueError(f"swap_policy {swap_policy!r} must be auto|swap|recompute")
        if preempt_on_oom and not offload:
            raise ValueError("preempt_on_oom needs offload=True")
        if eos_id is not None and not 0 <= eos_id < config.vocab_size:
            raise ValueError(
                f"eos_id {eos_id} outside [0, vocab_size={config.vocab_size})")
        if admit_per_step < 1:
            raise ValueError(f"admit_per_step must be >= 1, got {admit_per_step}")
        self.engine = PagedEngine(
            config, params, n_slots, n_blocks=n_blocks, block_len=block_len,
            prefill_chunk=prefill_chunk, temperature=temperature, top_k=top_k,
            gather_impl=gather_impl, kv_dtype=kv_dtype, prefix_cache=prefix_cache,
            swap=offload, split_s=split_s, seed=seed, cuda_graphs=cuda_graphs,
            device=device,
        )
        # the engine may have replaced gather_impl/split_s into the config
        self.config = self.engine.config
        self.n_slots = n_slots
        self.admit_per_step = admit_per_step
        self.eos_id = eos_id
        self.prefix_cache = prefix_cache
        self.offload = offload
        self.preempt_on_oom = preempt_on_oom
        self.swap_policy = swap_policy
        self.protect_ticks = protect_ticks
        self.host_store = HostBlockStore(max_bytes=host_store_max_bytes)
        self._next_rid = 0
        self._step_count = 0
        self.queue: deque = deque()
        self.resident: Dict[int, Request] = {}  # slot -> request
        # rid -> (request, "swap" | "recompute"), restored in this order
        self.parked: Dict[int, Tuple[Request, str]] = {}
        # open swap-out windows: (rid, request, PendingSwap, t0, decision)
        self._swapping: List[tuple] = []
        self._swap_slots: set = set()  # slots whose chain is mid swap-out
        self._oom_preempted_for: Optional[int] = None
        self.positions = np.zeros(n_slots, np.int64)
        self.remaining = np.zeros(n_slots, np.int64)
        self._tokens_out = 0
        self._completed = 0
        self._admitted = 0
        self._adm_latency_steps = 0
        self._adm_latency_s = 0.0
        self._occupancy_sum = 0.0
        self._admitted_prefill_tokens = 0
        self._prefix_covered_tokens = 0
        self._preempts = 0
        self._restores = 0
        self._swap_outs = 0
        self._swap_ins = 0
        self._swap_aborts = 0
        self._swap_bytes = 0
        self._decision_swap = 0
        self._decision_recompute = 0
        # host wall of run_chunks calls on warm buckets (a cold call
        # captures, or loads the kernels): the recompute side of the
        # swap-vs-recompute decision
        self._chunk_calls = 0
        self._chunk_wall_s = 0.0
        self._cold_requests = 0
        self._start_time: Optional[float] = None
        self.ttft = LatencySeries("ttft")
        # TTFT of the requests no capture stalled: the honest SLO series
        self.ttft_warm = LatencySeries("ttft_warm")
        self.token_lat = LatencySeries("token_lat")
        self.queue_wait = LatencySeries("queue_wait")
        self.tick_lat = LatencySeries("tick")
        self.swap_lat = LatencySeries("swap")
        # the lifecycle: admission stops while draining; cancels and
        # deadline expiries are counted apart
        self.draining = False
        self._cancelled = 0
        self._deadline_misses = 0
        # the dispatched, not yet collected tick, and the tokens an early
        # collect (from preempt, cancel, begin_drain) took, delivered by
        # the next collect_tick
        self._pending_tick: Optional[TickHandle] = None
        self._collected: List[Tuple[int, int]] = []
        #: ``on_retire(rid, outcome)``, called as a request leaves for good:
        #: ``"complete"``, ``"cancelled"`` or ``"deadline"``
        self.on_retire: Optional[Callable[[int, str], None]] = None

    # ---- API ----

    def warmup(self, background: bool = True):
        """Capture every program this scheduler can run
        (``compilecache.serving_registry``) before traffic. The registry's
        priority-0 programs (the decode tick, the smallest prefill bucket)
        run inert, then are captured, now; with ``background=True`` the
        other buckets are captured at their first use or by the runner's
        ``wait()``, which the serving thread calls between steps. ``background=False`` prepares everything now,
        each run inert first: no request is cold. Returns the
        ``compilecache.WarmupRunner`` (``records``, ``summary()``)."""
        from pytorch_distributed_tpu_torch.compilecache import WarmupRunner, serving_registry

        return WarmupRunner(serving_registry(self.engine)).run(background=background)

    def submit(self, prompt, max_new_tokens: int, *,
               rid: Optional[int] = None, deadline_s: Optional[float] = None,
               deadline: Optional[float] = None) -> int:
        """Enqueue one request; returns its id. Raises for a request that
        can never fit ``max_seq_len``, and while draining. ``deadline_s``
        (seconds from now) or ``deadline`` (an absolute
        ``time.perf_counter()`` instant) arms its expiry: the sweep at the
        top of each dispatch cancels it with outcome ``"deadline"``,
        whatever its state."""
        if self.draining:
            raise RuntimeError("this scheduler is draining: submit elsewhere")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        l = len(prompt)
        if l < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        c = self.engine.chunk
        padded = -(-l // c) * c
        if padded > self.config.max_seq_len:
            raise ValueError(
                f"prompt ({l}) padded to {padded} exceeds max_seq_len "
                f"{self.config.max_seq_len}")
        if l + max_new_tokens > self.config.max_seq_len:
            raise ValueError(
                f"prompt ({l}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_seq_len {self.config.max_seq_len}")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        now = time.perf_counter()
        if deadline is None:
            deadline = now + deadline_s if deadline_s is not None else float("inf")
        self.queue.append(Request(
            rid=rid, tokens=prompt, max_new_tokens=max_new_tokens,
            submit_step=self._step_count, submit_time=now,
            generated=[] if self.offload else None, deadline=deadline,
        ))
        return rid

    def _free_slots(self) -> List[int]:
        # a slot whose chain is mid swap-out is not free until it finishes
        return [s for s in range(self.n_slots)
                if s not in self.resident and s not in self._swap_slots]

    def _place(self, req: Request, slot: int, hit) -> None:
        """Make ``req`` resident in ``slot`` to be prefilled from its prefix
        hit's frontier (or 0); its decode lane is armed after the last
        chunk."""
        req.slot = slot
        req.prefill_done = hit.covered if hit is not None else 0
        self.resident[slot] = req
        self.positions[slot] = 0
        self.remaining[slot] = 0
        self._admitted_prefill_tokens += req.length - req.prefill_done
        if hit is not None:
            self._prefix_covered_tokens += hit.covered

    def _admit_chain(self, slot: int, tokens: np.ndarray, max_new: int):
        """``(ok, hit)``: the slot's chain through the prefix index when it
        is on, else a plain admission."""
        if self.prefix_cache:
            hit = self.engine.admit_shared(slot, tokens, max_new)
            return hit is not None, hit
        return self.engine.admit(slot, len(tokens), max_new), None

    def _admit(self) -> None:
        """Admit up to ``admit_per_step`` queue-head requests; the first
        that cannot get a slot or a chain stops admission this step.
        Nothing is admitted while draining."""
        if self.draining:
            return
        free = self._free_slots()
        admitted = 0
        now = time.perf_counter()
        while self.queue and free and admitted < self.admit_per_step:
            req = self.queue[0]
            slot = free[0]
            ok, hit = self._admit_chain(slot, req.tokens, req.max_new_tokens)
            if not ok:
                # pool OOM: the request stays queued. Under preempt_on_oom
                # one victim is preempted per stuck queue head: restores go
                # before admissions, so preempting every step would only
                # carousel chains through the host store.
                if (self.preempt_on_oom and not self.parked and not self._swapping
                        and self._oom_preempted_for != req.rid):
                    if self.preempt_lru(reason="admission-oom") is not None:
                        self._oom_preempted_for = req.rid
                break
            self.queue.popleft()
            free.pop(0)
            req.admit_time = now
            self._place(req, slot, hit)
            self._admitted += 1
            self._adm_latency_steps += self._step_count - req.submit_step
            self._adm_latency_s += now - req.submit_time
            self.queue_wait.observe(now - req.submit_time)
            admitted += 1

    # ---- the pressure tier: preempt, park, restore ----

    def _victims(self) -> List[Tuple[float, int, int]]:
        """``(last token time, rid, slot)`` of the preemptible requests,
        least recently served first: decoding, not mid swap-out, and out
        of their post-restore protection."""
        if not self.offload:
            return []
        out = []
        for slot, req in self.resident.items():
            if req.prefill_done < req.length or slot in self._swap_slots:
                continue
            if self._step_count < req.protect_until:
                continue
            last = req.last_token_time
            out.append((req.admit_time if math.isnan(last) else last, req.rid, slot))
        out.sort()
        return out

    def _swap_decision(self, req: Request, slot: int) -> Optional[SwapDecision]:
        """Swap or recompute for this request: the chain's bytes over the
        measured link against the resume prefill's chunks times the mean
        measured chunk wall, then the hard limits (a resume prefill that
        overflows the table must swap; a full host store must recompute).
        None when neither is possible."""
        bytes_to_move = self.engine.chain_bytes(len(self.engine.allocator.chain(slot)))
        seq_len = req.length + len(req.generated or ())
        c = self.engine.chunk
        chunk_wall = self._chunk_wall_s / self._chunk_calls if self._chunk_calls else None
        decision = swap_vs_recompute(bytes_to_move, chunks=-(-seq_len // c),
                                     chunk_wall_s=chunk_wall)
        if self.swap_policy != "auto":
            decision = dataclasses.replace(decision, choice=self.swap_policy,
                                           reason=f"forced-{self.swap_policy}")
        need = self.engine.blocks_for(seq_len, req.max_new_tokens - req.produced)
        can_recompute = (-(-seq_len // c) * c <= self.config.max_seq_len
                         and need <= min(self.engine.table_width,
                                         self.engine.allocator.n_blocks - 1))
        if decision.choice == "recompute" and not can_recompute:
            decision = dataclasses.replace(decision, choice="swap",
                                           reason="recompute-overflows-table")
        elif decision.choice == "swap" and not self.host_store.has_room(bytes_to_move):
            if not can_recompute:
                return None
            decision = dataclasses.replace(decision, choice="recompute",
                                           reason="host-store-full")
        return decision

    def preempt_lru(self, reason: str = "pressure") -> Optional[int]:
        """Preempt the least recently served preemptible request; its rid,
        or None when nothing is preemptible."""
        # a tick in flight may be decoding the victim: collect it first
        self._collect_pending_tick()
        for _, rid, _slot in self._victims():
            if self.preempt(rid, reason=reason) is not None:
                return rid
        return None

    def preempt(self, rid: int, reason: str = "pressure") -> Optional[SwapDecision]:
        """Park decoding request ``rid``: swap its chain out (freed when
        the copy commits, at the next step) or drop it to be recomputed.
        Either way its lane stops now, and it is restored, before its next
        decode, once there is room. ``reason`` (the JAX signature's) would
        label the preemption in the flight recorder and the request trace,
        which are not ported. Returns the decision, None when the request
        cannot be preempted now."""
        self._collect_pending_tick()
        slot = next((s for s, r in self.resident.items() if r.rid == rid), None)
        if slot is None:
            raise ValueError(f"rid {rid} is not resident")
        req = self.resident[slot]
        if req.prefill_done < req.length:
            raise ValueError(f"rid {rid} is mid-prefill: not preemptible")
        decision = self._swap_decision(req, slot)
        if decision is None:
            return None
        del self.resident[slot]
        self.remaining[slot] = 0
        if decision.choice == "recompute":
            self.engine.release(slot)
            self.parked[rid] = (req, "recompute")
            self._decision_recompute += 1
        else:
            req.resume_position = int(self.positions[slot])
            pending = self.engine.swap_out_begin(slot)
            self._swap_slots.add(slot)
            self._swapping.append((rid, req, pending, time.perf_counter(), decision))
            self._decision_swap += 1
        req.preempts += 1
        self._preempts += 1
        return decision

    def _finalize_swaps(self) -> None:
        """Close every open swap-out window: wait for the copy, commit the
        host chain, free the device chain. A store that refuses the chain
        reverts the preemption: the chain never left, so the lane is armed
        again."""
        pending, self._swapping = self._swapping, []
        for rid, req, pend, t0, _decision in pending:
            slot = pend.slot
            self._swap_slots.discard(slot)
            try:
                chain = self.engine.swap_out_finish(pend, self.host_store, rid)
            except OSError:
                self.resident[slot] = req
                self.remaining[slot] = req.max_new_tokens - req.produced
                self._swap_aborts += 1
                continue
            self.parked[rid] = (req, "swap")
            self._swap_outs += 1
            self._swap_bytes += chain.nbytes
            self.swap_lat.observe(time.perf_counter() - t0)

    def _restore_parked(self) -> None:
        """Restore parked requests in preemption order, before this step's
        admissions. Swap: a fresh chain filled from host RAM, the lane armed
        at its position with its logits row. Recompute: the streamed
        tokens join the prompt and the request is prefilled again, whose
        last chunk writes the same logits row. A restore that cannot
        proceed (no slot, no chain, a failed host-to-device copy) leaves
        the request parked for the next step."""
        for rid in list(self.parked):
            req, path = self.parked[rid]
            free = self._free_slots()
            if not free:
                break
            slot = free[0]
            if path == "swap":
                t0 = time.perf_counter()
                chain = self.host_store.get(rid)
                try:
                    restored = self.engine.swap_in_chain(slot, chain)
                except OSError:
                    # the engine freed the fresh chain; the host copy is intact
                    self._swap_aborts += 1
                    break
                if not restored:
                    break  # no room yet
                self.host_store.pop(rid)
                self._swap_ins += 1
                self._swap_bytes += chain.nbytes
                self.swap_lat.observe(time.perf_counter() - t0)
                req.slot = slot
                self.resident[slot] = req
                self.positions[slot] = req.resume_position
                self.remaining[slot] = req.max_new_tokens - req.produced
            else:
                seq = req.tokens
                if req.generated:
                    seq = np.concatenate([req.tokens, np.asarray(req.generated, np.int32)])
                ok, hit = self._admit_chain(slot, seq, req.max_new_tokens - req.produced)
                if not ok:
                    break
                req.tokens = seq
                req.generated = []
                self._place(req, slot, hit)
            del self.parked[rid]
            req.protect_until = self._step_count + self.protect_ticks
            self._restores += 1

    # ---- the tick ----

    def _chunk_jobs(self) -> List[ChunkJob]:
        c = self.engine.chunk
        jobs = []
        for slot, req in sorted(self.resident.items()):
            if req.prefill_done >= req.length:
                continue
            start = req.prefill_done
            seg = req.tokens[start:start + c]
            tokens = np.zeros((c,), np.int32)
            tokens[:len(seg)] = seg
            is_last = start + c >= req.length
            jobs.append(ChunkJob(
                slot=slot, tokens=tokens, start=start, is_last=is_last,
                last_idx=(req.length - 1 - start) if is_last else 0,
            ))
        return jobs

    def dispatch_tick(self) -> None:
        """The first half of a tick: the deadline sweep, finished
        swap-outs and restores (under offload), admissions, one prefill
        chunk for every unfinished prompt, and the decode tick launched
        for every armed lane, not waited for. Leaves the tick pending for
        ``collect_tick``; raises if one is pending already."""
        if self._pending_tick is not None:
            raise RuntimeError("collect_tick() must collect the pending tick before "
                               "another dispatch (one tick in flight)")
        # before any tick work: a fault here leaves the state the last
        # collect left
        fault_point("serve.dispatch")
        if self._start_time is None:
            self._start_time = time.perf_counter()
        t0 = time.perf_counter()
        self._expire_deadlines()
        if self.offload:
            self._finalize_swaps()
            self._restore_parked()
        self._admit()
        jobs = self._chunk_jobs()
        if jobs:
            cold_bucket = not self.engine.has_chunk_program(*self.engine.bucket_for(jobs))
            if cold_bucket:  # this call captures the bucket's program
                for j in jobs:
                    self.resident[j.slot].cold = True
            wall = self.engine.run_chunks(jobs)
            if not cold_bucket:  # a cold call's wall is the capture's: not a sample
                self._chunk_calls += 1
                self._chunk_wall_s += wall
            for j in jobs:
                req = self.resident[j.slot]
                req.prefill_done += self.engine.chunk
                if self.prefix_cache:
                    # index the full prompt blocks this chunk completed, so
                    # a same-prefix request later in this burst hits now
                    self.engine.prefix_insert(j.slot, req.tokens,
                                              upto=min(req.prefill_done, req.length))
                if req.prefill_done >= req.length:
                    # arm the decode lane at the prompt's true frontier; after
                    # a recompute restore only the rest of the budget is left
                    self.positions[j.slot] = req.length
                    self.remaining[j.slot] = req.max_new_tokens - req.produced
        active = self.remaining > 0
        self._occupancy_sum += len(self.resident) / self.n_slots
        self._step_count += 1
        if not active.any():
            # only prefill ran: its host effects are applied above, and its
            # device work is queued on the stream every later program, copy
            # and swap runs on. The next dispatch may restage the chunk
            # programs at once: PagedEngine._stage waits for a program's
            # last upload before writing its pinned inputs again, and a
            # graph replay reads the device vector that upload fills, as
            # the eager body does.
            self._pending_tick = TickHandle(None, None, (), t0, False)
            return
        lanes = tuple(int(s) for s in np.nonzero(active)[0])
        cold_decode = not self.engine.has_decode_program
        if cold_decode:  # this tick captures it
            for slot in lanes:
                self.resident[slot].cold = True
        tokens, positions = self.engine.decode_launch(self.positions, active)
        self._pending_tick = TickHandle(tokens, positions, lanes, t0, cold_decode)

    def collect_tick(self) -> List[Tuple[int, int]]:
        """The second half: wait for the pending tick's tokens and do the
        per-token work (latencies, retirement). Returns ``[(rid, token)]``,
        the tokens an early collect kept first. Without a pending tick it
        returns only those."""
        fault_point("serve.collect")
        self._collect_pending_tick()
        out, self._collected = self._collected, []
        return out

    @property
    def has_uncollected(self) -> bool:
        """A tick with decode lanes is in flight, or collected tokens wait
        for delivery: a driver keeps collecting while this holds."""
        h = self._pending_tick
        return bool(self._collected) or (h is not None and h.tokens is not None)

    def _collect_pending_tick(self) -> None:
        h = self._pending_tick
        if h is None:
            return
        self._pending_tick = None
        if h.tokens is None:
            return
        tokens, positions = self.engine.decode_collect(h.tokens, h.positions)
        lanes = np.asarray(h.lanes, np.int64)
        # only the lanes this tick decoded: a row armed since (a restore)
        # keeps its own position
        self.positions[lanes] = positions[lanes]
        now = time.perf_counter()  # tokens are on the host: delivery time
        self._process_collected(h, tokens, now)

    def _process_collected(self, h: TickHandle, tokens: np.ndarray, now: float) -> None:
        """Per-token work of one collected tick: latencies, the stream,
        retirement (the chain freed at once)."""
        out: List[Tuple[int, int]] = []
        for slot in h.lanes:
            req = self.resident[slot]
            token = int(tokens[slot])
            out.append((req.rid, token))
            if req.produced == 0:
                req.first_token_time = now
                self.ttft.observe(now - req.submit_time)
                if not req.cold:
                    self.ttft_warm.observe(now - req.submit_time)
            else:
                gap = now - req.last_token_time
                req.token_gaps.append(gap)
                self.token_lat.observe(gap)
            req.last_token_time = now
            req.produced += 1
            if req.generated is not None:
                req.generated.append(token)
            self._tokens_out += 1
            if ((self.eos_id is not None and token == self.eos_id)
                    or req.produced >= req.max_new_tokens):
                self.remaining[slot] = 0
                del self.resident[slot]
                self.engine.release(slot)
                self._completed += 1
                self._cold_requests += req.cold
                if self.on_retire is not None:
                    self.on_retire(req.rid, "complete")
            else:
                self.remaining[slot] -= 1
        if out:
            self.tick_lat.observe(now - h.t_step0)
        self._collected.extend(out)

    def step(self) -> List[Tuple[int, int]]:
        """One synchronous tick: a pending tick collected, then dispatch
        and collect. Returns ``[(rid, token)]``."""
        out = self.collect_tick()
        self.dispatch_tick()
        return out + self.collect_tick()

    @property
    def idle(self) -> bool:
        """Nothing queued, resident, parked or mid swap-out."""
        return (not self.queue and not self.resident and not self.parked
                and not self._swapping)

    def stuck_rids(self) -> Dict[str, List[int]]:
        """Every live rid by state (``queued``, ``prefill``, ``decoding``,
        ``parked``, ``swapping``); empty when idle."""
        out: Dict[str, List[int]] = {}
        if self.queue:
            out["queued"] = [r.rid for r in self.queue]
        prefill, decoding = [], []
        for req in self.resident.values():
            (prefill if req.prefill_done < req.length else decoding).append(req.rid)
        if prefill:
            out["prefill"] = sorted(prefill)
        if decoding:
            out["decoding"] = sorted(decoding)
        if self.parked:
            out["parked"] = sorted(self.parked)
        if self._swapping:
            out["swapping"] = sorted(e[0] for e in self._swapping)
        return out

    def drain(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Step until idle; returns ``{rid: [tokens]}``."""
        produced: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            if self.idle:
                return produced
            for rid, tok in self.step():
                produced.setdefault(rid, []).append(tok)
        raise RuntimeError(f"drain did not converge within {max_steps} steps; "
                           f"stuck rids by state: {self.stuck_rids()}")

    # ---- the lifecycle: drain, cancel, deadlines, abandon ----

    def begin_drain(self) -> None:
        """Stop admitting: ``submit`` raises and no dispatch admits. The
        pending tick is collected (its tokens kept for the next
        ``collect_tick``) and open swap-out windows are closed (committed
        or reverted), so what follows starts from settled state."""
        self._collect_pending_tick()
        if self.offload:
            self._finalize_swaps()
        self.draining = True

    def drain_graceful(self, max_steps: int = 100_000
                       ) -> Tuple[Dict[int, List[int]], List[Request]]:
        """``begin_drain``, then run every admitted request (parked ones
        included) to retirement. Returns ``(produced, requeued)``: their
        tokens, and the queued requests, never admitted, for the caller
        to submit elsewhere. Every pool block is free afterwards."""
        self.begin_drain()
        requeued = list(self.queue)
        self.queue.clear()
        produced: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            if not self.resident and not self.parked and not self._swapping:
                return produced, requeued
            for rid, tok in self.step():
                produced.setdefault(rid, []).append(tok)
        raise RuntimeError(f"drain_graceful did not converge within {max_steps} steps; "
                           f"stuck rids by state: {self.stuck_rids()}")

    def cancel(self, rid: int, outcome: str = "cancelled") -> bool:
        """Abort request ``rid`` wherever it is (queued, mid-prefill,
        decoding, parked on either path, mid swap-out), freeing its slot,
        its device chain and its host copy. True when found; False when
        it already left or never was (cancelling is idempotent). The
        deadline sweep passes ``outcome="deadline"``."""
        # a tick in flight may be decoding it: collect first, so no release
        # happens under a launched tick and its tokens are kept
        self._collect_pending_tick()
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                self._finish_cancel(req, outcome)
                return True
        if any(entry[0] == rid for entry in self._swapping):
            # close the window first: the chain commits (cancel the host
            # copy below) or reverts (release it below), never freed mid-copy
            self._finalize_swaps()
        if rid in self.parked:
            req, path = self.parked.pop(rid)
            if path == "swap":
                self.host_store.pop(rid)
            self._finish_cancel(req, outcome)
            return True
        slot = next((s for s, r in self.resident.items() if r.rid == rid), None)
        if slot is None:
            return False
        req = self.resident.pop(slot)
        self.remaining[slot] = 0
        self.engine.release(slot)
        self._finish_cancel(req, outcome)
        return True

    def _expire_deadlines(self) -> None:
        """Cancel every live request whose deadline has passed, before the
        restores and admissions, so an expired request takes no slot."""
        now = time.perf_counter()
        expired = [req.rid
                   for bucket in (self.queue, self.resident.values(),
                                  (r for r, _ in self.parked.values()),
                                  (entry[1] for entry in self._swapping))
                   for req in bucket if req.deadline <= now]
        for rid in expired:
            self.cancel(rid, outcome="deadline")

    def _finish_cancel(self, req: Request, outcome: str) -> None:
        if outcome == "deadline":
            self._deadline_misses += 1
        else:
            self._cancelled += 1
        if self.on_retire is not None:
            self.on_retire(req.rid, outcome)

    def harvest_requests(self) -> List[Request]:
        """Every live request (queued, resident, parked, mid swap-out) in
        rid order: what a caller tearing this scheduler down resubmits
        elsewhere. Reads only."""
        reqs: Dict[int, Request] = {}
        for req in self.queue:
            reqs[req.rid] = req
        for req in self.resident.values():
            reqs[req.rid] = req
        for rid, (req, _path) in self.parked.items():
            reqs[rid] = req
        for entry in self._swapping:
            reqs[entry[0]] = entry[1]
        return [reqs[rid] for rid in sorted(reqs)]

    def abandon(self) -> None:
        """Tear this scheduler down for good: a tick in flight is dropped
        uncollected (its tokens are lost, never its blocks), open swap-out
        windows close without committing, and every device chain, host
        copy and queue entry goes. ``submit`` raises afterwards."""
        self._pending_tick = None
        self._collected.clear()
        self.draining = True
        for entry in self._swapping:
            slot = entry[2].slot
            self.engine.allocator.clear_state(slot)
            self._swap_slots.discard(slot)
            self.engine.release(slot)
        self._swapping.clear()
        for rid, (_req, path) in self.parked.items():
            if path == "swap":
                self.host_store.pop(rid)
        self.parked.clear()
        for slot in list(self.resident):
            del self.resident[slot]
            self.engine.release(slot)
        self.queue.clear()
        self.positions[:] = 0
        self.remaining[:] = 0

    def live_requests(self) -> int:
        """Requests this scheduler holds: queued, resident, parked, mid
        swap-out."""
        return (len(self.queue) + len(self.resident) + len(self.parked)
                + len(self._swapping))

    def metrics(self) -> dict:
        """Exact host-side accounting; no device sync."""
        alloc_blocks = self.engine.allocator.in_use
        alloc_tokens = alloc_blocks * self.engine.block_len
        used_tokens = int(sum(min(r.prefill_done, r.length) + r.produced
                              for r in self.resident.values()))
        elapsed = (time.perf_counter() - self._start_time
                   if self._start_time is not None else 0.0)
        return {
            "steps": self._step_count,
            "queue_depth": len(self.queue),
            "occupancy": len(self.resident) / self.n_slots,
            "occupancy_mean": (self._occupancy_sum / self._step_count
                               if self._step_count else 0.0),
            "pool_blocks": self.engine.allocator.n_blocks,
            "pool_blocks_in_use": alloc_blocks,
            "pool_frac_in_use": alloc_blocks / (self.engine.allocator.n_blocks - 1),
            "padding_waste_frac": (1.0 - used_tokens / alloc_tokens
                                   if alloc_tokens else 0.0),
            "kv_dtype": self.engine.kv_dtype,
            "draining": self.draining,
            "admitted": self._admitted,
            "completed": self._completed,
            "cancelled": self._cancelled,
            "deadline_misses": self._deadline_misses,
            "tokens_out": self._tokens_out,
            "tokens_per_s": self._tokens_out / elapsed if elapsed else 0.0,
            "admission_latency_steps_mean": (
                self._adm_latency_steps / self._admitted if self._admitted else 0.0),
            "admission_latency_s_mean": (
                self._adm_latency_s / self._admitted if self._admitted else 0.0),
            "offload": self.offload,
            "preemptible": len(self._victims()),
            "parked": len(self.parked),
            "preempts": self._preempts,
            "restores": self._restores,
            "swap_outs": self._swap_outs,
            "swap_ins": self._swap_ins,
            "swap_aborts": self._swap_aborts,
            "swap_bytes": self._swap_bytes,
            "decision_swap": self._decision_swap,
            "decision_recompute": self._decision_recompute,
            "host_store_bytes": self.host_store.bytes_used,
            # retired requests that rode a capture; the capture seconds,
            # warmup's included
            "cold_requests": self._cold_requests,
            "compile_s": self.engine.capture_s,
            "cuda_graphs": self.engine.cuda_graphs,
            "graphs": self.engine.captures,
            **self.engine.prefix_metrics(),
            "prefix_covered_tokens": self._prefix_covered_tokens,
            "admitted_prefill_tokens": self._admitted_prefill_tokens,
            **self.swap_lat.summary("swap"),
            **self.ttft.summary("ttft"),
            **self.ttft_warm.summary("ttft_warm"),
            **self.token_lat.summary("token_lat"),
            **self.queue_wait.summary("queue_wait"),
            **self.tick_lat.summary("tick"),
        }
