"""Continuous scheduler over the paged engine
(``pytorch_distributed_tpu/serving/scheduler.py``, its core).

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

Metrics are exact host-side counters and latency series. Offload,
preemption, prefix sharing, tracing, the fleet hooks, deadlines and
cancel are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.serving.engine import ChunkJob, PagedEngine
from pytorch_distributed_tpu_torch.telemetry.latency import LatencySeries


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray  # [L] int32 prompt
    max_new_tokens: int
    submit_step: int
    submit_time: float
    slot: int = -1  # -1 while queued
    prefill_done: int = 0  # prompt tokens prefilled so far (chunk multiple)
    produced: int = 0
    first_token_time: float = float("nan")
    last_token_time: float = float("nan")
    # inter-token gaps after the first token
    token_gaps: List[float] = dataclasses.field(default_factory=list)

    @property
    def length(self) -> int:
        return int(len(self.tokens))


class Scheduler:
    """``submit`` enqueues, ``step`` advances the system one tick and
    returns ``[(rid, token)]`` for the tokens it produced, ``drain`` runs
    to empty. Runs on CUDA unless ``device="cpu"`` is passed; raises
    without a card. ``seed`` seeds the sampling generator (unused when
    greedy)."""

    def __init__(self, config, params, n_slots: int, *,
                 n_blocks: Optional[int] = None, block_len: int = 16,
                 prefill_chunk: int = 64, admit_per_step: int = 4,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 seed: int = 0, eos_id: Optional[int] = None,
                 gather_impl: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 split_s: Optional[int] = None, device=None):
        if eos_id is not None and not 0 <= eos_id < config.vocab_size:
            raise ValueError(
                f"eos_id {eos_id} outside [0, vocab_size={config.vocab_size})")
        if admit_per_step < 1:
            raise ValueError(f"admit_per_step must be >= 1, got {admit_per_step}")
        self.engine = PagedEngine(
            config, params, n_slots, n_blocks=n_blocks, block_len=block_len,
            prefill_chunk=prefill_chunk, temperature=temperature, top_k=top_k,
            gather_impl=gather_impl, kv_dtype=kv_dtype, split_s=split_s,
            device=device,
        )
        # the engine may have replaced gather_impl/split_s into the config
        self.config = self.engine.config
        self.n_slots = n_slots
        self.admit_per_step = admit_per_step
        self.eos_id = eos_id
        self._generator = torch.Generator(device=self.engine.device)
        self._generator.manual_seed(seed)
        self._next_rid = 0
        self._step_count = 0
        self.queue: deque = deque()
        self.resident: Dict[int, Request] = {}  # slot -> request
        self.positions = np.zeros(n_slots, np.int64)
        self.remaining = np.zeros(n_slots, np.int64)
        self._tokens_out = 0
        self._completed = 0
        self._admitted = 0
        self._adm_latency_steps = 0
        self._adm_latency_s = 0.0
        self._occupancy_sum = 0.0
        self._start_time: Optional[float] = None
        self.ttft = LatencySeries("ttft")
        self.token_lat = LatencySeries("token_lat")
        self.queue_wait = LatencySeries("queue_wait")
        self.tick_lat = LatencySeries("tick")

    # ---- API ----

    def submit(self, prompt, max_new_tokens: int, *,
               rid: Optional[int] = None) -> int:
        """Enqueue one request; returns its id. Raises only for a request
        that can never fit ``max_seq_len``."""
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
        self.queue.append(Request(
            rid=rid, tokens=prompt, max_new_tokens=max_new_tokens,
            submit_step=self._step_count, submit_time=time.perf_counter(),
        ))
        return rid

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if s not in self.resident]

    def _admit(self) -> None:
        """Admit up to ``admit_per_step`` queue-head requests; the first
        that cannot get a slot or a chain stops admission this step."""
        free = self._free_slots()
        admitted = 0
        now = time.perf_counter()
        while self.queue and free and admitted < self.admit_per_step:
            req = self.queue[0]
            slot = free[0]
            if not self.engine.admit(slot, req.length, req.max_new_tokens):
                break  # pool OOM: stays queued until blocks free up
            self.queue.popleft()
            free.pop(0)
            req.slot = slot
            self.resident[slot] = req
            self.positions[slot] = 0
            self.remaining[slot] = 0  # decode-armed after the last chunk
            self._admitted += 1
            self._adm_latency_steps += self._step_count - req.submit_step
            self._adm_latency_s += now - req.submit_time
            self.queue_wait.observe(now - req.submit_time)
            admitted += 1

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

    def step(self) -> List[Tuple[int, int]]:
        """One tick: admissions, one prefill chunk for every unfinished
        prompt, one decode token for every armed lane, retirements."""
        if self._start_time is None:
            self._start_time = time.perf_counter()
        t0 = time.perf_counter()
        self._admit()
        jobs = self._chunk_jobs()
        if jobs:
            self.engine.run_chunks(jobs)
            for j in jobs:
                req = self.resident[j.slot]
                req.prefill_done += self.engine.chunk
                if req.prefill_done >= req.length:
                    # arm the decode lane at the prompt's true frontier
                    self.positions[j.slot] = req.length
                    self.remaining[j.slot] = req.max_new_tokens
        active = self.remaining > 0
        self._occupancy_sum += len(self.resident) / self.n_slots
        self._step_count += 1
        if not active.any():
            return []
        tokens, positions = self.engine.decode(self.positions, active,
                                               self._generator)
        lanes = np.nonzero(active)[0]
        self.positions[lanes] = positions[lanes]
        now = time.perf_counter()  # tokens are on the host: delivery time
        out: List[Tuple[int, int]] = []
        for slot in lanes.tolist():
            req = self.resident[slot]
            token = int(tokens[slot])
            out.append((req.rid, token))
            if req.produced == 0:
                req.first_token_time = now
                self.ttft.observe(now - req.submit_time)
            else:
                gap = now - req.last_token_time
                req.token_gaps.append(gap)
                self.token_lat.observe(gap)
            req.last_token_time = now
            req.produced += 1
            self._tokens_out += 1
            if ((self.eos_id is not None and token == self.eos_id)
                    or req.produced >= req.max_new_tokens):
                self.remaining[slot] = 0
                del self.resident[slot]
                self.engine.release(slot)
                self._completed += 1
            else:
                self.remaining[slot] -= 1
        self.tick_lat.observe(now - t0)
        return out

    @property
    def idle(self) -> bool:
        """Nothing queued and nothing resident."""
        return not self.queue and not self.resident

    def drain(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Step until idle; returns ``{rid: [tokens]}``."""
        produced: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            if self.idle:
                return produced
            for rid, tok in self.step():
                produced.setdefault(rid, []).append(tok)
        raise RuntimeError(
            f"drain did not converge within {max_steps} steps: "
            f"{len(self.queue)} queued, resident rids "
            f"{sorted(r.rid for r in self.resident.values())}")

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
            "pool_blocks_in_use": alloc_blocks,
            "pool_frac_in_use": alloc_blocks / (self.engine.allocator.n_blocks - 1),
            "padding_waste_frac": (1.0 - used_tokens / alloc_tokens
                                   if alloc_tokens else 0.0),
            "admitted": self._admitted,
            "completed": self._completed,
            "tokens_out": self._tokens_out,
            "tokens_per_s": self._tokens_out / elapsed if elapsed else 0.0,
            "admission_latency_steps_mean": (
                self._adm_latency_steps / self._admitted if self._admitted else 0.0),
            "admission_latency_s_mean": (
                self._adm_latency_s / self._admitted if self._admitted else 0.0),
            **self.ttft.summary("ttft"),
            **self.token_lat.summary("token_lat"),
            **self.queue_wait.summary("queue_wait"),
            **self.tick_lat.summary("tick"),
        }
