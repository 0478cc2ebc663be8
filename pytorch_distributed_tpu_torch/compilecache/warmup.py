"""The warmup runtime: capture a registry's programs before they stall
(``pytorch_distributed_tpu/compilecache/warmup.py``).

``WarmupRunner`` walks a ``ProgramRegistry`` in priority order and makes
each program ready through its ``warm`` thunk:

- **priority 0** specs (the decode tick, the smallest prefill bucket) in
  the foreground, with ``execute=True``: each runs once with inert
  inputs, then its CUDA graph is captured, so the first real request
  pays nothing;
- with ``background=True`` the remaining specs wait in the runner. A CUDA
  graph is captured only on the serving thread (the caching allocator
  and the kernels' launch counters are not safe for a second one), so
  where the JAX package compiles them on a thread, each is captured
  here at its first use by traffic, or by ``wait()``, which the serving
  thread calls between steps (``execute=False``: captured without the
  inert run). Each is still recorded with ``background: True``.

Every program appends one record: ``program``, ``seconds`` (the whole
warm), ``backend_compile_s`` (the capture's own seconds),
``cache_hit`` (always False: there is no persistent cache of graphs),
``fingerprint``, ``priority``, ``background``. The JSONL manifest, the
span tracer and the goodput ledger of the JAX runner are not ported.
"""

from __future__ import annotations

import time
from collections import deque
from typing import List, Optional

from pytorch_distributed_tpu_torch.compilecache.registry import (
    ProgramRegistry,
    ProgramSpec,
)


class WarmupRunner:
    """Drives one registry through capture; reusable stats object."""

    def __init__(self, registry: ProgramRegistry, *, manifest=None):
        if manifest is not None:
            raise NotImplementedError("the warmup manifest (a MetricsLogger) is not ported")
        self.registry = registry
        self.records: List[dict] = []
        self._pending: deque = deque()

    def run(self, background: bool = True) -> "WarmupRunner":
        """Warm everything of priority <= 0 now, executed inert first;
        with ``background=False`` everything else too, else leave the
        rest to first use or ``wait()``."""
        specs = sorted(self.registry, key=lambda s: s.priority)
        if background:
            fg = [s for s in specs if s.priority <= 0]
            self._pending.extend(s for s in specs if s.priority > 0)
        else:
            fg = specs
        for spec in fg:
            self._warm_one(spec, execute=True, foreground=True)
        return self

    def wait(self, timeout: Optional[float] = None) -> None:
        """Capture the programs left by ``run(background=True)``, in
        priority order, on the calling (serving) thread, between steps.
        With ``timeout``, start no capture once that many seconds have
        passed, so a serving loop can spend a bounded slice of each gap."""
        t0 = time.perf_counter()
        while self._pending:
            if timeout is not None and time.perf_counter() - t0 >= timeout:
                return
            self._warm_one(self._pending.popleft(), execute=False, foreground=False)

    def _warm_one(self, spec: ProgramSpec, *, execute: bool, foreground: bool) -> None:
        t0 = time.perf_counter()
        capture_s = spec.warm(execute) or 0.0
        seconds = time.perf_counter() - t0
        self.records.append({
            "program": spec.name,
            "seconds": round(seconds, 6),
            "backend_compile_s": round(min(capture_s, seconds), 6),
            "cache_hit": False,
            "fingerprint": self.registry.fingerprint,
            "priority": spec.priority,
            "background": not foreground,
        })

    def summary(self) -> dict:
        """Aggregate over the records so far (call ``wait()`` first for
        the complete picture)."""
        records = self.records
        return {
            "programs": len(records),
            "cache_hits": sum(1 for r in records if r["cache_hit"]),
            "fresh": sum(1 for r in records if not r["cache_hit"]),
            "total_s": round(sum(r["seconds"] for r in records), 6),
            "backend_compile_s": round(sum(r["backend_compile_s"] for r in records), 6),
            "fingerprint": self.registry.fingerprint,
        }
