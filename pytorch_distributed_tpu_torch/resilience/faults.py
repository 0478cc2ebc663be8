"""Deterministic fault injection (``pytorch_distributed_tpu/resilience/faults.py``).

A ``FaultPlan`` is a list of ``FaultSpec`` entries keyed by ``(site,
occurrence)``: each named site counts its own calls, and a spec fires on
occurrences ``[at, at + times)`` of its site. No clock, no RNG: the n-th
call to a site fails the same way in every run, and one plan file drives
a JAX child and a port child alike (same JSON, same windows).

The sites of the port so far:

====================  =====================================================
``data.fetch``        ``data/loader.py`` ``_fetch``: a batch read, under the
                      loader's bounded retry
``ckpt.shard_write``  ``utils/checkpoint.py``: the shard's tmp file is
                      written, not yet published by its rename
``ckpt.pre_commit``   just before rank 0's atomic manifest replace (the
                      commit point): data files landed, manifest not
``ckpt.post_commit``  just after it: the new checkpoint is live, the
                      stale shard files not yet removed
``train.step``        the trainers' loop, once a step before the step runs
``serve.dispatch``    ``serving/scheduler.py`` ``dispatch_tick``, before any
                      tick work
``serve.collect``     ``collect_tick``, before the pending tick is collected
``kv.swap_out_d2h``   ``serving/engine.py`` ``swap_out_finish``, before the
                      wait for the chain's copy to the host (the swap-out
                      reverts: the chain stays resident)
``kv.host_write``     the same, before the commit to the host store
``kv.swap_in_h2d``    ``swap_in_chain``, before any write to the card (the
                      fresh chain is freed; the request stays parked)
``serve.handoff_export``
                      ``serving/engine.py`` ``export_chain``, before the
                      prefill replica's chain is read out (the fleet
                      router counts a failure of the source replica)
``serve.handoff_import``
                      ``import_chain``, before any block is allocated on
                      the decode replica (a failure of the target; the
                      source chain stays intact and exportable again)
====================  =====================================================

Kinds: ``raise`` (``InjectedFault``, an ``OSError``, so the bounded retry
takes it for a transient I/O error), ``kill`` (``SIGKILL`` of this
process: no ``finally``, no ``atexit``), ``hang`` (sleep ``seconds``),
and the directives ``nan`` (the trainer NaN-fills the step's batch,
``poison_batch``) and ``suspend`` (the trainer latches its watcher), which
``fault_point`` returns to its caller.

Configuration: ``install_plan(plan)`` in-process, or ``PDT_FAULT_PLAN``,
inline JSON or ``@/path/to/plan.json``::

    {"faults": [{"site": "ckpt.shard_write", "kind": "kill", "at": 2},
                {"site": "train.step", "kind": "nan", "at": 1, "times": 2},
                {"site": "data.fetch", "kind": "raise", "at": 1, "times": 2}]}

Without a plan ``fault_point`` returns None after one attribute check.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger("pytorch_distributed_tpu_torch")

ENV_PLAN = "PDT_FAULT_PLAN"

_KINDS = ("raise", "kill", "hang", "nan", "suspend")
# kinds fault_point returns for the caller to act on
_DIRECTIVES = ("nan", "suspend")


class InjectedFault(OSError):
    """A fault of the injection plane: an ``OSError``, so the bounded retry
    treats it as the transient I/O error it stands in for."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    site: str
    kind: str
    at: int = 0           # first occurrence (0-based call count of the site)
    times: int = 1        # fires on occurrences [at, at + times)
    seconds: float = 0.0  # hang duration

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; known: {_KINDS}")
        if self.at < 0 or self.times < 1:
            raise ValueError(f"need at >= 0 and times >= 1, got at={self.at} "
                             f"times={self.times}")

    def matches(self, occurrence: int) -> bool:
        return self.at <= occurrence < self.at + self.times


class FaultPlan:
    """The specs, each site's occurrence count and ``fired``: the
    ``(site, occurrence, kind)`` of every fault that fired."""

    def __init__(self, specs: List[FaultSpec]):
        self.specs = list(specs)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.fired: List[tuple] = []

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        return cls([FaultSpec(**spec) for spec in data.get("faults", [])])

    @classmethod
    def from_env(cls, env: str = ENV_PLAN) -> Optional["FaultPlan"]:
        value = os.environ.get(env, "").strip()
        if not value:
            return None
        if value.startswith("@"):
            with open(value[1:]) as f:
                value = f.read()
        return cls.from_json(value)

    def to_json(self) -> str:
        return json.dumps({"faults": [dataclasses.asdict(s) for s in self.specs]})

    def tick(self, site: str) -> Optional[FaultSpec]:
        """Count one occurrence of ``site``; the spec that matches it, if
        any. Thread-safe: shard writes run on a writer thread."""
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            for spec in self.specs:
                if spec.site == site and spec.matches(n):
                    self.fired.append((site, n, spec.kind))
                    return spec
        return None


# the process's plan; None once the environment was read means no injection
_plan: Optional[FaultPlan] = None
_env_checked = False


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or clear, with None) the process's plan; it overrides the
    environment. Returns it."""
    global _plan, _env_checked
    _plan = plan
    _env_checked = True
    return plan


def clear_plan() -> None:
    """No plan, and ``PDT_FAULT_PLAN`` is read again at the next site."""
    global _plan, _env_checked
    _plan = None
    _env_checked = False


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, reading ``PDT_FAULT_PLAN`` once."""
    global _plan, _env_checked
    if not _env_checked:
        _env_checked = True
        _plan = FaultPlan.from_env()
        if _plan is not None:
            logger.warning("fault injection active from $%s: %d spec(s)", ENV_PLAN,
                           len(_plan.specs))
    return _plan


def fault_point(site: str) -> Optional[FaultSpec]:
    """The hook: runs ``raise``/``kill``/``hang`` itself, returns a
    directive (``nan``, ``suspend``) to the caller, None when nothing
    fires."""
    plan = active_plan()
    if plan is None:
        return None
    spec = plan.tick(site)
    if spec is None:
        return None
    if spec.kind == "raise":
        raise InjectedFault(f"injected fault at {site} (at={spec.at})")
    if spec.kind == "kill":
        logger.warning("injected SIGKILL at %s", site)
        logging.shutdown()
        os.kill(os.getpid(), signal.SIGKILL)
    if spec.kind == "hang":
        logger.warning("injected %.1fs hang at %s", spec.seconds, site)
        time.sleep(spec.seconds)
        return None
    logger.warning("injected %s directive at %s", spec.kind, site)
    return spec


def poison_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The ``nan`` directive's batch: every floating tensor or array
    NaN-filled (images, LM loss weights), integer ones (labels, tokens)
    as they are. Raises when there is no floating field to fill."""
    out, poisoned = {}, False
    for k, x in batch.items():
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            out[k], poisoned = torch.full_like(x, float("nan")), True
        elif isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
            out[k], poisoned = np.full_like(x, np.nan), True
        else:
            out[k] = x
    if not poisoned:
        raise ValueError("poison_batch found no float field to NaN-fill; the nan fault "
                         "needs one in the batch (images or LM loss weights)")
    return out
