"""Bounded exponential-backoff retry with deterministic seeded jitter
(``pytorch_distributed_tpu/resilience/retry.py``, a copy).

Bounded: ``retries`` attempts under a ``max_delay`` cap, so a hard failure
surfaces instead of hanging. Deterministic: the delays come from
``random.Random(f"{seed}:{attempt}")``, never the global RNG or the clock,
so two runs of one fault plan retry on the same schedule. The checkpoint's
shard write uses it; an injected ``raise`` fault is an ``OSError``
(``resilience.faults.InjectedFault``), so it goes through the same path.
"""

from __future__ import annotations

import functools
import logging
import random
import time
from typing import Callable, Tuple, Type

logger = logging.getLogger("pytorch_distributed_tpu_torch")

DEFAULT_RETRIES = 3
DEFAULT_BASE_DELAY = 0.05
DEFAULT_MAX_DELAY = 2.0


def backoff_delays(retries: int = DEFAULT_RETRIES, base_delay: float = DEFAULT_BASE_DELAY,
                   max_delay: float = DEFAULT_MAX_DELAY, seed: int = 0) -> list:
    """``min(max_delay, base_delay · 2**k)`` scaled by a seeded jitter in
    [0.5, 1.0), for k = 0 .. retries − 1."""
    out = []
    for attempt in range(retries):
        cap = min(max_delay, base_delay * (2.0 ** attempt))
        jitter = 0.5 + random.Random(f"{seed}:{attempt}").random() / 2.0
        out.append(cap * jitter)
    return out


def retry_call(fn: Callable, *args, retries: int = DEFAULT_RETRIES,
               base_delay: float = DEFAULT_BASE_DELAY, max_delay: float = DEFAULT_MAX_DELAY,
               retry_on: Tuple[Type[BaseException], ...] = (OSError,),
               no_retry_on: Tuple[Type[BaseException], ...] = (), seed: int = 0,
               what: str = "", **kwargs):
    """``fn(*args, **kwargs)``, retried up to ``retries`` more times on
    ``retry_on`` (but not on ``no_retry_on``) with the ``backoff_delays``
    schedule; the last failure propagates unchanged."""
    delays = backoff_delays(retries, base_delay, max_delay, seed)
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            if (no_retry_on and isinstance(e, no_retry_on)) or attempt >= retries:
                raise
            delay = delays[attempt]
            logger.warning("%s failed (%s: %s); retry %d/%d in %.3fs",
                           what or getattr(fn, "__name__", "call"), type(e).__name__, e,
                           attempt + 1, retries, delay)
            time.sleep(delay)


def retrying(retries: int = DEFAULT_RETRIES, base_delay: float = DEFAULT_BASE_DELAY,
             max_delay: float = DEFAULT_MAX_DELAY,
             retry_on: Tuple[Type[BaseException], ...] = (OSError,), seed: int = 0):
    """Decorator form of ``retry_call``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            return retry_call(fn, *args, retries=retries, base_delay=base_delay,
                              max_delay=max_delay, retry_on=retry_on, seed=seed,
                              what=fn.__qualname__, **kwargs)

        return inner

    return wrap
