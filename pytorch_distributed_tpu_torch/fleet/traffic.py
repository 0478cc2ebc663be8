"""Seeded traffic traces: bursty arrivals, heavy-tail lengths, replay
(``pytorch_distributed_tpu/fleet/traffic.py``, a copy).

- ``generate_trace`` / ``iter_trace``: a seeded piecewise-Poisson arrival
  process (rate ``base_rate``, lifted ``burst_rate_mult`` times inside the
  first ``burst_len_s`` of every ``burst_every_s``) with lognormal prompt
  and output lengths and random session ids. The numpy draws are the JAX
  package's, in the same order: one seed gives the same trace in either
  package.
- ``prompt_for`` / ``shared_prefix_prompt_for``: a request's prompt tokens,
  regenerated from its rid (the trace stores lengths only).
- ``save_trace`` / ``load_trace``: one JSON line a request after a
  ``trace_header`` line; either package reads the other's files.
- ``clamp_trace``: fit a trace to a serving config's admission contract.
- ``replay_trace`` / ``replay_stream``: drive a front end in the step
  domain: tick ``k`` submits every arrival with ``t <= k * tick_s``, so a
  trace offers the same load per tick on any machine.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival: ``t`` seconds since trace start (nominal time),
    ``session`` the affinity key, lengths in tokens."""

    rid: int
    t: float
    session: int
    prompt_len: int
    max_new: int


def _heavy_tail(rng, median: float, sigma: float, lo: int,
                hi: Optional[int]) -> int:
    """Lognormal sample clipped to [lo, hi] — median ``median``, tail
    weight ``sigma`` (sigma 0.8 puts p99 at ~6x the median)."""
    v = rng.lognormal(mean=float(np.log(max(median, 1.0))), sigma=sigma)
    if hi is not None:
        v = min(v, hi)
    return int(max(lo, round(v)))


def generate_trace(
    *,
    seed: int = 0,
    duration_s: float = 60.0,
    base_rate: float = 2.0,
    burst_rate_mult: float = 4.0,
    burst_every_s: float = 10.0,
    burst_len_s: float = 2.0,
    sessions: int = 16,
    prompt_median: int = 32,
    prompt_sigma: float = 0.8,
    prompt_min: int = 4,
    prompt_max: Optional[int] = None,
    max_new_median: int = 12,
    max_new_sigma: float = 0.6,
    max_new_min: int = 2,
    max_new_max: Optional[int] = None,
) -> List[TraceRequest]:
    """Seeded bursty heavy-tail trace.

    Arrivals are a piecewise Poisson process: rate ``base_rate`` req/s,
    lifted to ``base_rate * burst_rate_mult`` inside burst episodes (the
    first ``burst_len_s`` of every ``burst_every_s`` window). Prompt and
    output lengths are lognormal with medians/sigmas as given. The same
    seed always yields the same trace.
    """
    if duration_s <= 0 or base_rate <= 0:
        raise ValueError("duration_s and base_rate must be positive")
    if burst_rate_mult < 1.0:
        raise ValueError("burst_rate_mult must be >= 1 (1 = no bursts)")
    rng = np.random.default_rng(seed)
    out: List[TraceRequest] = []
    t = 0.0
    while True:
        in_burst = (
            burst_len_s > 0 and (t % burst_every_s) < burst_len_s
        )
        rate = base_rate * (burst_rate_mult if in_burst else 1.0)
        t += float(rng.exponential(1.0 / rate))
        if t >= duration_s:
            return out
        out.append(TraceRequest(
            rid=len(out),
            t=t,
            session=int(rng.integers(sessions)),
            prompt_len=_heavy_tail(rng, prompt_median, prompt_sigma,
                                   prompt_min, prompt_max),
            max_new=_heavy_tail(rng, max_new_median, max_new_sigma,
                                max_new_min, max_new_max),
        ))


def iter_trace(
    *,
    seed: int = 0,
    duration_s: float = 60.0,
    base_rate: float = 2.0,
    burst_rate_mult: float = 4.0,
    burst_every_s: float = 10.0,
    burst_len_s: float = 2.0,
    sessions: int = 16,
    prompt_median: int = 32,
    prompt_sigma: float = 0.8,
    prompt_min: int = 4,
    prompt_max: Optional[int] = None,
    max_new_median: int = 12,
    max_new_sigma: float = 0.6,
    max_new_min: int = 2,
    max_new_max: Optional[int] = None,
    unique_sessions: bool = False,
) -> Iterator[TraceRequest]:
    """Streaming ``generate_trace`` — O(1) memory for 100k+-request soaks.

    Yields the SAME requests as ``generate_trace`` for the same
    parameters and seed (identical RNG draw order), without ever
    holding the trace in a list — a soak can stream a
    million-user-shaped trace through this. ``unique_sessions=True``
    gives every request its own session id (``session == rid``): the
    one-query-per-user shape that stresses the affinity LRU hardest.
    The session draw is still consumed in that mode so lengths and
    arrival times stay seed-identical across both shapes.
    """
    if duration_s <= 0 or base_rate <= 0:
        raise ValueError("duration_s and base_rate must be positive")
    if burst_rate_mult < 1.0:
        raise ValueError("burst_rate_mult must be >= 1 (1 = no bursts)")
    rng = np.random.default_rng(seed)
    rid = 0
    t = 0.0
    while True:
        in_burst = (
            burst_len_s > 0 and (t % burst_every_s) < burst_len_s
        )
        rate = base_rate * (burst_rate_mult if in_burst else 1.0)
        t += float(rng.exponential(1.0 / rate))
        if t >= duration_s:
            return
        session = int(rng.integers(sessions))
        yield TraceRequest(
            rid=rid,
            t=t,
            session=rid if unique_sessions else session,
            prompt_len=_heavy_tail(rng, prompt_median, prompt_sigma,
                                   prompt_min, prompt_max),
            max_new=_heavy_tail(rng, max_new_median, max_new_sigma,
                                max_new_min, max_new_max),
        )
        rid += 1


def prompt_for(req: TraceRequest, vocab_size: int,
               seed: int = 0) -> np.ndarray:
    """The request's deterministic prompt tokens — a per-rid seeded
    stream, so replays of one trace agree token-for-token across
    processes and configurations sharing a vocab."""
    rng = np.random.default_rng((seed, req.rid))
    return rng.integers(1, vocab_size, size=req.prompt_len,
                        dtype=np.int64).astype(np.int32)


def shared_prefix_prompt_for(req: TraceRequest, vocab_size: int,
                             prefix_len: int, seed: int = 0,
                             n_prefixes: int = 1) -> np.ndarray:
    """System-prompt-heavy prompts (the prefix-cache trace):
    a ``prefix_len``-token SYSTEM PREFIX shared across requests —
    seeded independently of rids, chosen per ``session % n_prefixes``
    so multi-tenant shapes (one system prompt per tenant) are one knob
    away — followed by the request's own ``prompt_for`` tail. Total
    length is ``prefix_len + req.prompt_len``; callers clamp the trace
    accordingly."""
    if prefix_len < 1:
        raise ValueError(f"prefix_len must be >= 1, got {prefix_len}")
    pid = req.session % max(n_prefixes, 1)
    # the 3-int tuple seed cannot collide with prompt_for's (seed, rid)
    rng = np.random.default_rng((seed, 1_000_003, pid))
    prefix = rng.integers(1, vocab_size, size=prefix_len,
                          dtype=np.int64).astype(np.int32)
    return np.concatenate([prefix, prompt_for(req, vocab_size, seed=seed)])


# ---------------------------------------------------------------------------
# JSONL persistence
# ---------------------------------------------------------------------------


def save_trace(path: str, trace: List[TraceRequest], **header) -> None:
    """Write the reusable JSONL trace: a ``trace_header`` provenance
    line (generator params, free-form) then one ``kind="trace"`` line
    per request."""
    with open(path, "w") as f:
        f.write(json.dumps(
            {"kind": "trace_header", "requests": len(trace), **header}
        ) + "\n")
        for r in trace:
            f.write(json.dumps({
                "kind": "trace", "rid": r.rid, "t": round(r.t, 6),
                "session": r.session, "prompt_len": r.prompt_len,
                "max_new": r.max_new,
            }) + "\n")


def load_trace(path: str) -> List[TraceRequest]:
    """Read a trace JSONL (unknown kinds skipped, so traces can live in
    mixed telemetry streams); rids are re-checked to be unique."""
    out: List[TraceRequest] = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSONL ({e})") from e
            if rec.get("kind") != "trace":
                continue
            out.append(TraceRequest(
                rid=int(rec["rid"]), t=float(rec["t"]),
                session=int(rec["session"]),
                prompt_len=int(rec["prompt_len"]),
                max_new=int(rec["max_new"]),
            ))
    if len({r.rid for r in out}) != len(out):
        raise ValueError(f"{path}: duplicate rids in trace")
    return out


def clamp_trace(trace: List[TraceRequest], max_seq_len: int,
                chunk: int) -> List[TraceRequest]:
    """Fit a trace to a serving config: clip each request so its
    chunk-padded prompt AND prompt+output fit ``max_seq_len`` (the
    scheduler's admission contract). Keeps arrival times and sessions —
    the traffic shape — while making any trace servable by any config."""
    out = []
    for r in trace:
        # leave at least one decode token's room below max_seq_len
        plen = max(1, min(r.prompt_len, (max_seq_len // chunk) * chunk,
                          max_seq_len - 1))
        mnew = max(1, min(r.max_new, max_seq_len - plen))
        out.append(dataclasses.replace(r, prompt_len=plen, max_new=mnew))
    return out


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


def replay_trace(
    trace: List[TraceRequest],
    submit: Callable[[TraceRequest], None],
    tick: Callable[[], None],
    is_idle: Callable[[], bool],
    *,
    tick_s: float = 1.0,
    max_steps: int = 1_000_000,
) -> int:
    """Drive any serving front-end through a trace in the step domain.

    Tick ``k`` first submits every request with ``t <= k * tick_s``,
    then calls ``tick()`` once; after the last arrival it keeps ticking
    until ``is_idle()``. ``tick_s`` is the NOMINAL tick — it converts
    trace time to tick indices and nothing else, so a trace offers the
    same per-tick load on any machine. Returns the number of ticks run.
    """
    if tick_s <= 0:
        raise ValueError("tick_s must be positive")
    trace = sorted(trace, key=lambda r: (r.t, r.rid))
    i = 0
    for step in range(max_steps):
        while i < len(trace) and trace[i].t <= step * tick_s:
            submit(trace[i])
            i += 1
        if i >= len(trace) and is_idle():
            return step
        tick()
    raise RuntimeError(
        f"replay did not converge within {max_steps} ticks "
        f"({len(trace) - i} arrivals pending)"
    )


def replay_stream(
    arrivals: Iterable[TraceRequest],
    submit: Callable[[TraceRequest], None],
    tick: Callable[[], None],
    is_idle: Callable[[], bool],
    *,
    tick_s: float = 1.0,
    max_steps: int = 10_000_000,
) -> int:
    """``replay_trace`` over an arrival ITERATOR — one-request
    lookahead, O(1) memory, for soaks whose trace never fits a list.

    Requires arrivals in non-decreasing ``t`` order (``iter_trace``
    yields strictly increasing times by construction). Same step-domain
    semantics as ``replay_trace``: tick ``k`` submits everything with
    ``t <= k * tick_s``, then ticks once; after the stream is drained
    it ticks until ``is_idle()``. Returns the number of ticks run.
    """
    if tick_s <= 0:
        raise ValueError("tick_s must be positive")
    it = iter(arrivals)
    pending = next(it, None)
    last_t = float("-inf")
    for step in range(max_steps):
        while pending is not None and pending.t <= step * tick_s:
            if pending.t < last_t:
                raise ValueError(
                    f"replay_stream needs time-ordered arrivals "
                    f"(t={pending.t} after t={last_t})")
            last_t = pending.t
            submit(pending)
            pending = next(it, None)
        if pending is None and is_idle():
            return step
        tick()
    raise RuntimeError(
        f"stream replay did not converge within {max_steps} ticks")
