"""The tensor-parallel serve's ranks: ``tools/parallel_check.py``'s
``"serve"`` task, for the tests and ``chip_smoke.py``.

Every rank of the grid's model axis runs each case of ``job["cases"]``
with the same arguments, as a TP serve runs; a case is:

- ``kind``: ``"scheduler"`` (the default: ``serving.Scheduler(mesh=)``,
  every prompt submitted, ``stagger`` steps after each, then drained),
  ``"batcher"`` (``ContinuousBatcher(mesh=)`` in ``kw["cache_layout"]``,
  driven by the JAX tests' ``_drive`` schedule: submit while a slot is
  free, then step), ``"generate"`` (``generate_tp`` on ``prompts`` as one
  ``[B, L]`` batch) or ``"ragged"`` (``generate_ragged_tp`` on the prompts
  right-padded to ``pad_to``);
- ``model``: the ``TransformerConfig`` spec (``tools.ring_check``'s), a
  TP one (``tp_size``, ``model_axis``) the grid's model axis serves;
  ``params``: the global state dict, else the seed-0 initialisation;
- ``kw``: the entry point's keyword arguments (``n_slots``,
  ``prefill_chunk``, ``kv_dtype``, ``prefix_cache``, ``offload``,
  ``cuda_graphs``, ``temperature``, ``seed`` ...); ``max_new``: one
  budget, or one a prompt; ``deadlines``: seconds a prompt (None: none);
  ``warmup``: the scheduler's warmup first;
- ``clock``: ``{"dt": [s, ...]}``, a virtual ``time.perf_counter`` for the
  scheduler on each model rank, advancing by that rank's step at every
  reading (a rank's skewed clock, made repeatable);
- ``record``: each decoded token's logits row, the row it was sampled
  from (schedulers; kept on rank 0, every rank returns their digest), or
  the logits before each step (batchers, rank 0);
- ``pool``: return the rank's pool tensors after the serve;
- ``reference``: rank 0 then runs the case again on the replicated config
  from the same global weights on its device (its result under
  ``"reference"``).

A case's result: ``streams`` (``{rid or slot: [tokens]}``, or the tokens
tensor), ``outcomes``, ``pool_bytes`` (the rank's KV pool or dense cache),
``launches`` (the paged kernels' counter deltas), ``chunk_calls`` and
``ticks`` (engine calls) and the calls by the kernel their layers launch
(``chunk_sweep``, ``chunk_split``, ``tick_sweep``, ``tick_split``), some
``metrics``, ``rows``/``rows_digest``, ``pool``. This module imports no JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
from typing import Dict, List

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax
from pytorch_distributed_tpu_torch.models.generate import (
    ContinuousBatcher,
    generate_ragged_tp,
    generate_tp,
)
from pytorch_distributed_tpu_torch.ops import paged_flash
from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.parallel.mesh import Mesh
from pytorch_distributed_tpu_torch.serving import Scheduler
from pytorch_distributed_tpu_torch.serving import scheduler as scheduler_module
from pytorch_distributed_tpu_torch.tools.ring_check import _model_config

#: the metrics a scheduler case reports
METRICS = ("preempts", "restores", "swap_outs", "swap_ins", "decision_swap",
           "decision_recompute", "deadline_misses", "completed", "prefix_hits",
           "prefix_cow_copies", "tokens_out", "tokens_per_s", "tick_p50_s", "ttft_p50_s",
           "cold_requests", "graphs")
#: the config fields that make a serving config tensor-parallel
TP_FIELDS = ("tp_size", "model_axis", "vocab_parallel")


def replicated(spec: dict) -> dict:
    """The model spec without its tensor parallelism."""
    return {k: v for k, v in spec.items() if k not in TP_FIELDS}


class VirtualClock:
    """A stand-in for the ``time`` module in ``serving.scheduler``:
    ``perf_counter`` advances by ``dt`` at every reading."""

    def __init__(self, dt: float):
        self.dt, self.now = dt, 0.0

    def perf_counter(self) -> float:
        self.now += self.dt
        return self.now


@contextlib.contextmanager
def clock(dt):
    """``serving.scheduler`` reads ``VirtualClock(dt)`` inside (nothing
    changes with ``dt`` None)."""
    if dt is None:
        yield
        return
    real = scheduler_module.time
    scheduler_module.time = VirtualClock(dt)
    try:
        yield
    finally:
        scheduler_module.time = real


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def cache_tensors(obj) -> List[torch.Tensor]:
    return [t for layer in obj.cache for t in layer if t is not None]


def _launch_delta(snap) -> Dict[str, int]:
    out = {}
    for d in paged_flash.launches_since(snap):
        out.update({k: v for k, v in d.items() if v})
    return out


def _route(engine, w: int, b: int) -> str:
    """The paged kernel a call with a ``[b, w]`` table launches in every
    layer: kernel 7 (the sweep) or kernel 8 (the split)."""
    return "split" if paged_flash.split_workers(w, b, engine.config.split_s) > 1 else "sweep"


def _instrument(engine, rows: Dict[int, list], rid_of, record: bool, calls: dict):
    """Count the engine's chunk calls and decode ticks, each by the kernel
    its layers launch (``chunk_sweep``, ``tick_split`` ...); with
    ``record``, keep each active lane's logits row before the tick samples
    from it."""
    run_chunks, decode_launch = engine.run_chunks, engine.decode_launch

    def chunks(jobs):
        if jobs:
            calls["chunk_calls"] += 1
            k_pad, wp = engine.bucket_for(jobs)
            calls["chunk_" + _route(engine, wp, k_pad)] += 1
        return run_chunks(jobs)

    def launch(positions, active):
        calls["ticks"] += 1
        calls["tick_" + _route(engine, engine.table_width, engine.n_slots)] += 1
        if record:
            lanes = np.nonzero(np.asarray(active, bool))[0]
            snap = engine.logits[torch.as_tensor(lanes, device=engine.device)].float().cpu()
            for i, slot in enumerate(lanes.tolist()):
                rows.setdefault(rid_of(slot), []).append(snap[i])
        return decode_launch(positions, active)

    engine.run_chunks, engine.decode_launch = chunks, launch


def _scheduler(case, cfg, params, mesh, device) -> dict:
    kw = dict(case.get("kw", {}))
    prompts = case["prompts"]
    budgets = case["max_new"]
    budgets = budgets if isinstance(budgets, (list, tuple)) else [budgets] * len(prompts)
    deadlines = case.get("deadlines") or [None] * len(prompts)
    dts = (case.get("clock") or {}).get("dt")
    dt = dts[mesh.model.index] if dts is not None and cfg.tp_size > 1 else (
        dts[0] if dts is not None else None)
    rows: Dict[int, list] = {}
    calls = dict.fromkeys(("chunk_calls", "ticks", "chunk_sweep", "chunk_split", "tick_sweep",
                           "tick_split"), 0)
    outcomes: Dict[int, str] = {}
    streams: Dict[int, list] = {}
    with clock(dt):
        s = Scheduler(cfg, params, mesh=mesh if cfg.tp_size > 1 else None, device=device, **kw)
        s.on_retire = lambda rid, outcome: outcomes.__setitem__(rid, outcome)
        if case.get("warmup"):
            s.warmup(background=False)

        def rid_of(slot):
            return s.resident[slot].rid

        _instrument(s.engine, rows, rid_of, case.get("record", False), calls)
        paged_flash.reset_launch_counts()
        snap = paged_flash.launch_snapshot()
        for p, n, d in zip(prompts, budgets, deadlines):
            streams[s.submit(p, n, deadline_s=d)] = []
            for _ in range(case.get("stagger", 0)):
                for rid, tok in s.step():
                    streams[rid].append(tok)
        for rid, toks in s.drain().items():
            streams[rid].extend(toks)
        launches = _launch_delta(snap)
    m = s.metrics()
    out = {"streams": streams, "outcomes": outcomes, "launches": launches, **calls,
           "pool_bytes": sum(t.numel() * t.element_size() for t in cache_tensors(s.engine)),
           "metrics": {k: m.get(k) for k in METRICS},
           "in_use": s.engine.allocator.in_use}
    out.update(_rows(rows, case))
    if case.get("pool"):
        out["pool"] = [t.cpu() for t in cache_tensors(s.engine)]
    return out


def _rows(rows: Dict[int, list], case) -> dict:
    if not case.get("record"):
        return {}
    stacked = {rid: torch.stack(r) for rid, r in rows.items()}
    return {"rows": stacked if distributed.is_primary() else None,
            "rows_digest": {rid: digest(r) for rid, r in stacked.items()}}


def _batcher(case, cfg, params, mesh, device) -> dict:
    kw = dict(case.get("kw", {}))
    b = ContinuousBatcher(cfg, params, mesh=mesh if cfg.tp_size > 1 else None,
                          device=device, **kw)
    prompts, budgets = case["prompts"], case["max_new"]
    budgets = budgets if isinstance(budgets, (list, tuple)) else [budgets] * len(prompts)
    produced: Dict[int, list] = {}
    pending = list(enumerate(zip(prompts, budgets)))
    slot_req: Dict[int, int] = {}
    logits = []
    paged_flash.reset_launch_counts()
    snap = paged_flash.launch_snapshot()
    while pending or (b.remaining > 0).any():
        while pending and b.free_slots():
            req, (p, n) = pending.pop(0)
            slot_req[b.submit(p, n)] = req
            produced[req] = []
        if case.get("record"):
            logits.append(b.logits.float().cpu().clone())
        for slot, tok in b.step():
            produced[slot_req[slot]].append(tok)
    out = {"streams": produced, "launches": _launch_delta(snap),
           "pool_bytes": sum(t.numel() * t.element_size() for t in cache_tensors(b)),
           "logits": logits if distributed.is_primary() else None}
    if case.get("pool"):
        out["pool"] = [t.cpu() for t in cache_tensors(b)]
    return out


def _generate(case, cfg, params, mesh, device) -> dict:
    kw = dict(case.get("kw", {}))
    prompts = case["prompts"]
    if cfg.tp_size > 1:
        if case["kind"] == "generate":
            got = generate_tp(mesh, cfg, params, torch.as_tensor(np.stack(prompts)),
                              case["max_new"], device=device, **kw)
        else:
            padded, lengths = _padded(prompts, case.get("pad_to"))
            got = generate_ragged_tp(mesh, cfg, params, padded, lengths, case["max_new"],
                                     device=device, **kw)
    else:
        from pytorch_distributed_tpu_torch.models.generate import generate, generate_ragged

        if case["kind"] == "generate":
            got = generate(cfg, params, torch.as_tensor(np.stack(prompts)), case["max_new"],
                           device=device, **kw)
        else:
            padded, lengths = _padded(prompts, case.get("pad_to"))
            got = generate_ragged(cfg, params, padded, lengths, case["max_new"],
                                  device=device, **kw)
    return {"streams": got.cpu()}


def _padded(prompts, pad_to):
    pad_to = pad_to or max(len(p) for p in prompts)
    padded = torch.zeros((len(prompts), pad_to), dtype=torch.long)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = torch.as_tensor(p)
    return padded, torch.as_tensor([len(p) for p in prompts])


KINDS = {"scheduler": _scheduler, "batcher": _batcher, "generate": _generate,
         "ragged": _generate}


def serve(job: dict, mesh: Mesh, device) -> Dict[str, dict]:
    """Every case of ``job["cases"]`` on this rank (module docstring)."""
    out = {}
    inits: Dict[str, dict] = {}
    for name, case in job["cases"].items():
        spec = case["model"]
        cfg = _model_config(spec)
        params = case.get("params")
        if params is None:
            key = repr(sorted(replicated(spec).items()))
            if key not in inits:
                inits[key] = params_from_jax(init_params(cfg, 0))
            params = inits[key]
        run = KINDS[case.get("kind", "scheduler")]
        res = run(case, cfg, params, mesh, device)
        if case.get("reference") and distributed.is_primary():
            ref_cfg = _model_config(replicated(spec))
            res["reference"] = run(case, ref_cfg, params, None, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out[name] = res
    return out


__all__ = ["serve", "replicated", "VirtualClock", "digest"]
