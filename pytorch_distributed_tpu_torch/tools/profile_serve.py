"""Where a serve's time goes on the card.

Serves the ``chip_smoke.py`` workload (the full-width LM, random weights
from seed 0, 8 slots, block_len 16, prefill chunk 32, 16 requests of
64-1024 prompt tokens, 32 new tokens each) once to warm up, then again
under ``torch.profiler`` after ``Scheduler.warmup(background=False)`` (every
program captured as a CUDA graph, or with ``--eager`` run inert once), and
prints:

- wall, ticks and decode tokens/s of the profiled serve;
- the device's busy share: the union of kernel intervals over the wall;
- the top operators by device time and by host time;
- the paged attention kernels' share of the serve's device time;
- the device kernels one decode tick launches (8 lanes armed), by name,
  its device time and the paged attention kernels' share of it;
- the time of the prefill and decode halves of a tick, by host clock.

    python -m pytorch_distributed_tpu_torch.tools.profile_serve \
        [--gather-impl kernel|dense] [--kv-dtype int8|fp8|fp8_e5m2] [--eager] \
        [--kv-heads 4 --pos-embedding rope]

``--eager`` runs the engine's programs without CUDA graphs, one launch at
a time: run the tool with and without it on one card, one after the
other, to compare the two paths.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import Counter

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax
from pytorch_distributed_tpu_torch.recipes.serve_lm import full_config
from pytorch_distributed_tpu_torch.serving import Scheduler


def workload(cfg, seed=0, n=16, lo=64, hi=1024):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi + 1, size=n)]


def union_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_share(prof, wall_us: float) -> float:
    """Union of device-kernel intervals over the wall."""
    return union_us((e.time_range.start, e.time_range.end) for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / wall_us


class TickTimer:
    """Host-clock split of each tick into its prefill and decode halves
    (each half ends with the host waiting for its results only where the
    engine already waits: the decode half's token copy)."""

    def __init__(self, sched):
        self.prefill, self.decode = [], []
        eng = sched.engine
        run_chunks, decode = eng.run_chunks, eng.decode

        def timed_chunks(jobs):
            t = time.perf_counter()
            wall = run_chunks(jobs)
            torch.cuda.synchronize()
            self.prefill.append(time.perf_counter() - t)
            return wall

        def timed_decode(*a, **k):
            t = time.perf_counter()
            out = decode(*a, **k)
            self.decode.append(time.perf_counter() - t)
            return out

        eng.run_chunks, eng.decode = timed_chunks, timed_decode


PAGED_MARKS = ("paged_split_tc", "paged_sweep_tc", "paged_attention_kernel", "quantize_scatter")


def paged_shares(prof) -> dict:
    """Device time of the profiled kernels, and the time (µs) and share of
    it that each paged attention kernel takes, by name (``PAGED_MARKS``:
    the tensor-core split and sweep, the CUDA-core walk, the quantizing
    scatter)."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.end - e.time_range.start for e in kernels)
    paged = {}
    for e in kernels:
        for mark in PAGED_MARKS:
            if mark in e.name:
                paged[mark] = paged.get(mark, 0) + e.time_range.end - e.time_range.start
    return {"kernels": len(kernels), "device_us": total, "paged_us": paged,
            "paged_share": {k: v / total for k, v in paged.items()}}


def decode_tick(sched) -> dict:
    """One decode tick with all 8 lanes armed at position 64, under
    ``torch.profiler``: ``paged_shares`` of its kernels (and copies), and
    their launches by name (``by_name``); and the wall of such a tick
    unprofiled, tokens on the host (``wall_ms``, the median of 20)."""
    eng = sched.engine
    for slot in range(8):
        eng.admit(slot, 64, 1)
    args = (np.full(8, 64), np.ones(8, bool))
    eng.decode(*args)  # warm
    torch.cuda.synchronize()
    walls = []
    for _ in range(20):
        t = time.perf_counter()
        eng.decode(*args)
        walls.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.decode(*args)
        torch.cuda.synchronize()
    eng.release_all()
    by_name = Counter(e.name for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
    return {**paged_shares(prof), "by_name": dict(by_name),
            "wall_ms": 1e3 * float(np.median(walls))}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gather-impl", choices=("kernel", "dense"), default="kernel")
    p.add_argument("--kv-dtype", choices=("int8", "fp8", "fp8_e5m2"), default=None)
    p.add_argument("--eager", action="store_true",
                   help="run the programs eagerly, without CUDA graphs")
    p.add_argument("--kv-heads", type=int, default=None, help="grouped-query attention")
    p.add_argument("--pos-embedding", choices=("learned", "rope"), default="learned")
    args = p.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = full_config(num_kv_heads=args.kv_heads, pos_embedding=args.pos_embedding)
    state = params_from_jax(init_params(cfg, seed=0))
    kw = dict(n_slots=8, block_len=16, prefill_chunk=32, gather_impl=args.gather_impl,
              kv_dtype=args.kv_dtype, cuda_graphs=not args.eager, device="cuda")
    prompts = workload(cfg)
    warm = Scheduler(cfg, state, **kw)
    for q in prompts[:4]:
        warm.submit(q, 4)
    warm.drain()
    del warm

    sched = Scheduler(cfg, state, **kw)
    warmup = sched.warmup(background=False).summary()
    for q in prompts:
        sched.submit(q, 32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sched.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    m = sched.metrics()
    print(f"card: {card}; gather_impl={args.gather_impl}, kv_dtype={args.kv_dtype}, "
          f"{'eager' if args.eager else 'CUDA graphs'}; warmup {warmup['programs']} programs "
          f"in {warmup['total_s']:.2f}s ({warmup['backend_compile_s']:.2f}s of capture), "
          f"{sched.engine.captures} graphs")
    print(f"profiled serve: wall {wall:.3f}s, {m['steps']} ticks, "
          f"{m['tokens_out'] / wall:.1f} tok/s (profiler on)")
    print(f"device busy share: {busy_share(prof, wall * 1e6):.3f}")
    serve_shares = paged_shares(prof)
    print(f"paged kernels' share of the serve's device time: {serve_shares}")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25,
                                    max_name_column_width=60))
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=20,
                                    max_name_column_width=60))

    # an unprofiled serve, its ticks split by host clock
    sched = Scheduler(cfg, state, **kw)
    sched.warmup(background=False)
    timer = TickTimer(sched)
    for q in prompts:
        sched.submit(q, 32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.drain()
    wall = time.perf_counter() - t0
    m = sched.metrics()
    summary = {
        "card": card, "gather_impl": args.gather_impl, "kv_dtype": args.kv_dtype,
        "cuda_graphs": not args.eager, "wall_s": wall,
        "ticks": m["steps"], "tok_per_s": m["tokens_out"] / wall,
        "prefill_calls": len(timer.prefill),
        "prefill_ms_mean": 1e3 * float(np.mean(timer.prefill)),
        "prefill_s_total": float(np.sum(timer.prefill)),
        "decode_calls": len(timer.decode),
        "decode_ms_mean": 1e3 * float(np.mean(timer.decode)),
        "decode_s_total": float(np.sum(timer.decode)),
        "ttft_p50_s": m["ttft_p50_s"], "ttft_p95_s": m["ttft_p95_s"],
        "tick_p50_s": m["tick_p50_s"], "cold_requests": m["cold_requests"],
    }
    summary["serve_paged_share"] = serve_shares["paged_share"]
    summary["serve_paged_us"] = serve_shares["paged_us"]
    summary["decode_tick"] = decode_tick(sched)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
