"""Paged-KV continuous-batching serving on the port.

Serves a synthetic workload through ``serving.Scheduler`` and prints the
scheduler's host-side metrics as JSON. On the card it serves the repo's
full-width LM (vocab 32000, 12 layers, 12 heads, width 768, 2048
positions, learned positions, bf16) with random weights made from
``--seed``, its attention in the CUDA paged kernels:

    python -m pytorch_distributed_tpu_torch.recipes.serve_lm
    python -m pytorch_distributed_tpu_torch.recipes.serve_lm --device cpu --tiny
    python -m pytorch_distributed_tpu_torch.recipes.serve_lm --kv-dtype fp8 \
        --prefix-cache --preempt --n-blocks 600
    python -m pytorch_distributed_tpu_torch.recipes.serve_lm --dense

``--kv-dtype`` quantizes the KV pool (int8 or fp8, with the
quantize-on-scatter and dequantizing attention kernels),
``--prefix-cache`` shares full prompt blocks between requests, and
``--preempt`` arms the pressure tier: pool OOM preempts the least
recently served request (swap to host RAM or recompute,
``--swap-policy``) instead of waiting for a retirement. ``--warmup``
captures every program of the registry (the decode tick and every
prefill bucket, each as a CUDA graph) before the first request, so no
request is cold. ``--dense`` serves the same prompts through
``models.generate.ContinuousBatcher(cache_layout="dense")`` instead: one
``max_seq_len`` cache row per slot, a request submitted when a slot frees
(no queue, no block pool), so the block-pool flags are refused with it.

Without ``--device`` it runs on CUDA and fails where there is none.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax
from pytorch_distributed_tpu_torch.models.generate import ContinuousBatcher
from pytorch_distributed_tpu_torch.models.transformer import (
    TransformerConfig,
    tiny_config,
)
from pytorch_distributed_tpu_torch.serving import Scheduler


def full_config(**overrides) -> TransformerConfig:
    """The repo's full-width serving model (``recipes/serve_lm.py:283-286``)."""
    cfg = dict(vocab_size=32_000, num_layers=12, num_heads=12, embed_dim=768,
               max_seq_len=2048, dtype=torch.bfloat16)
    cfg.update(overrides)
    return TransformerConfig(**cfg)


def _parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tiny", action="store_true", help="the tiny test config")
    p.add_argument("--device", default=None,
                   help="cuda (the default, which needs a card) or cpu")
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--slots", type=int, default=8, help="decode lanes")
    p.add_argument("--max-new", type=int, default=16, help="decode budget per request")
    p.add_argument("--block-len", type=int, default=16)
    p.add_argument("--n-blocks", type=int, default=None,
                   help="KV pool blocks (default: every slot can hold "
                        "max_seq_len, plus the trash block)")
    p.add_argument("--prefill-chunk", type=int, default=32)
    p.add_argument("--admit-per-step", type=int, default=4)
    p.add_argument("--gather-impl", choices=("kernel", "dense"), default=None,
                   help="paged attention: the CUDA kernels (unset: the "
                        "config's, 'kernel'), or the plain PyTorch version")
    p.add_argument("--split-s", type=int, default=None,
                   help="flash-decoding workers (default: auto)")
    p.add_argument("--kv-dtype", choices=("int8", "fp8", "fp8_e5m2"), default=None,
                   help="quantize the KV pool: 'int8' (+fp32 per-row scales, "
                        "2D/(D+4) the blocks of bf16 in the same bytes) or "
                        "'fp8'/'fp8_e5m2' (e4m3/e5m2 + int8 exponents, 2D/(D+1))")
    p.add_argument("--prefix-cache", action="store_true",
                   help="share full prompt blocks between requests (radix index "
                        "with copy-on-write); greedy streams stay identical")
    p.add_argument("--preempt", action="store_true",
                   help="the pressure tier: on pool OOM preempt the least "
                        "recently served request to host RAM or to recompute")
    p.add_argument("--swap-policy", choices=("auto", "swap", "recompute"),
                   default="auto",
                   help="preemption path: 'auto' takes the measured "
                        "swap-vs-recompute crossover per request")
    p.add_argument("--warmup", action="store_true",
                   help="capture every registry program (decode tick + all prefill "
                        "buckets) before admitting traffic: zero cold requests")
    p.add_argument("--dense", action="store_true",
                   help="serve through the dense-cache ContinuousBatcher (one "
                        "max_seq_len row per slot) instead of the paged scheduler")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.dense:
        pool_flags = [flag for flag, on in (
            ("--warmup", args.warmup), ("--kv-dtype", args.kv_dtype),
            ("--prefix-cache", args.prefix_cache), ("--preempt", args.preempt),
            ("--split-s", args.split_s is not None),
            ("--n-blocks", args.n_blocks is not None),
            ("--gather-impl", args.gather_impl is not None)) if on]
        if pool_flags:
            p.error(f"{', '.join(pool_flags)}: block-pool knobs (the dense layout has "
                    "no program registry, block pool or chain sweep); drop --dense")
    return args


def _prompts(args, cfg) -> List[np.ndarray]:
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(4, cfg.max_seq_len - args.max_new, size=args.requests)
    return [rng.integers(1, cfg.vocab_size, size=l).astype(np.int32) for l in lens]


def _serve_dense(args, cfg, t0: float) -> dict:
    """The prompts through the dense-cache batcher: submitted as slots free,
    one decode tick for every active slot at a time."""
    b = ContinuousBatcher(cfg, params_from_jax(init_params(cfg, args.seed)),
                          n_slots=args.slots, prefill_bucket=args.prefill_chunk,
                          seed=args.seed, cache_layout="dense", device=args.device)
    waiting = _prompts(args, cfg)
    tokens_out = completed = ticks = 0
    while waiting or (b.remaining > 0).any():
        while waiting and b.free_slots():
            b.submit(waiting.pop(0), args.max_new)
        out = b.step()
        ticks += 1
        tokens_out += len(out)
        completed += sum(int(b.remaining[slot] == 0) for slot, _ in out)
    wall = time.perf_counter() - t0
    return {"layout": "dense", "device": str(b.device), "completed": completed,
            "tokens_out": tokens_out, "ticks": ticks, "wall_s": wall}


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parse(argv)
    cfg = tiny_config(max_seq_len=128) if args.tiny else full_config()
    t0 = time.perf_counter()
    if args.dense:
        metrics = _serve_dense(args, cfg, t0)
        if metrics["completed"] != args.requests:
            raise RuntimeError(f"served {metrics['completed']} of {args.requests} requests")
        print(json.dumps(metrics, indent=2))
        return metrics
    s = Scheduler(
        cfg, params_from_jax(init_params(cfg, args.seed)), n_slots=args.slots,
        block_len=args.block_len, prefill_chunk=args.prefill_chunk,
        n_blocks=args.n_blocks, admit_per_step=args.admit_per_step,
        seed=args.seed, gather_impl=args.gather_impl, split_s=args.split_s,
        kv_dtype=args.kv_dtype, prefix_cache=args.prefix_cache,
        offload=args.preempt, preempt_on_oom=args.preempt,
        swap_policy=args.swap_policy, device=args.device,
    )
    if args.warmup:
        # everything in the foreground, each run inert first: every
        # request that follows is warm
        ws = s.warmup(background=False).summary()
        print(f"warmup: {ws['programs']} programs in {ws['total_s']:.2f}s "
              f"({ws['backend_compile_s']:.2f}s of capture)")
    for prompt in _prompts(args, cfg):
        s.submit(prompt, args.max_new)
    streams = s.drain()
    if len(streams) != args.requests:
        raise RuntimeError(f"served {len(streams)} of {args.requests} requests")
    metrics = {"layout": "paged", "device": str(s.engine.device), **s.metrics(),
               "wall_s": time.perf_counter() - t0}
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
