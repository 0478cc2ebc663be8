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

``--kv-dtype`` quantizes the KV pool (int8 or fp8, with the
quantize-on-scatter and dequantizing attention kernels),
``--prefix-cache`` shares full prompt blocks between requests, and
``--preempt`` arms the pressure tier: pool OOM preempts the least
recently served request (swap to host RAM or recompute,
``--swap-policy``) instead of waiting for a retirement. ``--warmup``
captures every program of the registry (the decode tick and every
prefill bucket, each as a CUDA graph) before the first request, so no
request is cold.

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
    p.add_argument("--gather-impl", choices=("kernel", "dense"), default="kernel",
                   help="paged attention: the CUDA kernels, or the plain "
                        "PyTorch version")
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
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _prompts(args, cfg) -> List[np.ndarray]:
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(4, cfg.max_seq_len - args.max_new, size=args.requests)
    return [rng.integers(1, cfg.vocab_size, size=l).astype(np.int32) for l in lens]


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parse(argv)
    cfg = tiny_config(max_seq_len=128) if args.tiny else full_config()
    t0 = time.perf_counter()
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
