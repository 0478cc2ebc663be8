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

The fleet (``fleet.FleetRouter``) serves when ``--replicas`` is above 1 or
any of ``--disaggregate``, ``--trace``, ``--async-host`` or
``--http-port`` is given; the replicas sit round-robin on the visible
cards (all on the one card of a one-card machine, sharing its weights):

    python -m pytorch_distributed_tpu_torch.recipes.serve_lm --replicas 2 --async-host
    python -m pytorch_distributed_tpu_torch.recipes.serve_lm --replicas 2 --disaggregate
    python -m pytorch_distributed_tpu_torch.recipes.serve_lm --replicas 2 --trace T.jsonl \
        --slo-shed-depth 8
    python -m pytorch_distributed_tpu_torch.recipes.serve_lm --replicas 2 --http-port 8000 \
        --http-duration 60

``--disaggregate`` splits them into ``--prefill-replicas`` prefill
replicas and decode replicas that take each request's KV over;
``--async-host`` collects every replica's tick lagged; ``--trace`` replays
a trace file (``fleet.save_trace``) in the step domain instead of the
synthetic prompts; ``--slo-ttft-ms`` and ``--slo-shed-depth`` set the
admission gate's targets (the spill depth is a quarter of the shed
depth). ``--http-port`` serves the HTTP/SSE gateway for
``--http-duration`` seconds instead (the lagged loop, results dropped as
they stream; port 0 picks a free one, printed on the ``gateway:`` line).

``--tp T`` serves under Megatron tensor parallelism: T ranks, spawned
here, each build ``parallel.mesh.make_mesh(1, 1, T)`` and run the same
``Scheduler(mesh=)`` on the same prompts, each holding its parts of the
weights and an H_kv/T-head pool; ``--vocab-parallel`` also splits the
embedding and the LM head's vocabulary. On CUDA a rank takes a card and
talks NCCL (T above the visible cards is refused); with ``--device cpu``
T gloo ranks share the host. Rank 0 prints the metrics, after every
rank's streams are gathered and found equal (``streams_sha256`` in the
metrics is their digest, the same at every ``--tp``). As in JAX, ``--tp``
refuses ``--dense`` and the fleet's flags:

    python -m pytorch_distributed_tpu_torch.recipes.serve_lm --tp 2 --warmup
    python -m pytorch_distributed_tpu_torch.recipes.serve_lm --device cpu --tiny --tp 2 \
        --kv-dtype fp8 --prefix-cache

Without ``--device`` it runs on CUDA and fails where there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax
from pytorch_distributed_tpu_torch.models.generate import ContinuousBatcher
from pytorch_distributed_tpu_torch.models.transformer import (
    TransformerConfig,
    tiny_config,
)
from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_tpu_torch.serving import Scheduler

FLEET_FLAGS = ("--replicas", "--disaggregate", "--async-host", "--trace", "--http-port")


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
    p.add_argument("--prompt-range", type=int, nargs=2, default=None, metavar=("MIN", "MAX"),
                   help="prompt lengths drawn from [MIN, MAX) (default: [4, max_seq_len - "
                        "max_new))")
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
    p.add_argument("--tp", type=int, default=1,
                   help="serve under tensor parallelism over this many ranks (a card "
                        "each on CUDA, gloo ranks with --device cpu)")
    p.add_argument("--vocab-parallel", action="store_true",
                   help="with --tp > 1: split the embedding's and the LM head's "
                        "vocabulary over the ranks too")
    p.add_argument("--replicas", type=int, default=1,
                   help="serve through a FleetRouter with this many replicas (session "
                        "affinity, the SLO gate); 1 without another fleet flag keeps the "
                        "single scheduler")
    p.add_argument("--disaggregate", action="store_true",
                   help="prefill and decode replicas with the KV handoff between them "
                        "(2 replicas at least)")
    p.add_argument("--prefill-replicas", type=int, default=1,
                   help="prefill replicas with --disaggregate")
    p.add_argument("--async-host", action="store_true",
                   help="collect every replica's tick lagged (collect, then dispatch, "
                        "replica after replica); the same streams as the synchronous loop")
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="the gate's TTFT p95 target: a replica past it is spilled around")
    p.add_argument("--slo-shed-depth", type=int, default=None,
                   help="the gate's shed queue depth (the spill depth is a quarter of it)")
    p.add_argument("--trace", default=None, metavar="JSONL",
                   help="replay this traffic trace (fleet.save_trace) instead of the "
                        "synthetic prompts")
    p.add_argument("--http-port", type=int, default=None, metavar="PORT",
                   help="serve the HTTP/SSE gateway on PORT (0: a free one) for "
                        "--http-duration seconds instead of the synthetic prompts")
    p.add_argument("--http-duration", type=float, default=10.0,
                   help="seconds the gateway stays up (--http-port)")
    args = p.parse_args(argv)
    args.fleet = (args.replicas > 1 or args.disaggregate or args.async_host
                  or args.trace is not None or args.http_port is not None)
    if args.replicas < 1:
        p.error("--replicas must be >= 1")
    if args.dense and args.fleet:
        p.error(f"{'/'.join(FLEET_FLAGS)} need the paged layout; drop --dense")
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
    # the JAX recipe's refusals (recipes/serve_lm.py:363-365, :479-481)
    if args.tp < 1:
        raise SystemExit(f"--tp must be >= 1, got {args.tp}")
    if args.fleet and args.tp > 1:
        raise SystemExit("fleet replicas are single-device in this "
                         "round; drop --tp or --replicas")
    if args.dense and args.tp > 1:
        raise SystemExit("--tp > 1 needs the paged layout; drop "
                         "--dense")
    if args.vocab_parallel and args.tp <= 1:
        raise SystemExit("--vocab-parallel needs --tp > 1")
    return args


def _prompts(args, cfg) -> List[np.ndarray]:
    rng = np.random.default_rng(args.seed)
    lo, hi = args.prompt_range or (4, cfg.max_seq_len - args.max_new)
    lens = rng.integers(lo, hi, size=args.requests)
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


def _serve_fleet(args, cfg, t0: float) -> dict:
    """The prompts (or the trace, or the gateway's clients) through a
    ``FleetRouter``: every synthetic or traced request must stream its
    whole budget or be shed by the gate."""
    from pytorch_distributed_tpu_torch.fleet import (
        FleetRouter,
        SLOConfig,
        clamp_trace,
        load_trace,
        prompt_for,
        replay_trace,
    )

    slo_kw = {}
    if args.slo_ttft_ms is not None:
        slo_kw["ttft_p95_ms"] = args.slo_ttft_ms
    if args.slo_shed_depth is not None:
        slo_kw.update(shed_queue_depth=args.slo_shed_depth,
                      spill_queue_depth=max(1, args.slo_shed_depth // 4))
    http = args.http_port is not None
    router = FleetRouter(
        cfg, params_from_jax(init_params(cfg, args.seed)),
        n_replicas=max(args.replicas, 2) if args.disaggregate else args.replicas,
        disaggregate=args.disaggregate, n_prefill=args.prefill_replicas,
        slo=SLOConfig(**slo_kw), seed=args.seed, device=args.device,
        # the gateway streams: the lagged loop, results dropped at retire
        async_host=args.async_host or http, retain_results=not http,
        n_slots=args.slots, block_len=args.block_len, prefill_chunk=args.prefill_chunk,
        n_blocks=args.n_blocks, admit_per_step=args.admit_per_step,
        gather_impl=args.gather_impl, split_s=args.split_s, kv_dtype=args.kv_dtype,
        prefix_cache=args.prefix_cache, offload=args.preempt, preempt_on_oom=args.preempt,
        swap_policy=args.swap_policy)
    try:
        if args.warmup:
            router.warmup()
        budgets = {}
        if http:
            from pytorch_distributed_tpu_torch.gateway import Gateway

            with Gateway(router, port=args.http_port) as gw:
                print(f"gateway: http://127.0.0.1:{gw.port}/v1/generate (health /v1/health, "
                      f"metrics /metrics; up for {args.http_duration:g}s)", flush=True)
                time.sleep(args.http_duration)
            router.drain()
        elif args.trace is not None:
            trace = clamp_trace(load_trace(args.trace), cfg.max_seq_len, args.prefill_chunk)

            def submit(r):
                budgets[router.submit(prompt_for(r, cfg.vocab_size), r.max_new,
                                      session=r.session)] = r.max_new

            replay_trace(trace, submit, router.step, lambda: router.idle)
            router.drain()
        else:
            for i, prompt in enumerate(_prompts(args, cfg)):
                budgets[router.submit(prompt, args.max_new, session=i % 8)] = args.max_new
            router.drain()
    finally:
        router.close()
    short = [rid for rid, n in budgets.items()
             if rid not in router.rejected and len(router.results.get(rid, ())) != n]
    if short:
        raise RuntimeError(f"requests {short} did not stream their budget")
    return {"layout": "fleet", "device": str(router.replicas[0].engine.device),
            **router.metrics(), "wall_s": time.perf_counter() - t0}


def streams_digest(streams: Dict[int, List[int]]) -> str:
    """SHA-256 of the streams in rid order: equal digests, equal streams."""
    h = hashlib.sha256()
    for rid in sorted(streams):
        h.update(np.asarray([rid, len(streams[rid]), *streams[rid]], np.int64).tobytes())
    return h.hexdigest()


def _serve_paged(args, cfg, t0: float, device=None, mesh=None) -> dict:
    """The prompts through ``serving.Scheduler`` (on this model rank of
    ``mesh`` under TP); its metrics, the pool's bytes and the streams'
    digest, with the streams under ``"streams"`` (``main`` returns them
    and prints the rest)."""
    s = Scheduler(
        cfg, params_from_jax(init_params(cfg, args.seed)), n_slots=args.slots,
        block_len=args.block_len, prefill_chunk=args.prefill_chunk,
        n_blocks=args.n_blocks, admit_per_step=args.admit_per_step,
        seed=args.seed, gather_impl=args.gather_impl, split_s=args.split_s,
        kv_dtype=args.kv_dtype, prefix_cache=args.prefix_cache,
        offload=args.preempt, preempt_on_oom=args.preempt,
        swap_policy=args.swap_policy, mesh=mesh, device=device,
    )
    if args.warmup:
        # everything in the foreground, each run inert first: every
        # request that follows is warm
        ws = s.warmup(background=False).summary()
        if distributed.is_primary():
            print(f"warmup: {ws['programs']} programs in {ws['total_s']:.2f}s "
                  f"({ws['backend_compile_s']:.2f}s of capture)")
    for prompt in _prompts(args, cfg):
        s.submit(prompt, args.max_new)
    streams = s.drain()
    if len(streams) != args.requests:
        raise RuntimeError(f"served {len(streams)} of {args.requests} requests")
    pool = sum(t.numel() * t.element_size() for layer in s.engine.cache for t in layer
               if t is not None)
    return {"layout": "paged", "device": str(s.engine.device), "tp": cfg.tp_size,
            **s.metrics(), "pool_bytes": pool, "streams_sha256": streams_digest(streams),
            "wall_s": time.perf_counter() - t0, "streams": streams}


def _rank_main(local_rank: int, argv: List[str], rendezvous: str, result: str) -> None:
    """One tensor-parallel rank: join the group, take a card (or the CPU),
    serve; rank 0 checks every rank's streams equal and writes the
    metrics to ``result``."""
    args = _parse(argv)
    backend = "gloo" if args.device == "cpu" else "nccl"
    distributed.init_process_group(backend, init_method=rendezvous, world_size=args.tp,
                                   rank=local_rank)
    try:
        device = distributed.rank_device(args.device or "cuda", local_rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        mesh = make_mesh(1, 1, args.tp)
        t0 = time.perf_counter()
        metrics = _serve_paged(args, _config(args), t0, device=device, mesh=mesh)
        streams = metrics["streams"]
        every: List[Optional[dict]] = [None] * args.tp
        torch.distributed.all_gather_object(every, streams, group=mesh.model_cpu.group)
        if distributed.is_primary():
            if any(other != streams for other in every):
                raise RuntimeError("the tensor-parallel ranks' streams differ: "
                                   + str([streams_digest(x) for x in every]))
            with open(result, "w") as f:
                json.dump(dict(metrics, ranks_equal=True), f)
    finally:
        distributed.destroy_process_group()


def _serve_tp(args, argv: List[str]) -> dict:
    """``--tp`` T ranks spawned over a ``file://`` rendezvous; rank 0's
    metrics."""
    if args.device != "cpu":
        cards = torch.cuda.device_count()
        if args.tp > cards:
            raise SystemExit(
                f"--tp {args.tp} needs a card per rank (NCCL puts one rank on a card), "
                f"and {cards} are visible; use fewer, or --device cpu to run the ranks "
                "over gloo")
        from pytorch_distributed_tpu_torch.ops import _build

        _build.build(["paged_attention"])  # here, so the ranks only load it
    with tempfile.TemporaryDirectory() as tmp:
        result = os.path.join(tmp, "metrics.json")
        distributed.spawn(_rank_main, args.tp,
                          (argv, f"file://{os.path.join(tmp, 'rendezvous')}", result))
        with open(result) as f:
            metrics = json.load(f)
    metrics["streams"] = {int(rid): toks for rid, toks in metrics["streams"].items()}
    return metrics


def _config(args) -> TransformerConfig:
    cfg = tiny_config(max_seq_len=128) if args.tiny else full_config()
    if args.tp > 1:
        cfg = dataclasses.replace(cfg, tp_size=args.tp, model_axis="model",
                                  vocab_parallel=args.vocab_parallel)
    return cfg


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parse(argv)
    cfg = _config(args)
    t0 = time.perf_counter()
    if args.tp > 1:
        metrics = _serve_tp(args, list(argv if argv is not None else sys.argv[1:]))
        print(json.dumps({k: v for k, v in metrics.items() if k != "streams"}, indent=2))
        return metrics
    if args.fleet:
        metrics = _serve_fleet(args, cfg, t0)
        print(json.dumps(metrics, indent=2))
        return metrics
    if args.dense:
        metrics = _serve_dense(args, cfg, t0)
        if metrics["completed"] != args.requests:
            raise RuntimeError(f"served {metrics['completed']} of {args.requests} requests")
        print(json.dumps(metrics, indent=2))
        return metrics
    metrics = _serve_paged(args, cfg, t0, device=args.device)
    print(json.dumps({k: v for k, v in metrics.items() if k != "streams"}, indent=2))
    return metrics


if __name__ == "__main__":
    main()
