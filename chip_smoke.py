"""Chip smoke for the PyTorch/CUDA port (``pytorch_distributed_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU (an H100):

    python3 chip_smoke.py

Phases, each of which fails the run:

  (a) the card's name and power limit; the CUDA kernels build from
      ``pytorch_distributed_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
  (b) each kernel against the plain PyTorch version on the card, at the
      full-width serving shapes and at small GQA / padding-row shapes;
  (c) the port's main path: ``Scheduler`` serves 16 requests through the
      full-width LM (32000 vocab, 12 layers, 12 heads, width 768, 2048
      positions, bf16, random weights from seed 0), with the launch
      counters reset just before and read just after; then the final
      prefill logits of the kernel path against a plain-attention run;
  (d) kernel, plain-version and library (SDPA on pre-gathered K/V) times at
      the decode shape, beside each kernel's bound;
  (e) one JSON line listing every kernel;
  (f) the last line: ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, without a CUDA device or outside
the repository. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
BF16_TOL = 2e-2  # bf16 output, p rounded to bf16 before PV
FP32_TOL = 1e-4
SPLIT_VS_SWEEP_TOL = 1e-3  # another fp32 summation order (paged_flash.py:278)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def decode_inputs(torch, dtype, *, b=8, c=1, h=12, h_kv=12, d=64, bl=16, w=128,
                  seed=0, positions=None):
    """A full-size pool (every slot can hold 2048 positions, plus trash)
    filled with noise, trash included; ragged chains with trash tails."""
    rng = np.random.default_rng(seed)
    n_blocks = b * w + 1
    k_pool = torch.from_numpy(rng.standard_normal((n_blocks, bl, h_kv, d), np.float32))
    v_pool = torch.from_numpy(rng.standard_normal((n_blocks, bl, h_kv, d), np.float32))
    if positions is None:
        last = rng.integers(64, w * bl, size=b)
        last[0] = w * bl - 1
        positions = last[:, None] - c + 1 + np.arange(c)[None, :]
    positions = np.asarray(positions, np.int64)
    tables = np.zeros((b, w), np.int32)
    order = rng.permutation(np.arange(1, n_blocks))
    for i in range(b):
        n = int(positions[i].max()) // bl + 1 if positions[i].max() >= 0 else 0
        tables[i, :n] = order[i * w:i * w + n]
    q = torch.from_numpy(rng.standard_normal((b, c, h, d), np.float32))
    dev = "cuda"
    return dict(q=q.to(dev, dtype), k_pool=k_pool.to(dev, dtype),
                v_pool=v_pool.to(dev, dtype),
                block_tables=torch.from_numpy(tables).to(dev),
                q_positions=torch.from_numpy(positions).to(dev, torch.int32))


def bound(inp) -> dict:
    """Least time for the work these inputs need: each visible K/V row
    read once, q, positions and tables read once, the output written
    once; QK and PV at 2 flops per multiply-add for each visible key."""
    q, kp = inp["q"], inp["k_pool"]
    b, c, h, d = q.shape
    h_kv = kp.shape[2]
    elem = q.element_size()
    pos = inp["q_positions"].cpu().numpy()
    visible_rows = int(np.maximum(pos.max(axis=1) + 1, 0).sum())  # per batch row
    n_bytes = (2 * visible_rows * h_kv * d * elem + 2 * q.numel() * elem
               + inp["q_positions"].numel() * 4 + inp["block_tables"].numel() * 4)
    flops = 4 * d * h * float(np.maximum(pos + 1, 0).sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(q.dtype)]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "flops": flops}


def time_ms(torch, fn, iters=100, warmup=5):
    """Mean CUDA-event time of ``fn`` with the 50 MB L2 flushed before each
    call, as a layer's attention finds it in the serving loop (12 layers
    of pools stream through between two calls on one layer). A ~1 ms spin
    on the card before each start event lets the host enqueue ``fn``
    before the card reaches it, so host time stays out of the reading."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # cycles
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax
    from pytorch_distributed_tpu_torch.ops import _build, paged_flash
    from pytorch_distributed_tpu_torch.ops.attention import paged_attention_reference
    from pytorch_distributed_tpu_torch.recipes.serve_lm import full_config
    from pytorch_distributed_tpu_torch.serving import PagedEngine, Scheduler
    from pytorch_distributed_tpu_torch.serving.engine import ChunkJob

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"(a) card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- (a) build every kernel source, one nvcc each, all at once ----
    t0 = time.perf_counter()
    paths = _build.build(_build.kernel_sources())
    print(f"(a) built {sorted(paths)} in {time.perf_counter() - t0:.1f}s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas {name}: {line.strip()}")

    # ---- (b) kernels against the plain version on the card ----
    failures = []

    def check(label, got, want, tol):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = err <= tol and torch.isfinite(got).all().item()
        print(f"(b) {label}: max_abs_err {err:.3e} (tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label)
        return err

    bf16, f32 = torch.bfloat16, torch.float32
    decode_bf16 = decode_inputs(torch, bf16)
    ref_decode = paged_attention_reference(**decode_bf16)
    errs = {
        paged_flash.SWEEP: check(
            "decode B=8 C=1 H=12 D=64 W=128 bf16, sweep",
            paged_flash.paged_flash_attention(**decode_bf16, split_s=1),
            ref_decode, BF16_TOL),
        paged_flash.SPLIT: check(
            "decode B=8 C=1 H=12 D=64 W=128 bf16, auto split (S=8)",
            paged_flash.paged_flash_attention(**decode_bf16), ref_decode, BF16_TOL),
    }
    # q as the fused qkv projection hands it over: a view, read through strides
    strided = dict(decode_bf16, q=torch.stack([decode_bf16["q"]] * 3, dim=2)[:, :, 1])
    for split_s in (1, None):
        check(f"decode bf16, q a strided view, split_s={split_s}",
              paged_flash.paged_flash_attention(**strided, split_s=split_s),
              ref_decode, BF16_TOL)
    decode_f32 = decode_inputs(torch, f32, seed=1)
    ref32 = paged_attention_reference(**decode_f32)
    sweep32 = paged_flash.paged_flash_attention(**decode_f32, split_s=1)
    split32 = paged_flash.paged_flash_attention(**decode_f32)
    check("decode fp32, sweep", sweep32, ref32, FP32_TOL)
    check("decode fp32, auto split", split32, ref32, FP32_TOL)
    check("decode fp32, split vs sweep", split32, sweep32, SPLIT_VS_SWEEP_TOL)
    starts = np.array([0, 32, 480, 992])
    chunk = decode_inputs(torch, bf16, b=4, c=32, w=64, seed=2,
                          positions=starts[:, None] + np.arange(32))
    ref_chunk = paged_attention_reference(**chunk)
    for split_s in (1, None):
        check(f"prefill chunk B=4 C=32 W=64 bf16, split_s={split_s}",
              paged_flash.paged_flash_attention(**chunk, split_s=split_s),
              ref_chunk, BF16_TOL)
    # GQA (4 query heads per KV head), padding rows (-1) and a fully masked
    # row, R = G*C = 20 rows: two row tiles per KV head
    pos = np.array([[40, 41, 42, 43, 44], [3, 9, -1, -1, -1], [-1] * 5])
    for dtype, tol in ((bf16, BF16_TOL), (f32, FP32_TOL)):
        gqa = decode_inputs(torch, dtype, b=3, c=5, h=8, h_kv=2, w=8, seed=3,
                            positions=pos)
        ref = paged_attention_reference(**gqa)
        for split_s in (1, 3):
            check(f"GQA H=8 H_kv=2 C=5 padding rows {dtype}, split_s={split_s}",
                  paged_flash.paged_flash_attention(**gqa, split_s=split_s), ref, tol)
    wide = decode_inputs(torch, f32, b=2, c=2, h=2, h_kv=2, d=128, w=8, seed=4)
    check("D=128 fp32, split_s=2", paged_flash.paged_flash_attention(**wide, split_s=2),
          paged_attention_reference(**wide), FP32_TOL)
    if failures:
        raise SystemExit(f"chip_smoke: kernels disagree with the plain version: {failures}")

    # ---- (c) the main path: serve the full-width model ----
    cfg = full_config()
    state = params_from_jax(init_params(cfg, seed=0))
    serve_kw = dict(n_slots=8, block_len=16, prefill_chunk=32, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(64, 1025, size=16)]
    max_new = 32
    warm = Scheduler(cfg, state, gather_impl="kernel", **serve_kw)
    warm.submit(prompts[0][:40], 2)
    warm.drain()  # cuBLAS handles, allocator pools, the kernel library
    del warm
    sched = Scheduler(cfg, state, gather_impl="kernel", **serve_kw)
    torch.cuda.synchronize()
    paged_flash.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [sched.submit(p, max_new) for p in prompts]
    streams = sched.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(paged_flash.launch_counts)
    m = sched.metrics()
    if sorted(streams) != sorted(rids) or any(
            len(streams[r]) != max_new for r in rids):
        raise SystemExit("chip_smoke: a request did not complete its budget")
    if any(not 0 <= t < cfg.vocab_size for r in rids for t in streams[r]):
        raise SystemExit("chip_smoke: a token outside the vocabulary")
    if sched.engine.allocator.in_use != 0:
        raise SystemExit(f"chip_smoke: {sched.engine.allocator.in_use} blocks leaked")
    if not all(launches[k] > 0 for k in (paged_flash.SWEEP, paged_flash.SPLIT)):
        raise SystemExit(f"chip_smoke: a kernel never ran on the main path: {launches}")
    # one decode tick, all 8 lanes armed, launches per tick
    paged_flash.reset_launch_counts()
    eng = sched.engine
    for slot in range(8):
        eng.admit(slot, 64, 1)
    eng.decode(np.full(8, 64), np.ones(8, bool))
    per_tick = dict(paged_flash.launch_counts)
    eng.release_all()
    print(f"(c) served {len(rids)} requests x {max_new} tokens, prompts 64-1024, "
          f"on {card}: wall {wall:.3f}s, {m['tokens_out'] / wall:.1f} tok/s, "
          f"{m['steps']} ticks, TTFT p50 {m['ttft_p50_s'] * 1e3:.1f} ms p95 "
          f"{m['ttft_p95_s'] * 1e3:.1f} ms, token gap p50 "
          f"{m['token_lat_p50_s'] * 1e3:.2f} ms, tick p50 {m['tick_p50_s'] * 1e3:.2f} ms")
    print(f"(c) launches during the serve: {launches}; per decode tick: {per_tick}")
    del sched, eng
    torch.cuda.empty_cache()

    # final-prefill logits: kernel path against a plain-attention engine
    pair = [prompts[1], prompts[2]]
    rows = {}
    for impl in ("kernel", "dense"):
        e = PagedEngine(cfg, state, n_slots=2, block_len=16, prefill_chunk=32,
                        gather_impl=impl, device="cuda")
        for slot, p in enumerate(pair):
            e.admit(slot, len(p), max_new)
        done = [0, 0]
        while any(done[s] < len(pair[s]) for s in range(2)):
            jobs = []
            for s, p in enumerate(pair):
                if done[s] >= len(p):
                    continue
                toks = np.zeros(32, np.int32)
                seg = p[done[s]:done[s] + 32]
                toks[:len(seg)] = seg
                last = done[s] + 32 >= len(p)
                jobs.append(ChunkJob(s, toks, done[s], last,
                                     len(p) - 1 - done[s] if last else 0))
                done[s] += 32
            e.run_chunks(jobs)
        rows[impl] = e.logits.clone()
        del e
    logit_err = (rows["kernel"] - rows["dense"]).abs().max().item()
    greedy = {}
    for impl in ("kernel", "dense"):
        s = Scheduler(cfg, state, gather_impl=impl, **serve_kw)
        ids = [s.submit(p, max_new) for p in pair]
        out = s.drain()
        greedy[impl] = [out[i] for i in ids]
        del s
    match = np.mean([a == b for x, y in zip(greedy["kernel"], greedy["dense"])
                     for a, b in zip(x, y)])
    scale = rows["dense"].abs().max().item()
    print(f"(c) final-prefill logits, kernel vs plain attention, prompts "
          f"{[len(p) for p in pair]}: max_abs_err {logit_err:.4f} (|logits| <= "
          f"{scale:.2f}); greedy token match {match:.3f} over "
          f"{2 * max_new} tokens")
    if not np.isfinite(logit_err) or logit_err > 0.25:
        raise SystemExit("chip_smoke: kernel-path logits far from the plain path")

    # ---- (d) times at the decode shape ----
    import torch.nn.functional as F

    b, c, h, d = decode_bf16["q"].shape
    w = decode_bf16["block_tables"].shape[1]
    bl = decode_bf16["k_pool"].shape[1]
    idx = decode_bf16["block_tables"].long()
    kg = decode_bf16["k_pool"][idx].reshape(b, w * bl, h, d).transpose(1, 2).contiguous()
    vg = decode_bf16["v_pool"][idx].reshape(b, w * bl, h, d).transpose(1, 2).contiguous()
    qg = decode_bf16["q"].transpose(1, 2).contiguous()
    mask = (torch.arange(w * bl, device="cuda")[None, None, None, :]
            <= decode_bf16["q_positions"].long()[:, None, :, None])
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=mask))
    plain_ms = time_ms(torch, lambda: paged_attention_reference(**decode_bf16))
    timed = {
        paged_flash.SWEEP: time_ms(torch, lambda: paged_flash.paged_flash_attention(
            **decode_bf16, split_s=1)),
        paged_flash.SPLIT: time_ms(torch, lambda: paged_flash.paged_flash_attention(
            **decode_bf16)),
    }
    tables32 = decode_bf16["block_tables"].to(torch.int32)
    qpos32 = decode_bf16["q_positions"].to(torch.int32)
    pools = (decode_bf16["q"], decode_bf16["k_pool"], decode_bf16["v_pool"],
             tables32, qpos32)
    bare = {
        paged_flash.SWEEP: time_ms(torch, lambda: paged_flash.launch_sweep(
            *pools, d ** -0.5)),
        paged_flash.SPLIT: time_ms(torch, lambda: paged_flash.launch_split(
            *pools, 8, d ** -0.5)),
    }
    bd = bound(decode_bf16)
    for name in timed:
        print(f"(d) {name} at decode B=8 H=12 D=64 W=128 bf16 on {card}: "
              f"{timed[name] * 1e3:.1f} us per call ({bare[name] * 1e3:.1f} us bare "
              f"launch), plain {plain_ms * 1e3:.1f} us, SDPA on gathered K/V "
              f"{sdpa_ms * 1e3:.1f} us, bound {bd['bound_ms'] * 1e3:.2f} us "
              f"({bd['bound_by']}: {bd['bytes'] / 1e6:.2f} MB, {bd['flops'] / 1e6:.1f} MFLOP)")

    # ---- (e) the kernels line; (f) the result ----
    replaces = {
        paged_flash.SWEEP: "pytorch_distributed_tpu/ops/paged_flash.py:375",
        paged_flash.SPLIT: "pytorch_distributed_tpu/ops/paged_flash.py:430",
    }
    kernels = [{
        "name": name, "route": "cuda",
        "source": "pytorch_distributed_tpu_torch/csrc/paged_attention.cu",
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": errs[name], "ms": timed[name], "plain_ms": plain_ms,
        "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
        "library_ms": sdpa_ms,
    } for name in (paged_flash.SWEEP, paged_flash.SPLIT)]
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
