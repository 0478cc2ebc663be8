"""Tensor-parallel serving over NCCL against one card: the serve's figures
at ``--tp`` 1, 2 and 4 in one process, and ``generate_tp`` against
``generate``.

    python -m pytorch_distributed_tpu_torch.tools.serve_tp_bench [--tps 2,4]

Run on a machine with a card for each rank of the largest ``--tps``. For
the bf16 and the fp8 pool in turn it serves ``recipes/serve_lm.py``'s
full-width LM (random weights from seed 0) through the recipe itself:
``--warmup`` (every program a CUDA graph before traffic, under TP the
graphs holding the NCCL all-reduces), 16 requests of 64-1024 prompt tokens
and 32 new tokens, greedy, 8 slots, blocks of 16, chunk 32, the default
1025-block pool; one card first, then each ``--tp`` T (T ranks, a card
each), then one card again (the card's drift over the call). Each run
prints tok/s, tick p50, TTFT p50, a rank's pool bytes and its share of one
card's, the greedy match with the first one-card run and whether the
ranks' streams were bit-equal. Then ``generate_tp`` at T 2 on 8 prompts of
128 tokens, 32 new, against one-card ``generate`` from the same weights
(``tools/parallel_check.py``'s ``"serve"`` task). The last line is a JSON
object of every figure, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
from typing import List, Optional

import numpy as np
import torch

SERVE = ["--warmup", "--requests", "16", "--max-new", "32", "--prompt-range", "64", "1025"]
KEEP = ("tokens_per_s", "tick_p50_s", "ttft_p50_s", "pool_bytes", "cold_requests", "graphs",
        "compile_s", "wall_s", "tokens_out")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def match_rate(a: dict, b: dict) -> float:
    """Share of equal tokens at equal places of two ``{rid: tokens}``."""
    return float(np.mean([x == y for rid in a for x, y in zip(a[rid], b[rid])]))


def serves(tps: List[int], card: str) -> dict:
    from pytorch_distributed_tpu_torch.recipes import serve_lm

    out = {}
    for kv in (None, "fp8"):
        flags = SERVE + (["--kv-dtype", kv] if kv else [])
        pool = kv or "bf16"
        runs = []
        for t in [1, *tps, 1]:
            m = serve_lm.main(flags + (["--tp", str(t)] if t > 1 else []))
            runs.append((t, m))
        first = runs[0][1]
        rows = []
        for t, m in runs:
            row = {k: m.get(k) for k in KEEP}
            row.update(tp=t, pool_share=m["pool_bytes"] / first["pool_bytes"],
                       match=match_rate(m["streams"], first["streams"]),
                       ranks_equal=m.get("ranks_equal", t == 1))
            rows.append(row)
            print(f"serve {pool} pools at --tp {t} on {card}: {row['tokens_per_s']:.1f} tok/s, "
                  f"tick p50 {row['tick_p50_s'] * 1e3:.3f} ms, TTFT p50 "
                  f"{row['ttft_p50_s'] * 1e3:.1f} ms; a rank's pool {row['pool_bytes']} bytes "
                  f"({row['pool_share']:.4f} of one card's); greedy match with one card "
                  f"{row['match']:.3f}; ranks' streams bit-equal {row['ranks_equal']}; "
                  f"{row['graphs']} graphs, {row['cold_requests']} cold requests", flush=True)
        out[pool] = rows
    return out


def generate_check(card: str) -> dict:
    """``generate_tp`` at T 2 against one-card ``generate`` (rank 0's
    reference), 8 prompts of 128 tokens, 32 new, greedy."""
    from pytorch_distributed_tpu_torch.recipes.serve_lm import full_config
    from pytorch_distributed_tpu_torch.tools import parallel_check

    cfg = full_config()
    rng = np.random.default_rng(3)
    prompts = list(rng.integers(1, cfg.vocab_size, (8, 128)).astype(np.int32))
    model = dict(vocab_size=cfg.vocab_size, num_layers=cfg.num_layers,
                 num_heads=cfg.num_heads, embed_dim=cfg.embed_dim,
                 max_seq_len=cfg.max_seq_len, dtype="bfloat16", attention="dense",
                 tp_size=2, model_axis="model")
    with tempfile.TemporaryDirectory() as tmp:
        job = dict(task="serve", backend="nccl", device="cuda", mp=2, timeout_s=600,
                   rendezvous=f"file://{tmp}/rendezvous", out=f"{tmp}/out",
                   cases={"generate": dict(kind="generate", model=model, prompts=prompts,
                                           max_new=32, reference=True)})
        parallel_check.run(job, 2)
        res = parallel_check.load(job)
    got, want = res[0]["generate"]["streams"], res[0]["generate"]["reference"]["streams"]
    new = slice(128, None)
    match = float((got[:, new] == want[:, new]).float().mean())
    ranks = bool(torch.equal(got, res[1]["generate"]["streams"]))
    print(f"generate_tp at T 2 (8 prompts x 128 tokens, 32 new, greedy) on {card}: greedy "
          f"match with one-card generate {match:.3f}, ranks bit-equal {ranks}", flush=True)
    return {"match": match, "ranks_equal": ranks}


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tps", default="2,4", help="tensor-parallel degrees, comma-separated")
    args = p.parse_args(argv)
    tps = [int(x) for x in args.tps.split(",")]
    if not torch.cuda.is_available() or torch.cuda.device_count() < max(tps):
        raise SystemExit(f"--tps {args.tps} needs {max(tps)} cards; "
                         f"{torch.cuda.device_count()} are visible")
    card = card_line()
    out = {"card": card, "serve": serves(tps, card), "generate_tp": generate_check(card)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
