"""Transformer LM pretraining on one card (the port of ``recipes/lm_pretrain.py``).

Trains the repo's full-width LM (vocab 32000, 12 layers, 12 heads, width
768, 2048 positions, bf16 compute, fp32 parameters) through ``LMTrainer``,
its attention in the CUDA FlashAttention kernels by default:

    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --synthetic --steps 8
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --tokens corpus.npy
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --device cpu --tiny

Without ``--device`` it runs on CUDA and fails where there is none. Token
data is a flat int array (.npy) windowed to ``--seq-len``; ``--synthetic``
makes deterministic fake tokens (``--steps`` batches of them). Sequence and
tensor parallelism are refused: the port trains on one card.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data import SyntheticTokens, TokenArrayDataset
from pytorch_distributed_tpu_torch.models.transformer import (
    TransformerConfig,
    tiny_config,
)
from pytorch_distributed_tpu_torch.train import LMTrainer, LMTrainerConfig


def _parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default, which needs a card) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny test config on synthetic tokens (32 positions)")
    p.add_argument("--synthetic", action="store_true", help="fake tokens, no corpus")
    p.add_argument("--steps", type=int, default=None,
                   help="synthetic train set of this many batches (one epoch)")
    p.add_argument("--tokens", default=None,
                   help="flat int token array (.npy), windowed to --seq-len")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--embed-dim", type=int, default=768)
    p.add_argument("--attention", default="flash", choices=["flash", "dense"],
                   help="the CUDA FlashAttention kernels, or plain PyTorch")
    p.add_argument("--batch-size", type=int, default=None,
                   help="sequences per step (default 8; 2 with --tiny)")
    p.add_argument("--epochs", type=int, default=None,
                   help="default 1 (2 with --tiny)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--grad-clip-norm", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off)")
    p.add_argument("--nan-guard", action="store_true",
                   help="skip a step whose loss or gradient is not finite")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="must be 1: ring attention is not ported")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="must be 1: tensor parallelism is not ported")
    return p.parse_args(argv)


def build_token_datasets(args, batch_size: int):
    """(train, val, seq_len, vocab): synthetic as the JAX recipe makes them
    (4096 train sequences, or ``--steps`` batches), or windows of a corpus
    with its last 1% held out."""
    if args.synthetic or args.tiny:
        vocab = 128 if args.tiny else args.vocab_size
        seq = 32 if args.tiny else args.seq_len
        n = args.steps * batch_size if args.steps else (64 if args.tiny else 4096)
        return (SyntheticTokens(n, seq, vocab), SyntheticTokens(max(n // 8, 8), seq, vocab,
                                                                 seed=1), seq, vocab)
    if not args.tokens:
        raise SystemExit("--tokens <corpus.npy> required without --synthetic")
    tokens = np.load(args.tokens, mmap_mode="r")
    n_val = max(len(tokens) // 100, args.seq_len)
    return (TokenArrayDataset(tokens[:-n_val], args.seq_len),
            TokenArrayDataset(tokens[-n_val:], args.seq_len), args.seq_len, args.vocab_size)


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parse(argv)
    if args.seq_parallel > 1 or args.model_parallel > 1:
        raise SystemExit(
            "--seq-parallel/--model-parallel > 1 are not ported yet: the port "
            "trains on one card; ring sequence parallelism and tensor "
            "parallelism come with later slices (ROADMAP.md)")
    batch_size = args.batch_size or (2 if args.tiny else 8)
    train_ds, val_ds, seq_len, vocab = build_token_datasets(args, batch_size)
    if args.tiny:
        model_cfg = tiny_config(attention=args.attention)
    else:
        model_cfg = TransformerConfig(
            vocab_size=vocab, num_layers=args.layers, num_heads=args.heads,
            embed_dim=args.embed_dim, max_seq_len=seq_len, dtype=torch.bfloat16,
            attention=args.attention)
    cfg = LMTrainerConfig(
        epochs=args.epochs if args.epochs is not None else (2 if args.tiny else 1),
        batch_size=batch_size, lr=args.lr, warmup_steps=0 if args.tiny else 2000,
        log_every=args.log_every, seed=args.seed, grad_clip_norm=args.grad_clip_norm,
        nan_guard=args.nan_guard)
    trainer = LMTrainer(model_cfg, train_ds, val_ds, cfg, device=args.device)
    print(f"device {trainer.device}, {trainer.state.param_count()} parameters, "
          f"batch {batch_size} x {seq_len} tokens, attention {model_cfg.attention}")
    summary = trainer.fit()
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
