"""Transformer LM pretraining (the port of ``recipes/lm_pretrain.py``).

Trains the repo's full-width LM (vocab 32000, 12 layers, 12 heads, width
768, 2048 positions, bf16 compute, fp32 parameters) through ``LMTrainer``,
its attention in the CUDA FlashAttention kernels by default:

    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --synthetic --steps 8
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --tokens corpus.npy
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --synthetic --seq-parallel 2
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --synthetic --steps 8 \
        --kv-heads 4 --pos-embedding rope --dropout 0.1
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --device cpu --tiny \
        --seq-parallel 2 [--ring-layout zigzag]
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --synthetic --steps 8 --fsdp
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --synthetic --steps 8 \
        --pipeline-stages 2 [--pp-microbatches 8]
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --device cpu --tiny --fsdp
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --device cpu --tiny \
        --pipeline-stages 2
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --synthetic --steps 8 \
        --model-parallel 2 [--vocab-parallel] [--fsdp]
    python -m pytorch_distributed_tpu_torch.recipes.lm_pretrain --device cpu --tiny \
        --model-parallel 2 [--vocab-parallel] [--fsdp]

Without ``--device`` it runs on CUDA and fails where there is none. Token
data is a flat int array (.npy) windowed to ``--seq-len``; ``--synthetic``
makes deterministic fake tokens (``--steps`` batches of them). ``--kv-heads``
(grouped-query attention), ``--pos-embedding rope`` and ``--dropout`` shape
the full-width model as in the JAX recipe; ``--tiny`` takes ``--dropout``
alone, as there.

On CUDA every visible card (on every node) takes one rank, and the grid
is factored as the JAX recipe factors its devices: ``--seq-parallel S``
sequence shards a replica, ``--model-parallel T`` tensor-parallel ranks
or ``--pipeline-stages P`` pipeline stages (the model axis), ``cards //
(S·T)`` data replicas (``parallel.mesh``); the ranks are spawned here and
meet over NCCL, and a grid that is larger than the cards or does not
divide them is refused (``CUDA_VISIBLE_DEVICES`` picks the cards). With
``--device cpu`` one replica of S·T ranks meets over gloo.
``--model-parallel T`` splits every block's heads and MLP features over
the T ranks (Megatron tensor parallelism, ``parallel.tensor``; the heads,
the K/V heads and the MLP width must divide by T) and ``--vocab-parallel``
the embedding's and head's vocabulary too (the vocabulary must divide by
T); both compose with ``--fsdp``, which shards what they leave whole. ``--fsdp`` shards the parameters and AdamW's moments over the
data replicas (ZeRO-3, ``parallel.fsdp``; on one replica the data axis
has size 1 and nothing is split); the
pipeline (``train.pp``) trains with ``--pp-microbatches`` microbatches,
overrides ``--seq-parallel`` to 1 and refuses ``--model-parallel``, as the
JAX recipe does, and ``--vocab-parallel`` needs ``--model-parallel`` above
1 and refuses the pipeline. Each row of the grid runs ring
attention (``ring_flash`` unless ``--attention ring``, as in the JAX
recipe); gradients are summed over the data and seq ranks. The ranks rendezvous where
``MASTER_IP``/``MASTER_PORT`` say (``WORLD_SIZE`` nodes, this one ``RANK``;
each node spawns its share of the ranks), else through a file in a
temporary directory. ``--seq-parallel`` defaults to 1 where the JAX recipe
has 2: the port's default run is one card.

Checkpoints go to ``--save-dir`` (``output_lm``): ``latest.ckpt`` when a
suspend arrives (SIGTERM, SIGUSR1, the file named by ``SUSPEND_FLAG_FILE``;
every rank watches, and the ranks agree at the next step), then the run
exits 0 and a second run with the same ``--save-dir`` resumes there;
``step-<N>.ckpt`` every ``--save-every-n-steps`` (the newest
``--keep-last-ckpts`` kept); ``best.ckpt`` on a lower validation
perplexity. ``--nan-guard --max-bad-steps K`` rolls back to the newest
checkpoint after K skipped steps in a row; ``--watchdog-timeout`` dumps
the stacks of a stalled run and suspends it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data import SyntheticTokens, TokenArrayDataset
from pytorch_distributed_tpu_torch.models.transformer import (
    TransformerConfig,
    tiny_config,
)
from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.parallel.mesh import MODEL_AXIS, global_batch_size, make_mesh
from pytorch_distributed_tpu_torch.recipes.common import add_lm_parallel_flags, add_resilience_flags
from pytorch_distributed_tpu_torch.train import LMTrainer, LMTrainerConfig
from pytorch_distributed_tpu_torch.utils.suspend import SuspendWatcher


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
    p.add_argument("--kv-heads", type=int, default=None,
                   help="grouped-query attention: K/V head count (must "
                        "divide --heads; default = MHA). Shrinks the "
                        "decode KV cache and kv projection by the group "
                        "factor")
    p.add_argument("--pos-embedding", default="learned",
                   choices=["learned", "rope"],
                   help="position encoding: GPT-2-style learned wpe table "
                        "or rotary (q/k rotation in attention, no table)")
    p.add_argument("--embed-dim", type=int, default=768)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--attention", default="flash",
                   choices=["dense", "blockwise", "flash", "ring", "ring_flash"],
                   help="the CUDA FlashAttention kernels, or plain PyTorch (dense, "
                        "or blockwise: K/V blocks with an online softmax); with "
                        "--seq-parallel > 1 ring_flash (the kernels per ring visit) "
                        "unless ring (plain PyTorch) is asked for")
    p.add_argument("--batch-size", type=int, default=None,
                   help="sequences per step (default 8; 2 with --tiny)")
    p.add_argument("--epochs", type=int, default=None,
                   help="default 1 (2 with --tiny)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--grad-clip-norm", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off)")
    add_resilience_flags(p, "output_lm")
    p.add_argument("--save-every-n-steps", type=int, default=0,
                   help="a non-blocking step-<N>.ckpt every N steps (0 = off, the "
                        "reference's suspend and best saves only)")
    p.add_argument("--keep-last-ckpts", type=int, default=3,
                   help="step checkpoints kept with --save-every-n-steps")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="sequence shards per replica, attending round a ring "
                        "(the data replicas are the cards // this)")
    p.add_argument("--ring-layout", default="contiguous", choices=["contiguous", "zigzag"],
                   help="ring shards: contiguous, or chunk pairs (r, 2s-1-r)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="tensor-parallel ranks a replica (Megatron: heads and MLP "
                        "features split over them)")
    p.add_argument("--vocab-parallel", action="store_true",
                   help="with --model-parallel > 1: split the embedding's and LM "
                        "head's vocabulary over the tensor-parallel ranks too")
    add_lm_parallel_flags(p)
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


def model_config(args, seq_len: int, vocab: int) -> TransformerConfig:
    """The tiny or full-width config; on a seq-sharded grid the ring
    (``ring_flash`` unless ``--attention ring``) with ``--ring-layout``."""
    sp, tp = args.seq_parallel, args.model_parallel
    attention = args.attention
    if sp > 1 and attention not in ("ring", "ring_flash"):
        attention = "ring_flash"
    layout = args.ring_layout if sp > 1 else "contiguous"
    tensor = dict(tp_size=tp, model_axis=MODEL_AXIS if tp > 1 else None,
                  vocab_parallel=args.vocab_parallel)
    if args.tiny:
        # as the JAX recipe: the tiny config takes --dropout, not the
        # width flags
        return tiny_config(attention=attention, ring_layout=layout, dropout=args.dropout,
                           **tensor)
    return TransformerConfig(
        vocab_size=vocab, num_layers=args.layers, num_heads=args.heads,
        num_kv_heads=args.kv_heads, pos_embedding=args.pos_embedding,
        embed_dim=args.embed_dim, max_seq_len=seq_len, dropout=args.dropout,
        dtype=torch.bfloat16, attention=attention, ring_layout=layout, **tensor)


def train(args, device=None, mesh=None) -> dict:
    """Build the datasets, the config and the trainer, and fit."""
    batch_size = args.batch_size or (2 if args.tiny else 8)
    train_ds, val_ds, seq_len, vocab = build_token_datasets(args, batch_size)
    model_cfg = model_config(args, seq_len, vocab)
    cfg = LMTrainerConfig(
        epochs=args.epochs if args.epochs is not None else (2 if args.tiny else 1),
        batch_size=batch_size, lr=args.lr, warmup_steps=0 if args.tiny else 2000,
        log_every=args.log_every, seed=args.seed, grad_clip_norm=args.grad_clip_norm,
        save_dir=args.save_dir, save_every_n_steps=args.save_every_n_steps,
        keep_last_ckpts=args.keep_last_ckpts, nan_guard=args.nan_guard,
        max_bad_steps=args.max_bad_steps, watchdog_timeout_s=args.watchdog_timeout,
        fsdp=args.fsdp, pipeline_stages=args.pipeline_stages,
        pp_microbatches=args.pp_microbatches)
    watcher = SuspendWatcher()
    trainer = LMTrainer(model_cfg, train_ds, val_ds, cfg, device=device, mesh=mesh,
                        suspend_watcher=watcher)
    if distributed.is_primary():
        model_axis = "stages" if args.pipeline_stages else "model"
        vp = ", vocab-parallel" if model_cfg.uses_vocab_parallel() else ""
        grid = (f", grid {mesh.data.size} x {mesh.seq.size} x {mesh.model.size} (data x seq "
                f"x {model_axis}), global batch {global_batch_size(mesh, batch_size)}, ring "
                f"layout {model_cfg.ring_layout}{', fsdp' if args.fsdp else ''}{vp}"
                if mesh else "")
        print(f"device {trainer.device}, {trainer.state.param_count()} parameters, "
              f"batch {batch_size} x {seq_len} tokens per replica, attention "
              f"{model_cfg.attention}{grid}")
    try:
        summary = trainer.fit()
    finally:
        watcher.uninstall()  # the caller's handlers again, also after a suspend
    if distributed.is_primary():
        print(json.dumps(summary))
    return summary


def grid(args) -> Tuple[int, int]:
    """``(data replicas, ranks on this node)``. On CUDA every card of every
    node (``WORLD_SIZE`` of the environment contract, else 1) takes a rank
    and the replicas are cards // (``--seq-parallel`` x the model axis:
    stages or ``--model-parallel``), as the JAX recipe factors
    ``jax.device_count()``; on the CPU one replica of that many ranks.
    Refuses a grid the cards cannot hold."""
    sp, mp = args.seq_parallel, model_axis_size(args)
    if sp < 1:
        raise SystemExit("--seq-parallel must be >= 1")
    inner = sp * mp
    nodes = int(os.environ.get("WORLD_SIZE", "1")) if distributed.env_rendezvous() else 1
    if args.device == "cpu":
        if inner % nodes:
            raise SystemExit(f"{inner} ranks do not split over {nodes} nodes")
        return 1, inner // nodes
    cards = torch.cuda.device_count()
    world = max(cards, 1) * nodes  # no card: the one-rank path says so
    axis = "--pipeline-stages" if args.pipeline_stages else "--model-parallel"
    what = (f"--seq-parallel {sp}" if mp == 1 else f"{axis} {mp}"
            if sp == 1 else f"--seq-parallel {sp} x {axis} {mp}")
    if inner > world:
        raise SystemExit(
            f"{what} needs a card per rank (NCCL puts one rank on a "
            f"card), and {cards} per node on {nodes} node(s) are visible; use fewer, "
            "or --device cpu to run the ranks over gloo")
    if world % inner:
        kind = ("sequence groups" if mp == 1 else
                f"groups of {'stages' if args.pipeline_stages else 'model ranks'} x "
                "sequence shards")
        raise SystemExit(f"{world} cards do not split into {kind} of {inner}")
    return world // inner, world // nodes


def _rank_main(local_rank: int, argv: List[str], rendezvous: Optional[str],
               per_node: int, dp: int, result: str) -> None:
    """One rank: join the group, take a card (or the CPU), build the grid,
    train; rank 0 writes the summary to ``result``."""
    args = _parse(argv)
    _check_parallel(args)
    backend = "gloo" if args.device == "cpu" else "nccl"
    world = dp * args.seq_parallel * model_axis_size(args)
    if rendezvous is None:
        distributed.init_process_group(backend, local_rank=local_rank,
                                       procs_per_node=per_node)
    else:
        distributed.init_process_group(backend, init_method=rendezvous,
                                       world_size=world, rank=local_rank)
    try:
        device = distributed.rank_device(args.device or "cuda", local_rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        mesh = make_mesh(dp, args.seq_parallel, model_axis_size(args))
        summary = train(args, device=device, mesh=mesh)
        if distributed.is_primary():
            with open(result, "w") as f:
                json.dump(summary, f)
    finally:
        distributed.destroy_process_group()


def model_axis_size(args) -> int:
    """The mesh's model axis: the pipeline's stages, else the
    tensor-parallel ranks."""
    return args.pipeline_stages or args.model_parallel


def _check_parallel(args) -> None:
    """The JAX recipe's checks of the parallel flags (:79-155): a negative
    stage count is refused, the pipeline refuses --model-parallel and
    --vocab-parallel and overrides --seq-parallel to 1 (in ``args``),
    --vocab-parallel needs --model-parallel > 1."""
    if args.pipeline_stages < 0:
        raise SystemExit(
            f"--pipeline-stages must be >= 1 (or 0 = off), got {args.pipeline_stages}")
    if args.model_parallel < 1:
        raise SystemExit(f"--model-parallel must be >= 1, got {args.model_parallel}")
    if args.pipeline_stages:
        if args.model_parallel > 1:
            raise SystemExit(
                "--pipeline-stages uses the model axis for stages; drop "
                "--model-parallel (TP-within-PP needs the train.pp API "
                "with a dedicated stage axis)")
        if args.vocab_parallel:
            raise SystemExit(
                "--vocab-parallel does not compose with --pipeline-stages "
                "(PPEmbed/PPHead are stage-replicated; train/pp.py)")
        args.seq_parallel = 1
    if args.vocab_parallel and args.model_parallel <= 1:
        raise SystemExit("--vocab-parallel needs --model-parallel > 1")


def main(argv: Optional[List[str]] = None) -> dict:
    args = _parse(argv)
    if args.pipeline_stages > 0 and args.seq_parallel > 1 and distributed.is_primary():
        print(f"pipeline run: overriding --seq-parallel {args.seq_parallel} -> 1 "
              "(PP batches shard over data only)")
    _check_parallel(args)
    if args.save_every_n_steps < 0:
        raise SystemExit(f"--save-every-n-steps must be >= 0 (0 = off), got "
                         f"{args.save_every_n_steps}")
    if args.keep_last_ckpts < 1:
        raise SystemExit(f"--keep-last-ckpts must be >= 1, got {args.keep_last_ckpts}")
    dp, per_node = grid(args)
    if dp * args.seq_parallel * model_axis_size(args) == 1:
        return train(args, device=args.device)
    env = distributed.env_rendezvous()
    if args.device != "cpu":
        _build.build(["flash_attention"])  # here, so the ranks only load it
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = None if env else f"file://{os.path.join(tmp, 'rendezvous')}"
        result = os.path.join(tmp, "summary.json")
        distributed.spawn(_rank_main, per_node,
                          (list(argv if argv is not None else sys.argv[1:]), rendezvous,
                           per_node, dp, result))
        if not os.path.exists(result):
            return {}  # rank 0 ran on another node
        with open(result) as f:
            return json.load(f)


if __name__ == "__main__":
    main()
