"""Shared recipe scaffolding for the image recipes (the port of
``recipes/common.py``): the flags, the datasets, the model, ``run``, which
builds a ``Trainer`` at the reference's hyperparameters and fits, and
``launch``, which places the ranks of the multi-card recipes.

``build_model`` keeps the JAX mapping (``recipes/common.py``:202-208):
``bf16`` is bf16 compute, ``fp16`` fp32 compute with the dynamic loss
scaler ("AMP" is the model's compute dtype, not ``torch.autocast``).

``launch`` (``resnet_dp``, ``resnet_ddp``, ``resnet_ddp_amp``): on CUDA a
rank a visible card (``CUDA_VISIBLE_DEVICES`` picks them) meeting over
NCCL, on every node of the environment contract (``MASTER_IP``,
``MASTER_PORT``, ``WORLD_SIZE`` nodes, this one ``RANK``; each node spawns
its share of the ranks) where the recipe takes it, else through a
``file://`` rendezvous in a temporary directory; on the CPU
``--cpu-replicas`` gloo ranks (the stand-in for the JAX recipe's XLA host
devices), which the recipes refuse on CUDA. A world of one runs in this
process. The parent builds the tail kernels before it spawns, so the
ranks only load them.

The data, as in JAX (``recipes/common.py``:149-197): ``--synthetic`` (or
``--tiny``, a CPU smoke run) images, else the packed ImageNet splits in
``--data-dir`` (default ``$PDT_IMAGENET_DIR``): ``{train,val}.tprc``
(JPEG, decoded and normalized on the host) or with ``--raw``
``{train,val}.rawtprc`` (uint8, normalized on the device; ``--raw-aug
rrc|crop`` for training, the center crop for validation). Pack them with
``tools/pack_imagenet.py``. The loaders fetch on 8 worker threads (0 with
``--tiny``), two batches ahead. The telemetry flags come with a later
slice. Each run (each rank) watches for a suspend
(``utils.suspend.SuspendWatcher``: SIGTERM, SIGUSR1 or the file named by
``SUSPEND_FLAG_FILE``), saves ``<--save-dir>/latest.ckpt`` and exits 0;
run again with the same ``--save-dir``, it resumes there. The JAX
recipe's resilience flags: ``--nan-guard``, ``--max-bad-steps``,
``--watchdog-timeout``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import List, Optional, Tuple

import torch

from pytorch_distributed_tpu_torch.data import (
    ImageNet,
    RawImageNet,
    SyntheticImageClassification,
)
from pytorch_distributed_tpu_torch.data.imagenet import DEFAULT_DATA_DIR
from pytorch_distributed_tpu_torch.models.resnet import BasicBlock, ResNet, resnet50
from pytorch_distributed_tpu_torch.ops import _build
from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.parallel.mesh import Mesh, global_batch_size, make_mesh
from pytorch_distributed_tpu_torch.train import Trainer, TrainerConfig
from pytorch_distributed_tpu_torch.utils.suspend import SuspendWatcher


def add_resilience_flags(p: argparse.ArgumentParser, save_dir: str) -> None:
    """The checkpoint and guard flags the JAX recipes share
    (``recipes/common.py``:59-80 of the JAX package)."""
    p.add_argument("--save-dir", default=save_dir,
                   help="checkpoint directory: latest.ckpt on a suspend, best.ckpt on "
                        "a better validation metric; a run resumes from it")
    p.add_argument("--nan-guard", action="store_true",
                   help="skip a step whose loss or gradient is not finite")
    p.add_argument("--max-bad-steps", type=int, default=0,
                   help="with --nan-guard: after this many skipped steps in a row, "
                        "roll back to the last good checkpoint (0 = skip only)")
    p.add_argument("--watchdog-timeout", type=float, default=0.0,
                   help="seconds without a completed step before the watchdog dumps "
                        "every thread's stack and latches the suspend (0 = off)")


def add_lm_parallel_flags(p: argparse.ArgumentParser) -> None:
    """The LM recipe's ZeRO and pipeline flags (``recipes/common.py``
    :298-309 of the JAX package)."""
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-shard replicated params/optimizer over the "
                        "data axis (gather/scatter in the step; composes with SP)")
    p.add_argument("--pipeline-stages", type=int, default=0,
                   help="train through the GPipe pipeline with this many "
                        "stages on the model axis (0 = off; excludes "
                        "--model-parallel/--seq-parallel)")
    p.add_argument("--pp-microbatches", type=int, default=8,
                   help="GPipe microbatches per step (clamped to the "
                        "per-shard batch; 8 is the JAX package's measured default)")


def parse_args(description: str, argv: Optional[List[str]] = None,
               replicas: bool = False) -> argparse.Namespace:
    """The image recipes' flags; ``replicas`` adds the multi-card recipes'
    ``--cpu-replicas``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--synthetic", action="store_true", help="synthetic data")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model and data, a smoke run on the CPU")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="batch size per replica (reference default 400)")
    p.add_argument("--device", default=None,
                   help="cuda (the default, which needs a card) or cpu")
    p.add_argument("--data-dir", default=None,
                   help="packed ImageNet directory (default $PDT_IMAGENET_DIR)")
    p.add_argument("--raw", action="store_true",
                   help="read the decode-free raw split (<data-dir>/{train,val}.rawtprc; "
                        "pack with tools/pack_imagenet.py --raw)")
    p.add_argument("--raw-aug", default="rrc", choices=["rrc", "crop"],
                   help="raw-split train augmentation: rrc keeps the reference's "
                        "RandomResizedCrop semantics (on the stored 256px image, PIL); "
                        "crop is the classic random crop and flip (no PIL), a different "
                        "training distribution")
    add_resilience_flags(p, "output")
    if replicas:
        p.add_argument("--cpu-replicas", type=int, default=1,
                       help="with --device cpu: data replicas, one gloo rank each "
                            "(on CUDA every visible card is a replica)")
    return p.parse_args(argv)


def build_datasets(args):
    """(train, val, image size, classes): the JAX recipe's synthetic sets,
    or the packed splits of ``--data-dir``."""
    if args.synthetic or args.tiny:
        size = 16 if args.tiny else 224
        n_train, n_val = (256, 64) if args.tiny else (8192, 1024)
        classes = 10 if args.tiny else 1000
        return (SyntheticImageClassification(n_train, size, classes),
                SyntheticImageClassification(n_val, size, classes, seed=1), size, classes)
    data_dir = args.data_dir or DEFAULT_DATA_DIR
    if args.raw:
        return (RawImageNet("train", data_dir=data_dir, aug=args.raw_aug),
                RawImageNet("val", data_dir=data_dir, aug="none"), 224, 1000)
    return ImageNet("train", data_dir=data_dir), ImageNet("val", data_dir=data_dir), 224, 1000


def build_model(args, num_classes: int, precision: str) -> ResNet:
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    if args.tiny:
        return ResNet(stage_sizes=(1, 1), block_cls=BasicBlock, num_classes=num_classes,
                      num_filters=8, dtype=dtype)
    return resnet50(num_classes=num_classes, dtype=dtype)


def run(args, mesh: Optional[Mesh] = None, precision: str = "fp32", datasets=None,
        device=None) -> dict:
    """Build everything and fit: the body the image recipes share, on one
    device or as this rank of ``mesh``. ``datasets``: ``(train, val, image
    size, classes)`` in place of ``build_datasets(args)``, for a run
    shorter than an epoch of them."""
    train_ds, val_ds, image_size, num_classes = datasets or build_datasets(args)
    model = build_model(args, num_classes, precision)
    cfg = TrainerConfig(
        epochs=args.epochs if args.epochs is not None else (2 if args.tiny else 100),
        batch_size=args.batch_size if args.batch_size is not None else (4 if args.tiny else 400),
        lr=0.1 if not args.tiny else 0.05,
        momentum=0.9,
        weight_decay=1e-4,
        lr_step_epochs=30,
        lr_gamma=0.1,
        precision=precision,
        save_dir=args.save_dir,
        num_workers=0 if args.tiny else 8,
        nan_guard=args.nan_guard,
        max_bad_steps=args.max_bad_steps,
        watchdog_timeout_s=args.watchdog_timeout,
    )
    watcher = SuspendWatcher()
    trainer = Trainer(model, train_ds, val_ds, cfg,
                      device=device if device is not None else args.device, mesh=mesh,
                      suspend_watcher=watcher)
    if distributed.is_primary():
        grid = (f", {mesh.data.size} replicas ({distributed.node_count()} node(s)), global "
                f"batch {global_batch_size(mesh, cfg.batch_size)}" if mesh else "")
        print(f"device {trainer.device}, {trainer.state.param_count()} parameters, batch "
              f"{cfg.batch_size} x {image_size}^2 per replica{grid}, precision {precision}")
    try:
        summary = trainer.fit()
    finally:
        watcher.uninstall()  # the caller's handlers again, also after a suspend
    if distributed.is_primary():
        print(f"done: best acc1 {summary.get('best_acc', 0.0):.2f}")
    return summary


def grid(args, multi_node: bool) -> Tuple[int, int]:
    """``(data replicas, ranks on this node)``: on CUDA a rank a visible
    card on each node (``WORLD_SIZE`` nodes of the environment contract
    when ``multi_node`` and it is set, else 1); on the CPU
    ``--cpu-replicas`` ranks on this node, which CUDA refuses."""
    if args.cpu_replicas < 1:
        raise SystemExit("--cpu-replicas must be >= 1")
    nodes = (int(os.environ.get("WORLD_SIZE", "1"))
             if multi_node and distributed.env_rendezvous() else 1)
    if args.device == "cpu":
        return args.cpu_replicas * nodes, args.cpu_replicas
    if args.cpu_replicas != 1:
        raise SystemExit("--cpu-replicas is for --device cpu: on CUDA every visible card "
                         "is a replica (CUDA_VISIBLE_DEVICES picks them)")
    cards = max(torch.cuda.device_count(), 1)  # no card: the one-rank path says so
    return cards * nodes, cards


def _rank_main(local_rank: int, argv: List[str], precision: str,
               rendezvous: Optional[str], per_node: int, world: int, result: str,
               datasets) -> None:
    """One rank: join the group, take a card (or the CPU), build the data
    mesh, fit; rank 0 writes the summary to ``result``."""
    args = parse_args("", argv, replicas=True)
    backend = "gloo" if args.device == "cpu" else "nccl"
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
        summary = run(args, make_mesh(world), precision, datasets, device=device)
        if distributed.is_primary():
            with open(result, "w") as f:
                json.dump(summary, f)
    finally:
        distributed.destroy_process_group()


def launch(description: str, precision: str, multi_node: bool,
           argv: Optional[List[str]] = None, datasets=None) -> dict:
    """Parse ``argv`` and fit on the replicas of ``grid``: in this process
    for a world of one, else spawned ranks (module docstring). Returns rank
    0's summary ({} on another node). ``datasets`` as ``run`` takes it."""
    argv = list(argv if argv is not None else sys.argv[1:])
    args = parse_args(description, argv, replicas=True)
    world, per_node = grid(args, multi_node)
    if world == 1:
        return run(args, None, precision, datasets)
    env = distributed.env_rendezvous() if multi_node else None
    if args.device != "cpu":
        _build.build(["bottleneck_tail"])  # here, so the ranks only load it
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = None if env else f"file://{os.path.join(tmp, 'rendezvous')}"
        result = os.path.join(tmp, "summary.json")
        distributed.spawn(_rank_main, per_node,
                          (argv, precision, rendezvous, per_node, world, result, datasets))
        if not os.path.exists(result):
            return {}  # rank 0 ran on another node
        with open(result) as f:
            return json.load(f)
