"""Shared recipe scaffolding for the image recipes (the port of
``recipes/common.py``): the flags, the datasets, the model, and ``run``,
which builds a ``Trainer`` at the reference's hyperparameters and fits.

Only synthetic data is ported (``--synthetic``, or ``--tiny`` for a CPU
smoke run); the ImageNet record readers, checkpoints and the telemetry
flags come with later slices.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from pytorch_distributed_tpu_torch.data import SyntheticImageClassification
from pytorch_distributed_tpu_torch.models.resnet import BasicBlock, ResNet, resnet50
from pytorch_distributed_tpu_torch.train import Trainer, TrainerConfig


def parse_args(description: str, argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic data (the only data ported so far)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model and data, a smoke run on the CPU")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="batch size (reference default 400)")
    p.add_argument("--device", default=None,
                   help="cuda (the default, which needs a card) or cpu")
    return p.parse_args(argv)


def build_datasets(args):
    """(train, val, image size, classes): the JAX recipe's synthetic sets."""
    if not (args.synthetic or args.tiny):
        raise SystemExit("only --synthetic data is ported: the ImageNet record "
                         "readers come with a later slice (ROADMAP.md)")
    size = 16 if args.tiny else 224
    n_train, n_val = (256, 64) if args.tiny else (8192, 1024)
    classes = 10 if args.tiny else 1000
    return (SyntheticImageClassification(n_train, size, classes),
            SyntheticImageClassification(n_val, size, classes, seed=1), size, classes)


def build_model(args, num_classes: int, precision: str) -> ResNet:
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    if args.tiny:
        return ResNet(stage_sizes=(1, 1), block_cls=BasicBlock, num_classes=num_classes,
                      num_filters=8, dtype=dtype)
    return resnet50(num_classes=num_classes, dtype=dtype)


def run(args, precision: str = "fp32", datasets=None) -> dict:
    """Build everything and fit: the body the image recipes share.
    ``datasets``: ``(train, val, image size, classes)`` in place of
    ``build_datasets(args)``, for a run shorter than an epoch of them."""
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
    )
    trainer = Trainer(model, train_ds, val_ds, cfg, device=args.device)
    print(f"device {trainer.device}, {trainer.state.param_count()} parameters, batch "
          f"{cfg.batch_size} x {image_size}^2, precision {precision}")
    summary = trainer.fit()
    print(f"done: best acc1 {summary.get('best_acc', 0.0):.2f}")
    return summary
