"""The image-classification trainer on one card
(``pytorch_distributed_tpu/train/trainer.py``: ``TrainerConfig``:50,
``Trainer``:147 with ``train_epoch``:362, ``validate``:436, ``fit``:464).

The JAX trainer's epoch loop with a one-device mesh: the sampler's
``set_epoch`` reshuffle, ``step_lr`` SGD with momentum and weight decay at
the reference's hyperparameters (``TrainerConfig`` defaults), optional
label smoothing, global-norm clipping and ``nan_guard``, a validation pass
per epoch with top-1/5 accuracy accumulated on the device, and the best
top-1 tracked across epochs. Not ported yet (ROADMAP.md queue 1, item 6):
checkpoints with ``best``/``latest``, suspend/resume, rollback after bad
steps, the compile cache, telemetry and the metrics JSONL, the loader's
worker threads and prefetch, and the fp16 loss scaler; the trainer keeps
its logged records in ``history`` instead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    DistributedSampler,
    image_collate,
    to_device,
)
from pytorch_distributed_tpu_torch.ops.metrics import ClassificationMetrics
from pytorch_distributed_tpu_torch.ops.schedules import step_lr
from pytorch_distributed_tpu_torch.train.state import create_resnet_state
from pytorch_distributed_tpu_torch.train.step import make_eval_step, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    """Hyperparameters, defaulted to the reference's."""

    epochs: int = 100
    batch_size: int = 400
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_step_epochs: int = 30
    lr_gamma: float = 0.1
    precision: str = "fp32"  # fp32 | bf16 (the model's dtype); fp16 is not ported
    label_smoothing: float = 0.0
    log_every: int = 100
    seed: int = 0
    grad_clip_norm: float = 0.0
    nan_guard: bool = False


class Trainer:
    """Drives a ``models.ResNet`` over image datasets on one device (CUDA
    unless ``device="cpu"``), from the flax-scale initialisation of
    ``config.seed``."""

    def __init__(self, model, train_dataset, val_dataset, config: TrainerConfig,
                 device=None):
        if config.precision not in ("fp32", "bf16"):
            raise NotImplementedError(
                f"precision {config.precision!r}: the fp16 loss scaler is not ported yet")
        self.config = config
        self.device = resolve_device(device)
        pin = self.device.type == "cuda"
        self.train_sampler = DistributedSampler(len(train_dataset), shuffle=True,
                                                seed=config.seed)
        self.val_sampler = DistributedSampler(len(val_dataset), shuffle=False,
                                              seed=config.seed)
        self.train_loader = DataLoader(train_dataset, config.batch_size, image_collate,
                                       sampler=self.train_sampler, drop_last=True,
                                       pin_memory=pin)
        self.val_loader = DataLoader(val_dataset, config.batch_size, image_collate,
                                     sampler=self.val_sampler, drop_last=False,
                                     pin_memory=pin)
        schedule = step_lr(config.lr, len(self.train_loader),
                           step_size_epochs=config.lr_step_epochs, gamma=config.lr_gamma)
        self.state = create_resnet_state(model, lr_schedule=schedule,
                                         momentum=config.momentum,
                                         weight_decay=config.weight_decay, seed=config.seed,
                                         device=self.device)
        self.train_step = make_train_step(label_smoothing=config.label_smoothing,
                                          grad_clip_norm=config.grad_clip_norm,
                                          nan_guard=config.nan_guard)
        self.eval_step = make_eval_step()
        self.best_acc = 0.0
        #: one record per logged step: its metrics, epoch, step, the mean
        #: wall time of the steps since the previous record (``step_s``)
        #: and the part of it spent making and copying batches (``data_s``)
        self.history: List[dict] = []

    def train_epoch(self, epoch: int, start_step: int = 0) -> dict:
        """One epoch from batch ``start_step``; every ``log_every`` steps
        the metrics are read (a device sync) and recorded. Returns the last
        record's metrics."""
        cfg = self.config
        last: dict = {}
        t_prev, since, data_s = time.perf_counter(), 0, 0.0
        batches = self.train_loader.iter_batches(start_step)
        for step in range(start_step, len(self.train_loader)):
            t0 = time.perf_counter()
            batch = to_device(next(batches), self.device)
            data_s += time.perf_counter() - t0
            self.state, metrics = self.train_step(self.state, batch)
            since += 1
            if cfg.log_every and step % cfg.log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                self.history.append(dict(last, epoch=epoch, step=step,
                                         step_s=(now - t_prev) / since,
                                         data_s=data_s / since))
                t_prev, since, data_s = now, 0, 0.0
                acc1 = 100.0 * last["correct1"] / max(last["count"], 1.0)
                print(f"epoch {epoch} step {step}: loss {last['loss']:.4f} acc1 {acc1:.2f}")
        return last

    def validate(self) -> dict:
        """A validation epoch: device-resident sums, one readout."""
        metrics = ClassificationMetrics.empty(self.device)
        for host_batch in self.val_loader.iter_batches(0):
            metrics = self.eval_step(self.state, to_device(host_batch, self.device), metrics)
        return metrics.summary()

    def fit(self) -> dict:
        summary: dict = {}
        for epoch in range(self.config.epochs):
            t0 = time.time()
            self.train_sampler.set_epoch(epoch)
            self.train_epoch(epoch)
            summary = self.validate()
            print(f"epoch {epoch}: val loss {summary['loss']:.4f} acc1 {summary['acc1']:.2f} "
                  f"acc5 {summary['acc5']:.2f}")
            if summary["acc1"] > self.best_acc:
                self.best_acc = summary["acc1"]
                print(f"new best acc1 {self.best_acc:.2f}")
            print(f"epoch {epoch} cost time: {time.time() - t0:.1f} s")
        summary["best_acc"] = self.best_acc
        return summary
