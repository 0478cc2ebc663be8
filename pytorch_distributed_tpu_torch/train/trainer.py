"""The image-classification trainer
(``pytorch_distributed_tpu/train/trainer.py``: ``TrainerConfig``:50,
``Trainer``:147 with ``train_epoch``:362, ``validate``:436, ``fit``:464).

The JAX trainer's epoch loop on one device, or as one rank of a data
``parallel.mesh.Mesh``, which is how the reference's recipes differ:
one card (``resnet_single``), a rank a local card (``resnet_dp``), a rank
a card on every node (``resnet_ddp``), the same in bf16 (``resnet_ddp_amp``)
or with fp16's dynamic loss scaler (``precision="fp16"``), each also with
its parameters and momenta ZeRO-3-sharded over the replicas
(``fsdp=True``, JAX :224-243). As in JAX the
sampler splits the data by node and the node's loader batches its local
replicas together; each rank collates its rows ``[i·bs, (i+1)·bs)`` of the
node batch (``data.loader.rank_rows``), and a partial validation batch is
wrap-padded to the local replicas, its duplicates counted. The rest: the
sampler's ``set_epoch`` reshuffle, ``step_lr`` SGD with momentum and
weight decay at the reference's hyperparameters (``TrainerConfig``
defaults), optional label smoothing, global-norm clipping and
``nan_guard``, a validation pass per epoch with top-1/5 accuracy
accumulated on the device and summed over the replicas, the best top-1
across epochs; only rank 0 prints. And the checkpoint contract of
``train.base.SuspendableTrainer``: ``fit`` resumes from the newest
restorable checkpoint in ``save_dir`` (a JAX ``Trainer``'s too), saves
``latest.ckpt`` and yields on a suspend (``suspend_watcher``), a
``step-*.ckpt`` every ``save_every_n_steps`` steps and ``best.ckpt`` on a
better top-1, and rolls back after ``max_bad_steps`` skipped steps in a
row. The loaders fetch on ``num_workers`` threads, ``prefetch`` batches
ahead, their augmentation drawn from ``seed``; a raw split's batches are
uint8, normalized on the device. Not ported yet: the compile cache,
telemetry and the metrics JSONL (ROADMAP.md queue 1, items 8 and 9); the
trainer keeps its logged records in ``history`` instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    DistributedSampler,
    to_device,
)
from pytorch_distributed_tpu_torch.ops.metrics import ClassificationMetrics
from pytorch_distributed_tpu_torch.ops.precision import DynamicLossScaler
from pytorch_distributed_tpu_torch.ops.schedules import step_lr
from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.parallel.collectives import broadcast_from_primary
from pytorch_distributed_tpu_torch.parallel.fsdp import shard_state
from pytorch_distributed_tpu_torch.parallel.mesh import (
    Mesh,
    local_replica_count,
    local_replica_index,
)
from pytorch_distributed_tpu_torch.models.convert import resnet_payload_from_jax
from pytorch_distributed_tpu_torch.train.base import SuspendableTrainer
from pytorch_distributed_tpu_torch.train.state import create_resnet_state
from pytorch_distributed_tpu_torch.train.step import make_eval_step, make_train_step
from pytorch_distributed_tpu_torch.utils.checkpoint import Checkpointer
from pytorch_distributed_tpu_torch.utils.logging import rank0_print
from pytorch_distributed_tpu_torch.utils.suspend import NullSuspendWatcher, SuspendWatcher


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
    # fp32 | bf16 (the model's compute dtype) | fp16 (the dynamic loss scaler)
    precision: str = "fp32"
    label_smoothing: float = 0.0
    save_dir: str = "output"
    log_every: int = 100
    # the loaders' worker threads and the batches the producer runs ahead
    num_workers: int = 8
    prefetch: int = 2
    seed: int = 0
    # ranks agree on a suspend every this many steps (1: every step, one
    # tiny all-reduce a step with more than one rank); 0: each rank polls
    # alone, the reference's semantics, unsafe across ranks
    suspend_sync_every: int = 1
    grad_clip_norm: float = 0.0
    # a non-blocking step-<state.step>.ckpt every N steps (0: off, the
    # reference's suspend and best saves only), the newest keep_last_ckpts kept
    save_every_n_steps: int = 0
    keep_last_ckpts: int = 3
    # nan_guard skips a non-finite step; after max_bad_steps of them in a
    # row (0: never) the trainer rolls back to the newest checkpoint;
    # watchdog_timeout_s > 0 dumps every thread's stack after a step that
    # long and latches the suspend
    nan_guard: bool = False
    max_bad_steps: int = 0
    watchdog_timeout_s: float = 0.0
    # ZeRO-3: parameters and momenta sharded over the mesh's data axis,
    # all-gathered in the step (parallel.fsdp); BatchNorm stays per replica
    fsdp: bool = False


class Trainer(SuspendableTrainer):
    """Drives a ``models.ResNet`` over image datasets on one device (CUDA
    unless ``device="cpu"``), or as this process's rank of ``mesh``, from
    the flax-scale initialisation of ``config.seed`` (rank 0's, broadcast).
    ``config.batch_size`` is per data replica."""

    def __init__(self, model, train_dataset, val_dataset, config: TrainerConfig,
                 device=None, mesh: Optional[Mesh] = None,
                 suspend_watcher: Optional[SuspendWatcher] = None):
        if config.precision not in ("fp32", "bf16", "fp16"):
            raise ValueError(f"precision {config.precision!r}: fp32, bf16 or fp16")
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.watcher = suspend_watcher or NullSuspendWatcher()
        self.ckpt = Checkpointer(config.save_dir, device=self.device)
        pin = self.device.type == "cuda"
        # the sampler splits by node; the node's loader batches its local
        # replicas and this rank collates its rows of each node batch
        part = (local_replica_index(mesh), local_replica_count(mesh))
        node_batch = config.batch_size * part[1]
        nodes, node = ((distributed.node_count(), distributed.node_index())
                       if mesh is not None else (1, 0))
        self.train_sampler = DistributedSampler(len(train_dataset), num_replicas=nodes,
                                                rank=node, shuffle=True, seed=config.seed)
        self.val_sampler = DistributedSampler(len(val_dataset), num_replicas=nodes,
                                              rank=node, shuffle=False, seed=config.seed)
        feed = dict(pin_memory=pin, part=part, num_workers=config.num_workers,
                    prefetch=config.prefetch, seed=config.seed)
        self.train_loader = DataLoader(train_dataset, node_batch, sampler=self.train_sampler,
                                       drop_last=True, **feed)
        self.val_loader = DataLoader(val_dataset, node_batch, sampler=self.val_sampler,
                                     drop_last=False, wrap_partial=True, **feed)
        schedule = step_lr(config.lr, len(self.train_loader),
                           step_size_epochs=config.lr_step_epochs, gamma=config.lr_gamma)
        scaler = DynamicLossScaler.create() if config.precision == "fp16" else None
        self.state = create_resnet_state(model, lr_schedule=schedule,
                                         momentum=config.momentum,
                                         weight_decay=config.weight_decay, seed=config.seed,
                                         device=self.device, scaler=scaler)
        if mesh is not None:  # DDP's broadcast of rank 0's weights at construction
            broadcast_from_primary(list(self.state.model.state_dict().values()))
        if config.fsdp:
            if mesh is None:
                raise ValueError("fsdp=True shards over a mesh's data axis: pass mesh")
            shard_state(self.state, mesh)
        self.train_step = make_train_step(mesh, label_smoothing=config.label_smoothing,
                                          grad_clip_norm=config.grad_clip_norm,
                                          nan_guard=config.nan_guard, fsdp=config.fsdp)
        self.eval_step = make_eval_step(mesh, fsdp=config.fsdp)
        self.best_acc = 0.0
        self.start_epoch = 0
        self.start_step = 0
        self._init_resilience()
        #: one record per logged step: its metrics, epoch, step, the mean
        #: wall time of the steps since the previous record (``step_s``)
        #: and the part of it spent making and copying batches (``data_s``)
        self.history: List[dict] = []

    def _extra_payload(self) -> dict:
        return {"best_acc": self.best_acc}

    def _restore_extra(self, leaves: Dict[str, torch.Tensor]) -> None:
        self.best_acc = float(leaves["best_acc"])

    def _from_jax(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return resnet_payload_from_jax(leaves, fused=self.state.model.fused)

    def _report_epoch(self, epoch: int, summary: dict, seconds: float) -> bool:
        rank0_print(f"epoch {epoch}: val loss {summary['loss']:.4f} acc1 "
                    f"{summary['acc1']:.2f} acc5 {summary['acc5']:.2f}")
        better = summary["acc1"] > self.best_acc
        if better:
            self.best_acc = summary["acc1"]
            rank0_print(f"new best acc1 {self.best_acc:.2f}, saved best.ckpt")
        rank0_print(f"epoch {epoch} cost time: {seconds:.1f} s")
        return better

    def train_epoch(self, epoch: int, start_step: int = 0) -> dict:
        """One epoch from batch ``start_step``, each step bracketed by the
        fault site, the watchdog and the guard, and followed by the
        interval save and the suspend poll; every ``log_every`` steps the
        metrics are read (a device sync) and recorded. The loader's
        iterator is closed on every way out (a suspend's exit, a rollback,
        an error), which stops its threads. Returns the last record's
        metrics."""
        with contextlib.closing(self.train_loader.iter_batches(start_step)) as batches:
            return self._train_steps(epoch, start_step, batches)

    def _train_steps(self, epoch: int, start_step: int, batches) -> dict:
        cfg = self.config
        last: dict = {}
        t_prev, since, data_s = time.perf_counter(), 0, 0.0
        for step in range(start_step, len(self.train_loader)):
            t0 = time.perf_counter()
            batch = to_device(self._pre_step(next(batches)), self.device)
            data_s += time.perf_counter() - t0
            self.state, metrics = self.train_step(self.state, batch)
            self._post_step(metrics)
            since += 1
            if cfg.log_every and step % cfg.log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                self.history.append(dict(last, epoch=epoch, step=step,
                                         step_s=(now - t_prev) / since,
                                         data_s=data_s / since))
                t_prev, since, data_s = now, 0, 0.0
                acc1 = 100.0 * last["correct1"] / max(last["count"], 1.0)
                rank0_print(f"epoch {epoch} step {step}: loss {last['loss']:.4f} "
                            f"acc1 {acc1:.2f}")
            self._maybe_save_step(epoch, step)
            self._maybe_suspend(epoch, step)
        self._epoch_end_guard()
        return last

    def validate(self) -> dict:
        """A validation epoch: device-resident sums over every replica, one
        readout."""
        metrics = ClassificationMetrics.empty(self.device)
        with contextlib.closing(self.val_loader.iter_batches(0)) as batches:
            for host_batch in batches:
                metrics = self.eval_step(self.state, to_device(host_batch, self.device),
                                         metrics)
        return metrics.summary()
