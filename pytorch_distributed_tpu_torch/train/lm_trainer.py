"""LMTrainer (``pytorch_distributed_tpu/train/lm_trainer.py``).

The epoch loop of the JAX trainer: the sampler's ``set_epoch`` reshuffle,
the warmup-cosine AdamW (``LMTrainerConfig`` has the JAX defaults),
optional global-norm clipping and ``nan_guard``, and a validation pass per
epoch reporting token perplexity. On one device, or as one rank of a
data × seq ``parallel.mesh.Mesh``: as in JAX (``train/lm_trainer.py``
:203-210) the sampler splits the data by node and the node's loader
batches its local data replicas together; the rank collates its replica's
rows of each node batch (``data.loader.rank_rows``), ``shard_lm_batch``
gives it its sequence columns, the steps all-reduce over data × seq, and
only rank 0 prints. A tensor-parallel model config (``tp_size`` T > 1)
trains on a mesh whose model axis has T ranks: every model rank of a
(data, seq) point collates the same rows, and the state, the same on
every rank after rank 0's broadcast, then takes each rank's Megatron
parts (``train.lm.shard_lm_state``). With ``fsdp`` the state is
ZeRO-3-sharded over the data axis (``train.lm``), the TP parts left as
they are; with ``pipeline_stages`` every stage of a replica collates the
replica's rows and trains through ``train.pp``.
Validation zero-weights the sampler's wrap-padding
duplicates and pads a partial node batch with zero-weight rows (:519-545),
so each sequence counts once. The checkpoint contract is
``train.base.SuspendableTrainer``'s, as in ``train.Trainer``, with
``best.ckpt`` on a lower validation perplexity (``best_ppl``; JAX
:416-420, :568-627). The compile cache, metrics JSONL and telemetry come
with later slices (ROADMAP.md queue 1, items 8 and 9); the trainer keeps
its logged records in ``history`` instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.data import DataLoader, DistributedSampler, to_device
from pytorch_distributed_tpu_torch.models.convert import lm_payload_from_jax, pp_payload_from_jax
from pytorch_distributed_tpu_torch.ops.schedules import warmup_cosine
from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.parallel.collectives import broadcast_from_primary
from pytorch_distributed_tpu_torch.parallel.mesh import (
    Mesh,
    local_replica_count,
    local_replica_index,
    make_mesh,
)
from pytorch_distributed_tpu_torch.parallel.sequence import zigzag_shard
from pytorch_distributed_tpu_torch.train.base import SuspendableTrainer
from pytorch_distributed_tpu_torch.train.lm import (
    create_lm_state,
    empty_lm_metrics,
    make_lm_eval_step,
    make_lm_train_step,
    shard_lm_state,
    shift_labels,
)
from pytorch_distributed_tpu_torch.train.pp import (
    create_pp_lm_state,
    make_pp_lm_eval_step,
    make_pp_lm_train_step,
    pp_microbatches,
)
from pytorch_distributed_tpu_torch.utils.checkpoint import Checkpointer
from pytorch_distributed_tpu_torch.utils.logging import rank0_print
from pytorch_distributed_tpu_torch.utils.suspend import NullSuspendWatcher, SuspendWatcher


def lm_collate(samples) -> dict:
    """``[L]``-token samples → ``{"tokens", "labels", "weights"}`` ``[B, L]``."""
    tokens = np.stack(samples).astype(np.int32)
    labels, weights = shift_labels(tokens)
    return {"tokens": tokens, "labels": labels, "weights": weights}


def shard_lm_batch(mesh: Optional[Mesh], batch: dict, layout: str = "contiguous") -> dict:
    """This rank's columns of its data replica's ``[B, L]`` batch: collate
    and ``shift_labels`` ran on the whole sequence, then with
    ``layout="zigzag"`` every per-token array is permuted alike
    (``parallel.sequence.zigzag_shard``), then sequence shard s takes
    columns ``[s·L/sp, (s+1)·L/sp)`` (``shard_lm_batch``:63 of the JAX
    package). Never shift per shard. Without a seq axis the batch is
    returned as it is."""
    if mesh is None or mesh.seq.size == 1:
        return batch
    sp, r = mesh.seq.size, mesh.seq.index
    out = {}
    for k, x in batch.items():
        if layout == "zigzag":
            x = zigzag_shard(x, sp, axis=1)
        n = x.shape[1] // sp
        part = x[:, r * n:(r + 1) * n]
        out[k] = part.contiguous() if isinstance(part, torch.Tensor) else np.ascontiguousarray(part)
    return out


@dataclasses.dataclass
class LMTrainerConfig:
    epochs: int = 1
    batch_size: int = 8
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 0
    min_lr_ratio: float = 0.1
    save_dir: str = "output_lm"
    log_every: int = 100
    num_workers: int = 0  # see TrainerConfig
    prefetch: int = 2
    seed: int = 0
    suspend_sync_every: int = 1  # see TrainerConfig
    grad_clip_norm: float = 0.0
    save_every_n_steps: int = 0  # see TrainerConfig
    keep_last_ckpts: int = 3
    nan_guard: bool = False
    max_bad_steps: int = 0
    watchdog_timeout_s: float = 0.0
    # ZeRO-3 over the mesh's data axis (train.lm.shard_lm_state)
    fsdp: bool = False
    # > 0: train through the GPipe pipeline (train.pp), the stages on the
    # mesh's model axis, pp_microbatches clamped to a divisor of batch_size
    pipeline_stages: int = 0
    pp_microbatches: int = 8


class LMTrainer(SuspendableTrainer):
    """Drives a ``TransformerConfig`` over token datasets on one device
    (CUDA unless ``device="cpu"``), or as this process's rank of ``mesh``,
    from the seeded initialisation (rank 0's, broadcast).
    ``config.batch_size`` is per data replica. ``config.fsdp`` shards the
    state over the data axis; ``config.pipeline_stages`` = S trains
    through the pipeline on a mesh whose model axis has S ranks (JAX
    :233-330, with its refusals: no ``nan_guard``, no seq axis, no
    ``fsdp`` with the pipeline); otherwise the model axis carries the
    model config's ``tp_size`` ranks of tensor parallelism, and a model
    axis above 1 without it is refused (JAX :249-282)."""

    def __init__(self, model_config, train_dataset, val_dataset,
                 config: LMTrainerConfig, device=None, mesh: Optional[Mesh] = None,
                 suspend_watcher: Optional[SuspendWatcher] = None):
        self.config = config
        self.model_config = model_config
        self.mesh = mesh
        self.device = resolve_device(device)
        self.watcher = suspend_watcher or NullSuspendWatcher()
        self.ckpt = Checkpointer(config.save_dir, device=self.device)
        pin = self.device.type == "cuda"
        part = (local_replica_index(mesh), local_replica_count(mesh))
        nodes, node = ((distributed.node_count(), distributed.node_index())
                       if mesh is not None else (1, 0))
        self.train_sampler = DistributedSampler(len(train_dataset), num_replicas=nodes,
                                                rank=node, shuffle=True, seed=config.seed)
        self.val_sampler = DistributedSampler(len(val_dataset), num_replicas=nodes, rank=node,
                                              shuffle=False, seed=config.seed)
        feed = dict(pin_memory=pin, part=part, num_workers=config.num_workers,
                    prefetch=config.prefetch, seed=config.seed)
        self.train_loader = DataLoader(train_dataset, config.batch_size * part[1], lm_collate,
                                       sampler=self.train_sampler, drop_last=True, **feed)
        self.val_loader = DataLoader(val_dataset, config.batch_size * part[1], lm_collate,
                                     sampler=self.val_sampler, drop_last=False, **feed)
        schedule = warmup_cosine(
            config.lr, total_steps=max(len(self.train_loader) * config.epochs, 1),
            warmup_steps=config.warmup_steps, final_lr=config.lr * config.min_lr_ratio)
        if config.pipeline_stages > 0:
            self._init_pipeline(schedule)
        else:
            if config.fsdp and mesh is None:  # one device: a data axis of 1, as in JAX
                mesh = self.mesh = make_mesh(1)
            self._check_model_axis()
            self.state = create_lm_state(model_config, lr_schedule=schedule,
                                         weight_decay=config.weight_decay, seed=config.seed,
                                         device=self.device)
            if mesh is not None:
                # the global weights rank 0's everywhere, then each rank's
                # Megatron parts and ZeRO parts
                broadcast_from_primary(list(self.state.model.state_dict().values()))
                self.state = shard_lm_state(self.state, mesh, fsdp=config.fsdp,
                                            config=model_config)
            self.train_step = make_lm_train_step(
                grad_clip_norm=config.grad_clip_norm, nan_guard=config.nan_guard, mesh=mesh,
                config=model_config, dropout_seed=config.seed, fsdp=config.fsdp)
            self.eval_step = make_lm_eval_step(mesh=mesh, config=model_config,
                                               fsdp=config.fsdp)
        self.best_ppl = float("inf")
        self.start_epoch = 0
        self.start_step = 0
        self._init_resilience()
        #: one record per logged step: its metrics, epoch, step, and the
        #: mean wall time of the steps since the previous record
        self.history: List[dict] = []

    def _check_model_axis(self) -> None:
        """The JAX trainer's model-axis checks (:249-282) off the
        pipeline: tensor parallelism needs a model axis of ``tp_size``
        ranks, and a model axis above 1 without it would make every rank
        on it do the same work."""
        tp, mesh = self.model_config.tp_size, self.mesh
        size = 1 if mesh is None else mesh.model.size
        if tp > 1 and size != tp:
            raise ValueError(
                f"tp_size {tp} needs the mesh's {self.model_config.model_axis!r} axis of "
                f"{tp} ranks (got {size}); build the mesh with model_parallel={tp}")
        if tp == 1 and size > 1:
            raise ValueError(
                f"the mesh carries a model axis of size {size} but the model config has "
                "no model_axis: every rank on it would do duplicate work; set "
                "model_axis/tp_size or size the axis to 1")

    def _init_pipeline(self, schedule) -> None:
        """The pipeline's state and steps, with the JAX trainer's checks."""
        cfg, s = self.config, self.config.pipeline_stages
        if cfg.nan_guard:
            raise ValueError(
                "nan_guard does not compose with pipeline_stages: the "
                "GPipe executor owns its own update path (train/pp.py)")
        mesh = self.mesh if self.mesh is not None else make_mesh(1)
        if mesh.model.size != s:
            raise ValueError(
                f"pipeline_stages={s} needs the mesh's 'model' axis to carry the stages "
                f"(got {mesh.model.size}); build the mesh with that axis sized to "
                "pipeline_stages")
        if mesh.seq.size > 1:
            raise ValueError(
                "the PP trainer shards batches over data only; use "
                "seq_parallel=1 (ring attention cannot run inside a "
                "pipeline stage)")
        if cfg.fsdp:
            raise ValueError(
                "fsdp does not compose with pipeline_stages in the "
                "trainer (stage stacks already shard the model axis)")
        # every rank initialises the same stacked weights from the seed
        self.state = create_pp_lm_state(self.model_config, s, lr_schedule=schedule,
                                        weight_decay=cfg.weight_decay, seed=cfg.seed,
                                        mesh=mesh, device=self.device)
        mb, note = pp_microbatches(cfg.pp_microbatches, cfg.batch_size)
        if note:
            rank0_print(note)
        self.train_step = make_pp_lm_train_step(mesh, self.model_config, mb,
                                                dropout_seed=cfg.seed,
                                                grad_clip_norm=cfg.grad_clip_norm)
        self.eval_step = make_pp_lm_eval_step(mesh, self.model_config, mb)

    def _extra_payload(self) -> dict:
        return {"best_ppl": self.best_ppl}

    def _restore_extra(self, leaves: Dict[str, torch.Tensor]) -> None:
        self.best_ppl = float(leaves["best_ppl"])

    def _from_jax(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if any(p.startswith("state/params/stages/") for p in leaves):
            return pp_payload_from_jax(leaves)
        return lm_payload_from_jax(leaves)

    def _report_epoch(self, epoch: int, summary: dict, seconds: float) -> bool:
        rank0_print(f"epoch {epoch}: val loss {summary['loss']:.4f} ppl {summary['ppl']:.3f}")
        better = summary["ppl"] < self.best_ppl
        if better:
            self.best_ppl = summary["ppl"]
            rank0_print(f"new best ppl {self.best_ppl:.3f}, saved best.ckpt")
        return better

    def train_epoch(self, epoch: int, start_step: int = 0) -> dict:
        """One epoch from batch ``start_step``, each step bracketed as in
        ``Trainer.train_epoch``; every ``log_every`` steps the metrics are
        read (a device sync) and recorded; the loader's iterator is closed
        on every way out. Returns the last record's metrics."""
        with contextlib.closing(self.train_loader.iter_batches(start_step)) as batches:
            return self._train_steps(epoch, start_step, batches)

    def _train_steps(self, epoch: int, start_step: int, batches) -> dict:
        cfg = self.config
        last: dict = {}
        t_prev, since = time.perf_counter(), 0
        for step, host_batch in enumerate(batches, start=start_step):
            batch = to_device(self._shard(self._pre_step(host_batch)), self.device)
            self.state, metrics = self.train_step(self.state, batch)
            self._post_step(metrics)
            since += 1
            if cfg.log_every and step % cfg.log_every == 0:
                last = {k: float(v) for k, v in metrics.items()}
                now = time.perf_counter()
                self.history.append(dict(last, epoch=epoch, step=step,
                                         step_s=(now - t_prev) / since))
                t_prev, since = now, 0
                rank0_print(f"epoch {epoch} step {step}: loss {last['loss']:.4f}")
            self._maybe_save_step(epoch, step)
            self._maybe_suspend(epoch, step)
        self._epoch_end_guard()
        return last

    def _shard(self, host_batch: dict) -> dict:
        return shard_lm_batch(self.mesh, host_batch, self.model_config.ring_layout)

    def _val_batch(self, indices: np.ndarray, duplicate: np.ndarray) -> dict:
        """A validation batch of ``batch_size`` rows: the sequences at
        ``indices``, those marked ``duplicate`` weighing nothing, then
        zero-weight padding rows (sequence 0's tokens; a rank whose rows
        of a partial node batch ran out still steps with the others)."""
        pad = self.config.batch_size - len(indices)
        batch = self.val_loader.collate(np.concatenate([indices, np.zeros(pad, np.int64)]))
        keep = np.concatenate([~duplicate, np.zeros(pad, bool)])
        batch["weights"] = batch["weights"] * torch.from_numpy(keep)[:, None]
        return batch

    def validate(self) -> dict:
        acc = empty_lm_metrics(self.device)
        indices = self.val_sampler.local_indices()
        duplicate = self.val_sampler.local_padding_mask()
        for rows in self.val_loader.iter_rows(0):
            host_batch = self._val_batch(indices[rows], duplicate[rows])
            acc = self.eval_step(self.state, to_device(self._shard(host_batch), self.device),
                                 acc)
        tokens = float(acc["tokens"])
        if tokens == 0.0:
            raise ValueError("validation saw zero tokens: the val dataset is "
                             "empty or its sequences have length 1")
        mean = float(acc["loss_sum"]) / tokens
        return {"loss": mean, "ppl": float(np.exp(min(mean, 30.0))), "tokens": tokens}
