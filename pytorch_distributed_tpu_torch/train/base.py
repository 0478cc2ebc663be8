"""The trainers' suspend / checkpoint / resume / rollback contract
(``pytorch_distributed_tpu/train/base.py``, ``SuspendableTrainer``:44).

One home for what ``Trainer`` and ``LMTrainer`` must agree on: the
reference's preemption protocol (poll a suspend each step, checkpoint,
yield, resume where the run left off: ``restnet_ddp.py:36-47,127-132``)
and the guards around it. These paths order collectives and barriers, so
every rank must take them at the same steps.

A subclass sets ``self.config`` (with ``epochs``, ``save_dir``,
``suspend_sync_every``, ``save_every_n_steps``, ``keep_last_ckpts``,
``nan_guard``, ``max_bad_steps``, ``watchdog_timeout_s``),
``self.watcher`` (a ``SuspendWatcher``), ``self.ckpt`` (a
``Checkpointer``), ``self.state``, ``self.device`` and
``self.train_sampler``, and provides ``train_epoch`` and ``validate``,
``_extra_payload`` / ``_restore_extra`` (its best metric),
``_report_epoch`` (prints an epoch's validation, keeps the best) and
``_from_jax`` (a JAX checkpoint's leaves in the port's layout).

Not ported: the telemetry of the JAX class (goodput, spans, the flight
recorder, the anomaly sentinel, the metrics ring), the compile cache and
the elastic reshard of sharded state.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import torch

from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.parallel.collectives import all_reduce_
from pytorch_distributed_tpu_torch.resilience import faults
from pytorch_distributed_tpu_torch.resilience.stepguard import RollbackRequested, StepGuard
from pytorch_distributed_tpu_torch.resilience.watchdog import Watchdog
from pytorch_distributed_tpu_torch.train.state import restore_state, state_payload
from pytorch_distributed_tpu_torch.utils.checkpoint import ManifestReader
from pytorch_distributed_tpu_torch.utils.logging import rank0_print


class SuspendableTrainer:
    guard = None
    watchdog = None
    rollbacks = 0
    start_epoch = 0
    start_step = 0

    def _init_resilience(self) -> None:
        """The step guard when ``nan_guard`` (``max_bad_steps`` 0: skip
        only, no rollback) and the watchdog when ``watchdog_timeout_s`` >
        0, its stack dump in ``<save_dir>/watchdog_stall.log`` on rank 0."""
        cfg = self.config
        if cfg.nan_guard:
            self.guard = StepGuard(max_bad_steps=cfg.max_bad_steps)
        if cfg.watchdog_timeout_s and cfg.watchdog_timeout_s > 0:
            dump = None
            if distributed.is_primary():
                os.makedirs(cfg.save_dir, exist_ok=True)
                dump = os.path.join(cfg.save_dir, "watchdog_stall.log")
            self.watchdog = Watchdog(cfg.watchdog_timeout_s, watcher=self.watcher,
                                     dump_path=dump).start()

    def _pre_step(self, host_batch: dict) -> dict:
        """Before each step: the ``train.step`` fault site. ``nan``
        NaN-fills the batch's floats (NaN loss and gradients through the
        real step), ``suspend`` latches the watcher; ``kill``, ``hang``
        and ``raise`` run inside ``fault_point``."""
        spec = faults.fault_point("train.step")
        if spec is not None:
            if spec.kind == "nan":
                host_batch = faults.poison_batch(host_batch)
            elif spec.kind == "suspend":
                self.watcher.request_suspend()
        return host_batch

    def _post_step(self, metrics: dict) -> None:
        """After each step: the watchdog's heartbeat (after, so the first
        step's kernel build is outside the deadline) and the guard's
        ``step_good``, which raises ``RollbackRequested`` after
        ``max_bad_steps`` bad steps in a row, on every rank at once."""
        if self.watchdog is not None:
            self.watchdog.beat()
        if self.guard is not None:
            self.guard.observe(metrics.get("step_good"))

    def _epoch_end_guard(self) -> None:
        if self.guard is not None:
            self.guard.flush()

    def _rollback(self, err: RollbackRequested) -> None:
        """Restore the newest restorable checkpoint after the guard gave up
        skipping. Without one the run cannot go on: the state the guard
        condemned would only fail again."""
        self.rollbacks += 1
        rank0_print(f"stepguard: {err}; restoring last good checkpoint")
        self.ckpt.wait()  # commit the save in flight first
        if not self.try_resume():
            raise RuntimeError(
                "stepguard requested rollback but no restorable checkpoint exists — enable "
                "save_every_n_steps (or suspend saves) so a rollback target is available"
            ) from err
        self.guard.reset()

    def _extra_payload(self) -> dict:
        return {}

    def _restore_extra(self, leaves: Dict[str, torch.Tensor]) -> None:
        pass

    def _from_jax(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _report_epoch(self, epoch: int, summary: dict, seconds: float) -> bool:
        """Print an epoch's validation; True, with the best kept, when it
        is better than the best so far."""
        raise NotImplementedError

    def fit(self) -> dict:
        """Resume, then the epochs: train, commit the save in flight,
        validate, a non-blocking ``best.ckpt`` on a better metric
        (``restnet_ddp.py:135-150``). Re-entrant for rollback: on
        ``RollbackRequested`` the newest checkpoint is restored and the
        loop goes on from its epoch and step, on every rank alike.
        Returns the last validation's summary with the best metric."""
        self.try_resume()
        summary: dict = {}
        epoch = self.start_epoch
        while epoch < self.config.epochs:
            t0 = time.time()
            self.train_sampler.set_epoch(epoch)
            start_step = self.start_step if epoch == self.start_epoch else 0
            try:
                self.train_epoch(epoch, start_step)
            except RollbackRequested as err:
                self._rollback(err)  # restores the state, start_epoch, start_step
                epoch = self.start_epoch
                continue
            self.ckpt.wait()
            summary = self.validate()
            if self._report_epoch(epoch, summary, time.time() - t0):
                self.ckpt.save_best(self._payload_live(epoch + 1, 0), block=False)
            epoch += 1
        self.ckpt.wait()
        if self.watchdog is not None:
            self.watchdog.stop()
        self.start_step = 0
        summary.update(self._extra_payload())
        return summary

    def _payload_live(self, epoch: int, step: int) -> dict:
        """The checkpoint's leaves: the state's live tensors (the save
        snapshots them), the data cursor ``(epoch, step)`` and the extra
        scalars."""
        payload = state_payload(self.state)
        payload.update(epoch=epoch, step=step, **self._extra_payload())
        return payload

    def _read_checkpoint(self, path: str) -> Dict[str, torch.Tensor]:
        """Every leaf of a checkpoint (views of the mapped files, their
        tokens checked), in the port's layout: a JAX trainer's checkpoint
        (``state/params/...``) crosses through ``_from_jax``."""
        reader = ManifestReader(path)
        leaves = {p: reader.read(p) for p in reader.leaf_paths()}
        if any(p.startswith("state/params/") for p in leaves):
            leaves = self._from_jax(leaves)
        return leaves

    def try_resume(self) -> bool:
        """Restore the newest restorable checkpoint: ``latest.ckpt`` (a
        suspend's) or a ``step-*.ckpt``, whichever saved the highest
        ``state/step`` (``restnet_ddp.py:127-132`` restores latest only;
        the interval saves are this framework's). The candidates are
        validated, newest first; one that still fails to load is reported
        and the next is tried. Every rank reads the same files, so every
        rank takes the same one."""
        self.ckpt.wait()
        for path in self.ckpt.restorable_paths():
            try:
                leaves = self._read_checkpoint(path)
                restore_state(self.state, leaves)
            except (OSError, ValueError, KeyError, RuntimeError) as e:
                rank0_print(f"resume: {path} failed to load ({e}); falling back to the next "
                            "complete checkpoint")
                continue
            self.start_epoch = int(leaves["epoch"])
            self.start_step = int(leaves["step"])
            self._restore_extra(leaves)
            rank0_print(f"resumed from {path}: epoch {self.start_epoch} step {self.start_step}")
            return True
        return False

    def _maybe_save_step(self, epoch: int, step: int) -> None:
        """Every ``save_every_n_steps`` steps a non-blocking save of
        ``step-<state.step>.ckpt`` keeping the newest ``keep_last_ckpts``;
        the save first commits the previous one, at the same step on every
        rank."""
        every = self.config.save_every_n_steps
        if every <= 0 or (step + 1) % every:
            return
        self.ckpt.save_step(self._payload_live(epoch, step + 1), self.state.step,
                            keep_last=self.config.keep_last_ckpts, block=False)

    def _maybe_suspend(self, epoch: int, step: int) -> None:
        """Poll, agree, checkpoint, yield (``restnet_ddp.py:36-47``).

        With more than one rank and ``suspend_sync_every`` = N, a rank acts
        only at ``step % N == 0``, on the MAX of every rank's flag: a rank
        acting alone on its own signal would save while the others run
        the next step's collectives, and both would hang. The watcher
        latches, so deferring loses nothing. ``suspend_sync_every`` = 0 is
        the reference's rank-local poll, unsafe across ranks by design.
        The data cursor saved is ``(epoch, step + 1)``: a suspend on an
        epoch's last step resumes into its validation."""
        suspended = self.watcher.receive_suspend_command()
        sync = self.config.suspend_sync_every
        if sync and distributed.get_world_size() > 1:
            if step % sync:
                return  # deferred to the next agreement step
            flag = torch.tensor(float(suspended), device=self.device)
            suspended = bool(all_reduce_(flag, torch.distributed.ReduceOp.MAX) > 0)
        if not suspended:
            return
        self.ckpt.save_latest(self._payload_live(epoch, step + 1))
        rank0_print(f"suspend: saved {self.ckpt.latest_path} at epoch {epoch} step {step}")
        self.ckpt.wait()
        if self.watchdog is not None:
            self.watchdog.stop()
        self.watcher.go_suspend()
