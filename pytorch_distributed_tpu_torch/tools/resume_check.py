"""Suspend and resume across ranks, spawned by the tests and by ``chip_smoke.py``.

``run(job, nprocs)`` spawns ``nprocs`` ranks (``parallel.distributed.spawn``)
on a data mesh of that size over ``job["backend"]``, meeting at
``job["rendezvous"]`` (a ``file://`` path in the caller's temporary
directory). Each rank builds a ``Trainer(mesh=)`` for each run of
``job["runs"]`` in turn, on the model of ``job["model"]``
(``tools.dp_check.build_model``), the synthetic data of ``job["data"]``
and ``TrainerConfig`` of ``job["config"]`` updated by the run's own
``"config"`` and ``save_dir=run["dir"]``, and fits it
with a ``SuspendWatcher`` that takes signals. A run with ``"signal":
[rank, k]`` sends SIGUSR1 to that rank alone, just before its k-th step
(counted from 0 in this run): the ranks agree at the next agreement step
(``suspend_sync_every``), rank 0 saves ``latest.ckpt``, and every rank
leaves through ``go_suspend`` with exit code 0, so such a run comes last.
A run whose directory holds a checkpoint resumes from it.

When its runs end a rank writes ``<job["out"]>/rank<r>.pt`` (``torch.save``;
``load`` reads them back): for each run its ``state.step`` and
``updates``, the step a suspend saved at (``suspended_at``, the cursor
``(epoch, step)`` of ``latest.ckpt``) and ``exit`` (the code of
``go_suspend``, else None), a checksum of every state tensor, and on rank 0
the state itself (``train.state.state_payload``, on the CPU).

This module imports no JAX: a spawned rank imports its target's module.
"""

from __future__ import annotations

import os
import signal
from typing import Dict, List

import torch

from pytorch_distributed_tpu_torch.data import SyntheticImageClassification
from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh
from pytorch_distributed_tpu_torch.tools.dp_check import build_model


def run(job: dict, nprocs: int) -> None:
    """Spawn the ranks of ``job`` and wait for them; a rank's failure (an
    exit code other than 0) is raised here."""
    os.makedirs(job["out"], exist_ok=True)
    distributed.spawn(rank_main, nprocs, (job, nprocs))


def load(job: dict, nprocs: int) -> List[dict]:
    """Every rank's results, by rank."""
    return [torch.load(os.path.join(job["out"], f"rank{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def checksum(t: torch.Tensor) -> float:
    """A tensor's values summed in float64 (a replication check)."""
    return float(t.detach().double().sum()) if t.numel() else 0.0


def rank_main(local_rank: int, job: dict, nprocs: int) -> None:
    distributed.init_process_group(job["backend"], init_method=job["rendezvous"],
                                   world_size=nprocs, rank=local_rank,
                                   timeout_s=job.get("timeout_s", distributed.DEFAULT_TIMEOUT_S))
    try:
        device = distributed.rank_device(job["device"], local_rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.deterministic = job.get("cudnn_deterministic", False)
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        mesh = make_mesh(nprocs)
        results: Dict[str, dict] = {}
        try:
            for spec in job["runs"]:
                _fit(job, spec, mesh, device, local_rank, results)
        finally:  # a suspended run leaves through SystemExit
            torch.save(results, os.path.join(job["out"], f"rank{local_rank}.pt"))
    finally:
        distributed.destroy_process_group()


def _fit(job: dict, spec: dict, mesh, device, local_rank: int, results: Dict[str, dict]) -> None:
    from pytorch_distributed_tpu_torch.train import Trainer, TrainerConfig
    from pytorch_distributed_tpu_torch.train.state import state_payload
    from pytorch_distributed_tpu_torch.utils.suspend import SuspendWatcher

    d = job["data"]
    watcher = SuspendWatcher(signals=(signal.SIGUSR1,))
    trainer = Trainer(build_model(job["model"]),
                      SyntheticImageClassification(d["n_train"], d["size"], d["classes"]),
                      SyntheticImageClassification(d["n_val"], d["size"], d["classes"], seed=1),
                      TrainerConfig(**dict(job["config"], **spec.get("config", {})),
                                    save_dir=spec["dir"]), device=device,
                      mesh=mesh, suspend_watcher=watcher)
    rank, at = spec.get("signal") or (None, None)
    if rank == local_rank:
        pre, count = trainer._pre_step, [0]

        def signalled(batch):
            if count[0] == at:
                os.kill(os.getpid(), signal.SIGUSR1)
            count[0] += 1
            return pre(batch)

        trainer._pre_step = signalled
    saved_at, save_latest = [], trainer.ckpt.save_latest

    def recorded(payload, block=True):
        saved_at.append((int(payload["epoch"]), int(payload["step"])))
        save_latest(payload, block)

    trainer.ckpt.save_latest = recorded
    code = None
    try:
        trainer.fit()
    except SystemExit as e:
        code = e.code
        raise
    finally:
        watcher.uninstall()
        payload = state_payload(trainer.state)
        results[spec["name"]] = {
            "step": trainer.state.step, "updates": trainer.state.updates,
            "suspended_at": saved_at[0] if saved_at else None, "exit": code,
            "checksums": {k: checksum(v) for k, v in payload.items()
                          if isinstance(v, torch.Tensor)},
            "state": ({k: (v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor)
                           else v) for k, v in payload.items()}
                      if distributed.is_primary() else None)}
