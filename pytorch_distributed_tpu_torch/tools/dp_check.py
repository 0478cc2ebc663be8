"""Data-parallel ResNet ranks, spawned by the tests and by ``chip_smoke.py``.

``run(job, nprocs)`` spawns ``nprocs`` ranks (``parallel.distributed.spawn``)
on a data mesh of that size over ``job["backend"]``, meeting at
``job["rendezvous"]`` (a ``file://`` path in the caller's temporary
directory). Each rank runs ``job["task"]`` and writes what it found to
``<job["out"]>/rank<r>.pt`` with ``torch.save``; ``load`` reads them back.
Rank r takes rows ``[r·bs, (r+1)·bs)`` of each global batch (``rows``), as
the JAX ``shard_batch`` lays a batch over a mesh. The tasks:

- ``"steps"``: for each case of ``job["cases"]`` (a model spec, see
  ``build_model``; its weights ``params``, a state dict, or the seed-0
  initialisation; ``nan_guard``, ``grad_clip_norm``, the ``step_lr``
  ``schedule``, ``scaler`` for fp16, and ``plant``: ``(step, rank)`` of
  an inf planted in that rank's rows), ``make_train_step(mesh)`` on the
  global batches of ``job["batches"]`` (or made from ``job["data"]``),
  with each step's metrics, the combined gradient's norm, the largest
  change of any parameter and momentum, the scaler's scale and the tail
  kernels' launches, then rank 0's combined gradient of the first step,
  its state dict after the first step and the last, and its momenta;
- ``"trainer"``: ``Trainer(mesh=)`` (from ``job["params"]`` when given)
  for one epoch and a validation pass on synthetic images, or on
  ``job["datasets"]`` (train, val), which cross to the ranks pickled,
  with its history, the validation summary and the tail launches;
- ``"timing"``: on CUDA, for each case of ``job["models"]`` (a model
  spec and a ``batch`` a rank), ``job["steps"]`` timed steps (host clock
  after a sync) after ``job["warmup"]``, then ``job["profiled"]`` steps
  under ``torch.profiler`` on every rank, of which each rank reads its
  card's busy share and splits the device time a step into NCCL kernels
  and the rest (``device_split``).

This module imports no JAX: a spawned rank imports its target's module.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from pytorch_distributed_tpu_torch.data import SyntheticImageClassification, image_collate
from pytorch_distributed_tpu_torch.models import resnet
from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt
from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.parallel.mesh import Mesh, make_mesh

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BLOCKS = {"basic": resnet.BasicBlock, "bottleneck": resnet.BottleneckBlock}
TAIL = (bt.MOMENTS, bt.BWD_REDUCE, bt.BWD_DZ)
#: ResNet-50 as bench.py builds it (its dtype and blocks set per case)
RESNET50 = dict(stage_sizes=(3, 4, 6, 3), block="bottleneck", num_classes=1000,
                num_filters=64)


def run(job: dict, nprocs: int) -> None:
    """Spawn the ranks of ``job`` and wait for them; a rank's failure is
    raised here."""
    os.makedirs(job["out"], exist_ok=True)
    distributed.spawn(rank_main, nprocs, (job, nprocs))


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
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        mesh = make_mesh(nprocs)
        result = TASKS[job["task"]](job, mesh, device)
        torch.save(result, os.path.join(job["out"], f"rank{local_rank}.pt"))
    finally:
        distributed.destroy_process_group()


def load(job: dict, nprocs: int) -> List[dict]:
    """Every rank's results, by rank."""
    return [torch.load(os.path.join(job["out"], f"rank{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def build_model(spec: dict) -> resnet.ResNet:
    """A ``ResNet`` from a spec: ``stage_sizes``, ``block`` (basic or
    bottleneck), ``num_classes``, ``num_filters``, ``dtype`` (a
    ``DTYPES`` key), ``fused`` and ``sync_bn`` (over the data axis)."""
    return resnet.ResNet(stage_sizes=tuple(spec["stage_sizes"]), block_cls=BLOCKS[spec["block"]],
                         num_classes=spec["num_classes"], num_filters=spec["num_filters"],
                         dtype=DTYPES[spec.get("dtype", "float32")],
                         fused_bottleneck=spec.get("fused", False),
                         bn_cross_replica_axis="data" if spec.get("sync_bn") else None)


def global_batches(job: dict) -> List[Dict[str, np.ndarray]]:
    """``job["batches"]``, or ``job["data"]``'s: ``n`` batches of ``batch``
    synthetic images (``size``, ``classes``, ``seed``) in index order."""
    if "batches" in job:
        return job["batches"]
    d = job["data"]
    data = SyntheticImageClassification(d["n"] * d["batch"], d["size"], d["classes"],
                                        seed=d.get("seed", 0))
    return [image_collate([data[b * d["batch"] + i] for i in range(d["batch"])])
            for b in range(d["n"])]


def rows(batch: Dict[str, np.ndarray], index: int, ranks: int) -> Dict[str, torch.Tensor]:
    """Replica ``index``'s rows ``[index·bs, (index+1)·bs)`` of a global
    batch, as host tensors."""
    bs = len(batch["label"]) // ranks
    return {k: torch.from_numpy(v[index * bs:(index + 1) * bs].copy())
            for k, v in batch.items()}


def _momenta(opt: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [opt.state[p]["momentum_buffer"] for g in opt.param_groups for p in g["params"]
            if "momentum_buffer" in opt.state.get(p, {})]


def _largest_change(before: List[torch.Tensor], after: List[torch.Tensor]) -> float:
    if len(before) != len(after):
        return float("inf")  # momenta appeared
    return max((float((a - b).abs().max()) for a, b in zip(after, before)), default=0.0)


def _steps(job: dict, mesh: Mesh, device) -> Dict[str, dict]:
    from pytorch_distributed_tpu_torch.ops.optim import global_norm
    from pytorch_distributed_tpu_torch.ops.precision import DynamicLossScaler
    from pytorch_distributed_tpu_torch.ops.schedules import step_lr
    from pytorch_distributed_tpu_torch.train import create_resnet_state, make_train_step

    batches = global_batches(job)
    out = {}
    for name, case in job["cases"].items():
        plant_step, plant_rank = case.get("plant", (None, None))
        model = build_model(case["model"])
        scaler = (DynamicLossScaler.create(**case["scaler"]) if "scaler" in case else None)
        state = create_resnet_state(model, lr_schedule=step_lr(*case["schedule"]),
                                    params=case.get("params"), device=device, scaler=scaler)
        step = make_train_step(mesh, grad_clip_norm=case.get("grad_clip_norm", 0.0),
                               nan_guard=case.get("nan_guard", False))
        rec: Dict[str, list] = {}
        for i, batch in enumerate(batches):
            local = rows(batch, mesh.data.index, mesh.data.size)
            if i == plant_step and mesh.data.index == plant_rank:
                local["image"][0, 0, 0, 0] = float("inf")
            local = {k: v.to(device) for k, v in local.items()}
            params = [p.detach().clone() for p in state.model.parameters()]
            momenta = [m.clone() for m in _momenta(state.optimizer)]
            bt.reset_launch_counts()
            t0 = time.perf_counter()
            state, m = step(state, local)
            if device.type == "cuda":
                torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            launches = dict(bt.launch_counts)
            grads = [p.grad for p in state.model.parameters() if p.grad is not None]
            for k, v in dict(m, grad_norm=global_norm(grads), step_s=step_s,
                             scale=torch.as_tensor(state.scaler.scale),
                             param_change=_largest_change(
                                 params, [p.detach() for p in state.model.parameters()]),
                             momentum_change=_largest_change(
                                 momenta, _momenta(state.optimizer))).items():
                rec.setdefault(k, []).append(float(v))
            rec.setdefault("launches", []).append([launches.get(k, 0) for k in TAIL])
            if i == 0 and distributed.is_primary():
                first = {k: v.detach().to("cpu", copy=True)
                         for k, v in state.model.state_dict().items()}
                grad_first = {k: p.grad.to("cpu", copy=True)
                              for k, p in state.model.named_parameters() if p.grad is not None}
        primary = distributed.is_primary()
        out[name] = {
            "metrics": rec, "step": state.step, "updates": state.updates,
            "first": first if primary else None, "grad_first": grad_first if primary else None,
            "params": ({k: v.detach().cpu() for k, v in state.model.state_dict().items()}
                       if primary else None),
            "momenta": ([m.cpu() for m in _momenta(state.optimizer)] if primary else None)}
        del state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _trainer(job: dict, mesh: Mesh, device) -> dict:
    from pytorch_distributed_tpu_torch.train import Trainer, TrainerConfig

    if "datasets" in job:
        datasets = job["datasets"]
    else:
        d = job["data"]
        datasets = (SyntheticImageClassification(d["n_train"], d["size"], d["classes"]),
                    SyntheticImageClassification(d["n_val"], d["size"], d["classes"], seed=1))
    trainer = Trainer(build_model(job["model"]), *datasets, TrainerConfig(**job["config"]),
                      device=device, mesh=mesh)
    if job.get("params") is not None:  # in place of the seed's initialisation
        trainer.state.model.load_state_dict(job["params"])
    trainer.train_sampler.set_epoch(0)
    bt.reset_launch_counts()
    trainer.train_epoch(0)
    launches = dict(bt.launch_counts)
    val = trainer.validate()
    return {"history": trainer.history, "val": val, "launches": launches,
            "steps_per_epoch": len(trainer.train_loader),
            "native_batches": [getattr(ds, "native_batches", None) for ds in datasets]}


def device_split(prof, wall_us: float, steps: int) -> Dict[str, float]:
    """The card's time in a profiled window of ``steps`` steps: ``busy``,
    the share of the wall under any kernel; ``nccl_ms`` and ``compute_ms``,
    the time a step under NCCL kernels (the all-reduces, waiting for the
    other ranks included) and under every other kernel."""
    from pytorch_distributed_tpu_torch.tools.profile_serve import union_us

    spans = {True: [], False: []}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans["nccl" in e.name.lower()].append((e.time_range.start, e.time_range.end))
    return {"busy": union_us(spans[True] + spans[False]) / wall_us,
            "nccl_ms": union_us(spans[True]) / steps / 1e3,
            "compute_ms": union_us(spans[False]) / steps / 1e3}


def _timing(job: dict, mesh: Mesh, device) -> Dict[str, dict]:
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_tpu_torch.data import to_device
    from pytorch_distributed_tpu_torch.train import create_resnet_state, make_train_step

    out = {}
    for name, case in job["models"].items():
        # this rank's own synthetic rows: the timing reads no global batch
        bs = case["batch"]
        data = SyntheticImageClassification(2 * bs, job["size"], case["model"]["num_classes"],
                                            seed=mesh.data.index)
        batches = [to_device({k: torch.from_numpy(v) for k, v in image_collate(
            [data[b * bs + i] for i in range(bs)]).items()}, device) for b in range(2)]
        state = create_resnet_state(build_model(case["model"]), lr_schedule=lambda step: 0.1,
                                    device=device)
        step = make_train_step(mesh)
        done = 0

        def run(n):
            nonlocal done
            for _ in range(n):
                step(state, batches[done % 2])
                done += 1
            torch.cuda.synchronize()

        run(job["warmup"])
        torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(job["steps"]):
            t0 = time.perf_counter()
            run(1)
            times.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(job["profiled"])
            wall = time.perf_counter() - t0
        out[name] = dict(device_split(prof, wall * 1e6, job["profiled"]), step_s=times,
                         batch=bs, peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)
        del state, step, batches
        torch.cuda.empty_cache()
    return out


TASKS = {"steps": _steps, "trainer": _trainer, "timing": _timing}
