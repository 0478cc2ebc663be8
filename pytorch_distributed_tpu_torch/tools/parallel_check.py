"""Ranks that check ZeRO-3 FSDP and the GPipe pipeline, spawned by the
tests and by ``chip_smoke.py``.

``run(job, nprocs)`` spawns ``dp * sp * mp`` ranks
(``parallel.distributed.spawn``) on a data × seq × model grid over
``job["backend"]``, meeting at ``job["rendezvous"]`` (a ``file://`` path in
the caller's temporary directory), each with the process group's timeout
``job["timeout_s"]``, so that a rank stuck in a collective fails the run.
Each rank runs ``job["task"]`` and writes what it found to
``<job["out"]>/rank<r>.pt``; ``load`` reads them back. The tasks:

- ``"lm"``: for each case of ``job["cases"]`` (``model``: a
  ``TransformerConfig`` spec, tensor-parallel when it sets ``tp_size`` >
  1 and ``model_axis`` (the grid's model axis of that size); ``mode``:
  ``"replicated"``, ``"fsdp"`` or ``"pp"``; ``params``: global weights, a
  ``TransformerLM`` state dict, or for ``"pp"`` a stacked one, else the
  seed-0 initialisation; ``clip``, ``fused_ce``, ``microbatches``,
  ``dropout_seed``, ``nan_guard``, ``params_out``; ``plant``: ``(step, value)`` written
  into this rank's first TP part's gradient on model rank 1 at that step,
  through a hook; ``reference``: rank 0 then also trains the one-device
  model from the same weights on the whole global batches, ``reference``
  in its result: that run's metrics, eval sums, parameter + optimizer
  bytes, and each leaf's update against the gathered one, ``update_errs``),
  the train step on
  this rank's rows (and seq columns) of each global batch of
  ``job["batches"]`` and the eval step on ``job["val_batches"]``: each
  step's metrics, flash launches and host time, the rank's parameter and
  optimizer bytes and peak device memory, its layout (each sharded
  parameter's axis, dim and sections), the global parameters after the
  steps (rank 0; not with ``job["params_out"]`` False), and under
  ``"pp"`` a SHA-256 digest of each of the rank's embedding and head
  leaves; on CUDA with ``profiled`` > 0 (the case's, else the job's)
  that many more steps on the first batch under ``torch.profiler``, of
  which the rank reads its card's busy share
  (``tools.dp_check.device_split``);
- ``"resnet"``: ``tools/dp_check.py``'s ``"steps"`` task (its cases may
  ask for ``fsdp``);
- ``"trainer"``: the ``LMTrainer`` runs of ``job["runs"]`` in turn, each
  with its own ``LMTrainerConfig`` overrides (``fsdp``,
  ``pipeline_stages``, ``save_dir`` ...) on synthetic tokens, optionally
  suspended at its ``suspend_at``-th step (a checkpoint is saved and the
  run stops), or with ``restore_only`` only resumed from ``save_dir``:
  its history, whether it suspended, and rank 0's global parameters, the
  stacked tree for a pipeline run;
- ``"image_trainer"``: ``tools/dp_check.py``'s ``"trainer"`` task (the
  image ``Trainer`` for one epoch and a validation pass, ``job["config"]``
  its ``TrainerConfig``, ``fsdp`` among them);
- ``"tp_ops"``: ``parallel.tensor``'s ``tp_copy``, ``tp_reduce`` and
  ``tp_all_gather`` (last dim) over the model axis on model rank r's
  ``job["x"][r]``, each differentiated against ``job["cot"][op][r]`` (the
  output and the input's gradient), and the vocab-parallel
  ``fused_linear_cross_entropy`` on ``job["ce"]`` (``x``, the global
  head ``w`` ``[V, E]`` of which rank r takes rows ``[r·V/T, (r+1)·V/T)``,
  ``labels``, ``weights``, ``block_n``): the loss, dx and the rank's dW;
- ``"toy"``: ``parallel.pipeline.gpipe`` over the model axis with the
  stage ``relu(x @ w + b)`` (stage s's ``w``, ``b`` from the stacked
  ``job["w"]``, ``job["b"]``), ``job["x"]`` in ``job["microbatches"]``
  microbatches and the loss Σ y² on the last stage: the last stage's
  outputs and every stage's gradients;
- ``"serve"``: tensor-parallel serving (``tools/serve_tp.py``): each case
  of ``job["cases"]`` (a ``Scheduler``, ``ContinuousBatcher``,
  ``generate_tp`` or ``generate_ragged_tp`` run on every model rank) with
  each rank's streams, outcomes, pool bytes, kernel launches and logits
  rows, and rank 0's replicated reference run.

``"many"`` runs each of ``job["jobs"]`` (a task and its keys, by label)
in turn on one spawn of the ranks, each rank's result a dict by label; a
job that names its own ``dp``, ``sp``, ``mp`` (the same number of ranks)
runs on a grid of those sizes.

This module imports no JAX: a spawned rank imports its target's module.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Dict, List

import torch

from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax, pp_stack
from pytorch_distributed_tpu_torch.ops import flash_attention as fa
from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.parallel.fsdp import global_leaves, state_bytes
from pytorch_distributed_tpu_torch.parallel.mesh import Mesh, make_mesh
from pytorch_distributed_tpu_torch.tools import dp_check, serve_tp
from pytorch_distributed_tpu_torch.tools.ring_check import _model_config, shard

FLASH = (fa.FWD, fa.BWD)


def world(job: dict) -> int:
    return job.get("dp", 1) * job.get("sp", 1) * job.get("mp", 1)


def run(job: dict, nprocs: int) -> None:
    """Spawn the ranks of ``job`` and wait for them; a rank's failure is
    raised here."""
    if nprocs != world(job):
        raise ValueError(f"{nprocs} ranks for a {job.get('dp', 1)}x{job.get('sp', 1)}x"
                         f"{job.get('mp', 1)} grid")
    os.makedirs(job["out"], exist_ok=True)
    distributed.spawn(rank_main, nprocs, (job,))


def rank_main(local_rank: int, job: dict) -> None:
    distributed.init_process_group(job["backend"], init_method=job["rendezvous"],
                                   world_size=world(job), rank=local_rank,
                                   timeout_s=job.get("timeout_s", distributed.DEFAULT_TIMEOUT_S))
    try:
        device = distributed.rank_device(job["device"], local_rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        if job["task"] == "many":  # several tasks on one spawn of the ranks
            result = {}
            for k, sub in job["jobs"].items():
                sub = dict(job, **sub)
                mesh = make_mesh(sub.get("dp", 1), sub.get("sp", 1), sub.get("mp", 1))
                result[k] = TASKS[sub["task"]](sub, mesh, device)
        else:
            mesh = make_mesh(job.get("dp", 1), job.get("sp", 1), job.get("mp", 1))
            result = TASKS[job["task"]](job, mesh, device)
        torch.save(result, os.path.join(job["out"], f"rank{local_rank}.pt"))
    finally:
        distributed.destroy_process_group()


def load(job: dict) -> List[dict]:
    """Every rank's results, by rank."""
    return [torch.load(os.path.join(job["out"], f"rank{r}.pt"), weights_only=False)
            for r in range(world(job))]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lm(job: dict, mesh: Mesh, device) -> Dict[str, dict]:
    from pytorch_distributed_tpu_torch.ops.schedules import warmup_cosine
    from pytorch_distributed_tpu_torch.train import (
        create_lm_state,
        empty_lm_metrics,
        make_lm_eval_step,
        make_lm_train_step,
    )
    from pytorch_distributed_tpu_torch.train.lm import shard_lm_state
    from pytorch_distributed_tpu_torch.train.pp import (
        create_pp_lm_state,
        make_pp_lm_eval_step,
        make_pp_lm_train_step,
    )

    out = {}
    inits: Dict[str, dict] = {}  # the seed-0 weights, made once a model
    for name, case in job["cases"].items():
        cfg = _model_config(case["model"])
        mode = case["mode"]
        params = case.get("params")
        if params is None:
            # one initialisation a global model, whatever its TP layout
            key = repr(sorted((k, v) for k, v in case["model"].items()
                              if k not in ("tp_size", "model_axis", "vocab_parallel")))
            if key not in inits:
                inits[key] = params_from_jax(init_params(cfg, 0))
            params = inits[key]
            if mode == "pp":
                params = pp_stack(params, mesh.model.size)
        sched = warmup_cosine(*job.get("schedule", (3e-4, 100, 0, 3e-4)))
        wd = job.get("weight_decay", 0.1)
        kw = dict(grad_clip_norm=case.get("clip", 0.0), fused_ce=case.get("fused_ce", True))
        if mode == "pp":
            state = create_pp_lm_state(cfg, mesh.model.size, lr_schedule=sched,
                                       weight_decay=wd, params=params, mesh=mesh, device=device)
            m = case.get("microbatches", 1)
            step = make_pp_lm_train_step(mesh, cfg, m, dropout_seed=case.get("dropout_seed", 0),
                                         **kw)
            eval_step = make_pp_lm_eval_step(mesh, cfg, m, fused_ce=kw["fused_ce"])
        else:
            fsdp = mode == "fsdp"
            state = create_lm_state(cfg, lr_schedule=sched, weight_decay=wd, params=params,
                                    device=device)
            state = shard_lm_state(state, mesh, fsdp=fsdp, config=cfg)
            step = make_lm_train_step(mesh=mesh, config=cfg, fsdp=fsdp,
                                      dropout_seed=case.get("dropout_seed", 0),
                                      nan_guard=case.get("nan_guard", False), **kw)
            eval_step = make_lm_eval_step(mesh=mesh, config=cfg, fsdp=fsdp,
                                          fused_ce=kw["fused_ce"])
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        rec: Dict[str, list] = {}
        plant = _plant(state, mesh, case.get("plant"))
        for i, batch in enumerate(job["batches"]):
            local = {k: x.to(device) for k, x in shard(batch, mesh, cfg.ring_layout).items()}
            plant["step"] = i
            fa.reset_launch_counts()
            _sync(device)
            t0 = time.perf_counter()
            state, m_ = step(state, local)
            _sync(device)
            rec.setdefault("step_s", []).append(time.perf_counter() - t0)
            rec.setdefault("launches", []).append([fa.launch_counts[k] for k in FLASH])
            for k, x in m_.items():
                rec.setdefault(k, []).append(float(x))
        acc = empty_lm_metrics(device)
        fa.reset_launch_counts()
        for batch in job.get("val_batches", []):
            local = {k: x.to(device) for k, x in shard(batch, mesh, cfg.ring_layout).items()}
            acc = eval_step(state, local, acc)
        res = {"metrics": rec, "val": {k: float(v) for k, v in acc.items()},
               "val_launches": [fa.launch_counts[k] for k in FLASH],
               "state_bytes": state_bytes(state),
               "layout": {n: (sh.axis, sh.dim, sh.sections) for n, sh in state.layout.items()},
               "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                            if device.type == "cuda" else 0.0),
               "step": state.step}
        keep = case.get("params_out", job.get("params_out", True))
        if keep or case.get("reference"):
            got = global_leaves(state.model.state_dict(), state.layout, mesh)
            res["params"] = got if keep and distributed.is_primary() else None
            if case.get("reference") and distributed.is_primary():
                res["reference"] = _reference(job, case, cfg, params, got, sched, wd, device)
        if mode == "pp":
            res["replicated"] = {
                k: hashlib.sha256(v.detach().cpu().contiguous().view(torch.uint8).numpy()
                                  .tobytes()).hexdigest()
                for k, v in state.model.state_dict().items() if not k.startswith("stages.")}
        n = case.get("profiled", job.get("profiled", 0))
        if n and device.type == "cuda":
            res.update(_profiled(step, state, {k: x.to(device) for k, x in shard(
                job["batches"][0], mesh, cfg.ring_layout).items()}, n, device))
        out[name] = res
        del state, step, eval_step
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _reference(job, case, cfg, params, got, sched, wd, device) -> dict:
    """The one-device run of ``case`` from ``params`` on the whole global
    batches (``_lm``'s ``reference``), held against ``got``, the sharded
    run's gathered leaves."""
    from pytorch_distributed_tpu_torch.train import (
        create_lm_state,
        empty_lm_metrics,
        make_lm_eval_step,
        make_lm_train_step,
    )
    from pytorch_distributed_tpu_torch.train.lm import unsharded

    one = unsharded(cfg)
    state = create_lm_state(one, lr_schedule=sched, weight_decay=wd, params=params,
                            device=device)
    step = make_lm_train_step(grad_clip_norm=case.get("clip", 0.0), config=one,
                              fused_ce=case.get("fused_ce", True),
                              dropout_seed=case.get("dropout_seed", 0))
    rec: Dict[str, list] = {}
    for batch in job["batches"]:
        state, m = step(state, {k: torch.from_numpy(x).to(device) for k, x in batch.items()})
        for k, x in m.items():
            rec.setdefault(k, []).append(float(x))
    acc = empty_lm_metrics(device)
    for batch in job.get("val_batches", []):
        acc = make_lm_eval_step(config=one, fused_ce=case.get("fused_ce", True))(
            state, {k: torch.from_numpy(x).to(device) for k, x in batch.items()}, acc)
    want = {k: v.detach().float().cpu() for k, v in state.model.state_dict().items()}
    out = {"metrics": rec, "val": {k: float(v) for k, v in acc.items()},
           "state_bytes": state_bytes(state),
           "leaves_ok": (set(got) == set(want)
                         and all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)),
           "update": update_errs(got, want, params) if set(got) == set(want) else {}}
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def key_bias_masked(name: str, x: torch.Tensor) -> torch.Tensor:
    """A leaf with the attention key bias zeroed (its gradient is rounding
    noise that AdamW scales to ~lr a step: the k section of ``qkv.bias``,
    the first half of GQA's ``kv.bias``)."""
    if name.endswith("attn.qkv.bias"):
        x = x.clone()
        x[x.shape[0] // 3:2 * x.shape[0] // 3] = 0
    elif name.endswith("attn.kv.bias"):
        x = x.clone()
        x[:x.shape[0] // 2] = 0
    return x


def update_errs(got: dict, want: dict, init: dict) -> dict:
    """Each leaf's relative error of its update over the steps:
    ||(got - init) - (want - init)|| / ||want - init||, the key bias's
    noise masked (``key_bias_masked``)."""
    out = {}
    for name, w in want.items():
        d_want = key_bias_masked(name, w.float() - init[name].float())
        d_got = key_bias_masked(name, got[name].float() - init[name].float())
        out[name] = float((d_got - d_want).norm() / d_want.norm().clamp_min(1e-30))
    return out


def _plant(state, mesh: Mesh, plant) -> dict:
    """A hook writing ``plant = (step, value)``'s value into the gradient
    of the first tensor-parallel part on model rank 1 at that step (the
    step index is the returned dict's ``"step"``, which the caller sets)."""
    box: dict = {"step": -1}
    if plant is None or mesh.model.index != 1:
        return box
    at, value = plant
    name = next(n for n, sh in state.layout.items() if sh.axis == "model")
    param = dict(state.model.named_parameters())[name]

    def hook(g):
        if box["step"] != at:
            return g
        g = g.clone()
        g.view(-1)[0] = value
        return g

    param.register_hook(hook)
    return box


def _profiled(step, state, batch: dict, n: int, device) -> dict:
    """``n`` more steps under ``torch.profiler``: the card's busy share of
    the wall and the device time a step in NCCL kernels and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_tpu_torch.tools.dp_check import device_split

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _m = step(state, batch)
        _sync(device)
        wall = time.perf_counter() - t0
    return dict(device_split(prof, wall * 1e6, n), profiled_step_s=wall / n)


class _Suspended(Exception):
    pass


def _watcher(at):
    from pytorch_distributed_tpu_torch.utils.suspend import SuspendWatcher

    class SuspendAt(SuspendWatcher):
        """Asks for a suspend at its ``at``-th poll (the trainer polls
        after each step); the save done, stops the run by raising."""

        def __init__(self):
            super().__init__(install_handlers=False)
            self.polls = 0

        def receive_suspend_command(self) -> bool:
            self.polls += 1
            return at is not None and self.polls >= at

        def go_suspend(self, exit_code: int = 0) -> None:
            raise _Suspended()

    return SuspendAt()


def _trainer(job: dict, mesh: Mesh, device) -> List[dict]:
    from pytorch_distributed_tpu_torch.data import SyntheticTokens
    from pytorch_distributed_tpu_torch.train import LMTrainer, LMTrainerConfig

    out = []
    for spec in job["runs"]:
        cfg = _model_config(spec["model"])
        bsz, seq = spec["batch"], spec["seq"]
        trainer = LMTrainer(cfg, SyntheticTokens(spec["n_train"], seq, cfg.vocab_size),
                            SyntheticTokens(spec.get("n_val", bsz), seq, cfg.vocab_size, seed=1),
                            LMTrainerConfig(**spec["config"]), device=device, mesh=mesh,
                            suspend_watcher=_watcher(spec.get("suspend_at")))
        suspended, summary = False, {}
        if spec.get("restore_only"):
            trainer.try_resume()
        else:
            try:
                summary = trainer.fit()
            except _Suspended:
                suspended = True
        params = global_leaves(trainer.state.model.state_dict(), trainer.state.layout,
                               mesh)
        out.append({"history": trainer.history, "summary": summary, "suspended": suspended,
                    "step": trainer.state.step,
                    "params": params if distributed.is_primary() else None})
        del trainer
    return out


def _tp_ops(job: dict, mesh: Mesh, device) -> dict:
    from pytorch_distributed_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
    from pytorch_distributed_tpu_torch.parallel.tensor import tp_all_gather, tp_copy, tp_reduce

    r, axis = mesh.model.index, mesh.model
    out = {}
    for name, op in (("copy", tp_copy), ("reduce", tp_reduce), ("gather", tp_all_gather)):
        x = torch.tensor(job["x"][r], device=device, requires_grad=True)
        y = op(x, axis)
        (y * torch.tensor(job["cot"][name][r], device=device)).sum().backward()
        out[name] = (y.detach().cpu(), x.grad.cpu())
    ce = job["ce"]
    n = ce["w"].shape[0] // axis.size
    x = torch.tensor(ce["x"], device=device, requires_grad=True)
    w = torch.tensor(ce["w"][r * n:(r + 1) * n], device=device, requires_grad=True)
    loss = fused_linear_cross_entropy(
        x, w, torch.tensor(ce["labels"], device=device),
        torch.tensor(ce["weights"], device=device), block_n=ce["block_n"],
        compute_dtype=torch.float32, vocab_axis=axis)
    loss.backward()
    out["ce"] = (float(loss), x.grad.cpu(), w.grad.cpu())
    return out


def _toy(job: dict, mesh: Mesh, device) -> dict:
    from pytorch_distributed_tpu_torch.parallel.pipeline import gpipe

    s = mesh.model.index
    w = torch.tensor(job["w"][s], device=device, requires_grad=True)
    b = torch.tensor(job["b"][s], device=device, requires_grad=True)
    x = torch.tensor(job["x"], device=device)

    def stage_fn(p, act, mb_idx):
        return torch.relu(act @ p[0] + p[1])

    pipe = gpipe(stage_fn, (w, b), list(x.chunk(job["microbatches"])), axis=mesh.model,
                 head=lambda y, m: (y ** 2).sum())
    pipe.backward()
    last = s == mesh.model.size - 1
    return {"out": torch.cat(pipe.outputs).detach().cpu() if last else None,
            "loss": float(torch.stack(pipe.losses).sum()) if last else None,
            "dw": w.grad.cpu(), "db": b.grad.cpu()}


TASKS = {"lm": _lm, "resnet": dp_check.TASKS["steps"], "trainer": _trainer, "toy": _toy,
         "image_trainer": dp_check.TASKS["trainer"], "tp_ops": _tp_ops,
         "serve": serve_tp.serve}
