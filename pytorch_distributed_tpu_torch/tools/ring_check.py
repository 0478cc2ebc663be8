"""Ranks that check the ring against one device, spawned by the tests and
by ``chip_smoke.py``.

``run(job, nprocs)`` spawns ``nprocs`` ranks (``parallel.distributed.spawn``)
on a ``dp x sp`` grid over ``job["backend"]``, meeting at
``job["rendezvous"]`` (a ``file://`` path in the caller's temporary
directory). Each rank runs ``job["task"]`` and writes what it found to
``<job["out"]>/rank<r>.pt`` with ``torch.save``; ``load`` reads them back
and ``gather`` puts a sharded array together. The tasks:

- ``"attention"``: ``ring_flash_attention`` or the plain ``ring_attention``
  forward and backward on the rank's shard of global q, k, v, dO ``[B, L,
  H, D]`` (unit normal from ``job["seed"]``), for each case of
  ``job["cases"]``, with the flash kernels' launches per case;
- ``"train"``: for each model config of ``job["models"]``,
  ``make_lm_train_step`` on the rank's shard of each global batch of
  ``job["batches"]`` from the weights of ``job["params"]``, with each
  step's metrics and rank 0's final parameters;
- ``"trainer"``: for each model config of ``job["models"]``, ``LMTrainer``
  (from ``job["params"]`` when given) for one epoch and a validation pass
  on synthetic tokens (``job["n_train"]`` and ``job["n_val"]`` sequences,
  by default ``steps`` batches and one), with its history, the validation
  summary and the flash launches of each.

This module imports no JAX: a spawned rank imports its target's module.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from pytorch_distributed_tpu_torch.ops import flash_attention as fa
from pytorch_distributed_tpu_torch.parallel import distributed
from pytorch_distributed_tpu_torch.parallel.mesh import Mesh, make_mesh
from pytorch_distributed_tpu_torch.parallel.sequence import zigzag_unshard

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def run(job: dict, nprocs: int) -> None:
    """Spawn the ranks of ``job`` and wait for them; a rank's failure is
    raised here."""
    os.makedirs(job["out"], exist_ok=True)
    distributed.spawn(rank_main, nprocs, (job,))


def rank_main(local_rank: int, job: dict) -> None:
    distributed.init_process_group(job["backend"], init_method=job["rendezvous"],
                                   world_size=job["dp"] * job["sp"], rank=local_rank,
                                   timeout_s=job.get("timeout_s", distributed.DEFAULT_TIMEOUT_S))
    try:
        device = distributed.rank_device(job["device"], local_rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        mesh = make_mesh(job["dp"], job["sp"])
        result = TASKS[job["task"]](job, mesh, device)
        torch.save(result, os.path.join(job["out"], f"rank{local_rank}.pt"))
    finally:
        distributed.destroy_process_group()


def load(job: dict) -> List[dict]:
    """Every rank's results, by rank."""
    return [torch.load(os.path.join(job["out"], f"rank{r}.pt"), weights_only=False)
            for r in range(job["dp"] * job["sp"])]


def attention_inputs(job: dict) -> List[np.ndarray]:
    """The global q, k, v, dO of an attention job, fp32 numpy."""
    rng = np.random.default_rng(job["seed"])
    return [rng.standard_normal(job["shape"], np.float32) for _ in range(4)]


def shard(batch: dict, mesh: Mesh, layout: str) -> dict:
    """The rank's (data rows, seq columns) of global ``[B, L, ...]``
    arrays: its data replica's rows, then ``shard_lm_batch``."""
    from pytorch_distributed_tpu_torch.train.lm_trainer import shard_lm_batch

    d = mesh.data.index
    rows = {}
    for k, x in batch.items():
        b = x.shape[0] // mesh.data.size
        rows[k] = torch.from_numpy(np.ascontiguousarray(x[d * b:(d + 1) * b]))
    return shard_lm_batch(mesh, rows, layout)


def gather(parts: List[torch.Tensor], dp: int, sp: int, layout: str) -> torch.Tensor:
    """Put the shards of ranks ``d * sp + s`` back together into the global
    array (the inverse of ``shard``)."""
    rows = [torch.cat(parts[d * sp:(d + 1) * sp], dim=1) for d in range(dp)]
    x = torch.cat(rows, dim=0)
    return zigzag_unshard(x, sp, axis=1) if layout == "zigzag" else x


def case_name(case: dict) -> str:
    return "{impl}/{layout}/{bwd_impl}/causal={causal}".format(**case)


def _attention(job: dict, mesh: Mesh, device) -> Dict[str, dict]:
    from pytorch_distributed_tpu_torch.ops.ring_flash import ring_flash_attention
    from pytorch_distributed_tpu_torch.parallel.sequence import ring_attention

    dtype = DTYPES[job["dtype"]]
    glob = dict(zip("qkvo", attention_inputs(job)))  # o: the cotangent dO
    out = {}
    for case in job["cases"]:
        local = {k: x.to(device, dtype) for k, x in shard(glob, mesh, case["layout"]).items()}
        q, k, v = (local[n].requires_grad_() for n in "qkv")
        kw = dict(causal=case["causal"], layout=case["layout"], group=mesh.seq)
        fa.reset_launch_counts()
        if case["impl"] == "ring_flash":
            o = ring_flash_attention(q, k, v, bwd_impl=case["bwd_impl"], **kw)
        else:
            o = ring_attention(q, k, v, **kw)
        fwd = dict(fa.launch_counts)
        fa.reset_launch_counts()
        o.backward(local["o"])
        if device.type == "cuda":
            torch.cuda.synchronize()
        bwd = dict(fa.launch_counts)
        out[case_name(case)] = {
            "o": o.detach().cpu(), "dq": q.grad.cpu(), "dk": k.grad.cpu(),
            "dv": v.grad.cpu(), "fwd_launches": fwd, "bwd_launches": bwd}
    return out


def _model_config(spec: dict):
    from pytorch_distributed_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(**dict(spec, dtype=DTYPES[spec.get("dtype", "float32")]))


def _train(job: dict, mesh: Mesh, device) -> Dict[str, dict]:
    from pytorch_distributed_tpu_torch.ops.schedules import warmup_cosine
    from pytorch_distributed_tpu_torch.train import create_lm_state, make_lm_train_step

    out = {}
    for name, spec in job["models"].items():
        cfg = _model_config(spec)
        state = create_lm_state(cfg, lr_schedule=warmup_cosine(*job["schedule"]),
                                weight_decay=job["weight_decay"], params=job.get("params"),
                                device=device)
        step = make_lm_train_step(grad_clip_norm=job["grad_clip_norm"], mesh=mesh,
                                  config=cfg)
        metrics: Dict[str, list] = {}
        for batch in job["batches"]:
            local = {k: x.to(device) for k, x in shard(batch, mesh, cfg.ring_layout).items()}
            state, m = step(state, local)
            for k, x in m.items():
                metrics.setdefault(k, []).append(float(x))
        params = ({k: x.detach().cpu() for k, x in state.model.state_dict().items()}
                  if distributed.is_primary() else None)
        out[name] = {"metrics": metrics, "params": params, "step": state.step}
    return out


def _trainer(job: dict, mesh: Mesh, device) -> Dict[str, dict]:
    from pytorch_distributed_tpu_torch.data import SyntheticTokens
    from pytorch_distributed_tpu_torch.train import LMTrainer, LMTrainerConfig

    out = {}
    for name, spec in job["models"].items():
        cfg = _model_config(spec)
        bsz, seq = job["batch"], job["seq"]
        n_train, n_val = job.get("n_train", job.get("steps", 1) * bsz), job.get("n_val", bsz)
        trainer = LMTrainer(cfg, SyntheticTokens(n_train, seq, cfg.vocab_size),
                            SyntheticTokens(n_val, seq, cfg.vocab_size, seed=1),
                            LMTrainerConfig(batch_size=bsz, lr=3e-4, warmup_steps=0,
                                            log_every=1, grad_clip_norm=1.0),
                            device=device, mesh=mesh)
        if job.get("params") is not None:  # in place of the seed's initialisation
            trainer.state.model.load_state_dict(job["params"])
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
        fa.reset_launch_counts()
        trainer.train_epoch(0)
        if device.type == "cuda":
            torch.cuda.synchronize()
        train_launches = dict(fa.launch_counts)
        fa.reset_launch_counts()
        val = trainer.validate()
        out[name] = {"history": trainer.history, "val": val, "train_launches": train_launches,
                     "val_launches": dict(fa.launch_counts),
                     "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                                  if device.type == "cuda" else 0.0)}
        del trainer
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


TASKS = {"attention": _attention, "train": _train, "trainer": _trainer}
