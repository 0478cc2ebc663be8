"""The slice as a whole: ResNet training fed from raw TPRC records, against
the JAX package's.

On the CPU, from raw uint8 splits packed from seeded images (stored 24 px,
16 px crops, 5 classes), tiny ResNets in fp32:

- three SGD steps through the port's ``Trainer``, its loader on 2 threads
  2 batches ahead, against JAX ``make_train_step`` fed by the JAX
  ``DataLoader`` from the same split, from the same weights;
- both trainers' loaders take the native whole-batch crop (the default
  collate is the one the fast path keys on);
- a suspend mid-epoch with a loader of 2 threads 3 batches ahead leaves
  no loader thread, and the resume reads the same batches as the
  uninterrupted run: the states end bit for bit equal (``Trainer`` and
  ``LMTrainer``);
- two gloo ranks (``tools/dp_check.py``), the datasets pickled across the
  spawn, against the JAX ``Trainer`` over a 2-device mesh: an epoch and a
  validation pass with a wrap-padded partial batch;
- ``recipes/resnet_dp.py`` on two CPU ranks from raw splits.

Tolerances are ``test_torch_resnet_train.py``'s (fp32 summation order):
losses 1e-5 relative, parameters and BatchNorm statistics 2e-5 absolute.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data import DataLoader as JaxLoader
from pytorch_distributed_tpu.data import DistributedSampler as JaxSampler
from pytorch_distributed_tpu.data import RawImageNet as JaxRawImageNet
from pytorch_distributed_tpu.models import resnet as jresnet
from pytorch_distributed_tpu.ops.optim import sgd_with_weight_decay as jax_sgd
from pytorch_distributed_tpu.ops.schedules import step_lr as jax_step_lr
from pytorch_distributed_tpu.parallel import make_mesh, single_device_mesh
from pytorch_distributed_tpu.train import Trainer as JaxTrainer
from pytorch_distributed_tpu.train import TrainerConfig as JaxTrainerConfig
from pytorch_distributed_tpu.train.state import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.step import make_train_step as jax_make_train_step
from pytorch_distributed_tpu_torch.data import (
    RawImageNet,
    SyntheticTokens,
    image_collate,
    write_imagenet_raw_split,
)
from pytorch_distributed_tpu_torch.data.loader import PRODUCER_THREAD
from pytorch_distributed_tpu_torch.models import resnet, tiny_config
from pytorch_distributed_tpu_torch.models.convert import (
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from pytorch_distributed_tpu_torch.recipes import resnet_dp
from pytorch_distributed_tpu_torch.resilience import faults
from pytorch_distributed_tpu_torch.resilience.faults import FaultPlan, FaultSpec
from pytorch_distributed_tpu_torch.tools import dp_check
from pytorch_distributed_tpu_torch.train import LMTrainer, LMTrainerConfig, Trainer, TrainerConfig
from pytorch_distributed_tpu_torch.train.state import state_payload
from pytorch_distributed_tpu_torch.utils.suspend import SuspendWatcher

STORED, CROP, CLASSES = 24, 16, 5
MODELS = {"basic": (jresnet.BasicBlock, resnet.BasicBlock, False),
          "fused": (jresnet.BottleneckBlock, resnet.BottleneckBlock, True)}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear_plan()
    yield
    faults.clear_plan()


def raw_splits(root, n_train=12, n_val=7) -> str:
    rng = np.random.default_rng(7)
    for split, n in (("train", n_train), ("val", n_val)):
        write_imagenet_raw_split(
            os.path.join(root, f"{split}.rawtprc"),
            [(rng.integers(0, 255, (STORED, STORED, 3), np.uint8), i % CLASSES)
             for i in range(n)], STORED)
    return os.fspath(root)


def port_datasets(root, aug="crop"):
    return RawImageNet("train", root, CROP, aug), RawImageNet("val", root, CROP, "none")


def jax_datasets(root):
    return JaxRawImageNet("train", root, CROP, "crop"), JaxRawImageNet("val", root, CROP, "none")


def port_model(kind):
    return resnet.ResNet(stage_sizes=(1, 1), block_cls=MODELS[kind][1], num_classes=CLASSES,
                         num_filters=8, fused_bottleneck=MODELS[kind][2])


def jax_model(kind):
    return jresnet.ResNet(stage_sizes=(1, 1), block_cls=MODELS[kind][0], num_classes=CLASSES,
                          num_filters=8, fused_bottleneck=MODELS[kind][2])


def variables(state) -> dict:
    return {"params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}


def assert_tree_close(got, want, atol, what=""):
    fg, tg = jax.tree_util.tree_flatten_with_path(got)
    fw, tw = jax.tree_util.tree_flatten_with_path(want)
    assert tg == tw
    for (path, a), (_, b) in zip(fg, fw):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def loader_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith(PRODUCER_THREAD)]


@pytest.mark.parametrize("kind", ["basic", "fused"])
def test_three_steps_from_a_raw_split_match_make_train_step(tmp_path, kind):
    root = raw_splits(tmp_path)
    jstate = JaxTrainState.create(jax_model(kind), jax_sgd(jax_step_lr(0.1, 3, 30, 0.1), 0.9,
                                                           1e-4),
                                  jax.random.key(0), (1, CROP, CROP, 3))
    init = variables(jstate)
    sampler = JaxSampler(12, 1, 0, shuffle=True, seed=0)
    sampler.set_epoch(0)
    jstep = jax_make_train_step(single_device_mesh())
    want = []
    for b in JaxLoader(jax_datasets(root)[0], 4, sampler=sampler, num_workers=0, prefetch=1,
                       seed=0):
        assert b["image"].dtype == np.uint8
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))

    trainer = Trainer(port_model(kind), *port_datasets(root),
                      TrainerConfig(epochs=1, batch_size=4, lr=0.1, log_every=1,
                                    num_workers=2, prefetch=2, save_dir=str(tmp_path / "out")),
                      device="cpu")
    trainer.state.model.load_state_dict(
        resnet_params_from_jax(init, fused=MODELS[kind][2]))
    trainer.train_sampler.set_epoch(0)
    trainer.train_epoch(0)
    np.testing.assert_allclose([r["loss"] for r in trainer.history], want, rtol=1e-5)
    assert trainer.state.step == int(jstate.step) == 3
    got = resnet_params_to_jax(trainer.state.model.state_dict())
    assert_tree_close(got["params"], jstate.params, 2e-5, "params")
    assert_tree_close(got["batch_stats"], jstate.batch_stats, 2e-5, "batch_stats")
    assert not loader_threads()


def test_the_trainers_loaders_take_the_native_path(tmp_path):
    """The trainer leaves the loader its default collate, the one the
    whole-batch path keys on: every train and validation batch of a fit
    is made by the native crop; ``rrc`` declines it."""
    root = raw_splits(tmp_path)
    train, val = port_datasets(root)
    trainer = Trainer(port_model("basic"), train, val,
                      TrainerConfig(epochs=1, batch_size=4, save_dir=str(tmp_path / "a"),
                                    log_every=0), device="cpu")
    assert trainer.train_loader.collate_fn is image_collate
    assert trainer.val_loader.collate_fn is image_collate
    assert (trainer.config.num_workers, trainer.config.prefetch) == (8, 2)
    summary = trainer.fit()
    assert summary["count"] == 7 and np.isfinite(summary["loss"])
    assert (train.native_batches, val.native_batches) == (3, 2)
    rrc_train, _ = port_datasets(root, aug="rrc")
    Trainer(port_model("basic"), rrc_train, RawImageNet("val", root, CROP, "none"),
            TrainerConfig(epochs=1, batch_size=4, save_dir=str(tmp_path / "b"), log_every=0),
            device="cpu").fit()
    assert rrc_train.native_batches == 0
    assert not loader_threads()


def snapshot(trainer) -> dict:
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state_payload(trainer.state).items()}


def assert_bitwise(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == got[k].dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def resnet_trainer(root, save_dir, watcher=None):
    cfg = TrainerConfig(epochs=2, batch_size=4, lr=0.05, save_dir=str(save_dir), log_every=0,
                        num_workers=2, prefetch=3)
    return Trainer(port_model("fused"), *port_datasets(root), cfg, device="cpu",
                   suspend_watcher=watcher)


def lm_trainer(root, save_dir, watcher=None):
    cfg = LMTrainerConfig(epochs=2, batch_size=2, lr=3e-3, log_every=0, save_dir=str(save_dir),
                          num_workers=2, prefetch=3)
    return LMTrainer(tiny_config(max_seq_len=16), SyntheticTokens(12, 16, 128),
                     SyntheticTokens(4, 16, 128, seed=1), cfg, device="cpu",
                     suspend_watcher=watcher)


@pytest.mark.parametrize("make", [resnet_trainer, lm_trainer], ids=["resnet", "lm"])
def test_a_suspend_mid_epoch_closes_the_loader_and_resumes_exactly(tmp_path, make):
    """Suspended before step 1 of the first epoch (3 an epoch for the
    ResNet, 6 for the LM): the prefetching loader's threads are gone after
    the suspend's exit, and a fresh trainer resumes to the uninterrupted
    run's state, bit for bit."""
    root = raw_splits(tmp_path)
    full = make(root, tmp_path / "full")
    full.fit()
    faults.install_plan(FaultPlan([FaultSpec("train.step", "suspend", at=1)]))
    first = make(root, tmp_path / "resumed", SuspendWatcher(install_handlers=False))
    with pytest.raises(SystemExit) as e:
        first.fit()
    assert e.value.code == 0 and first.ckpt.has_latest() and first.state.step == 2
    assert not loader_threads()
    faults.clear_plan()
    second = make(root, tmp_path / "resumed")
    second.fit()
    assert_bitwise(snapshot(second), snapshot(full))
    assert not loader_threads()


def test_two_gloo_ranks_from_a_raw_split_match_jax_over_two_devices(tmp_path):
    """12 training records (3 node batches of 2 x 2) and 7 validation
    records, whose last node batch of 3 is wrap-padded to 4 (count 8), as
    the JAX ``validate`` does; the ranks' datasets arrive pickled and
    reopen their files, every batch from the native crop."""
    root = raw_splits(tmp_path)
    cfg = JaxTrainerConfig(epochs=1, batch_size=2, lr=0.05, save_dir=str(tmp_path / "jax"),
                           log_every=1, num_workers=0, prefetch=1, flush_every=0,
                           metrics_out=str(tmp_path / "metrics.jsonl"))
    jt = JaxTrainer(jax_model("fused"), *jax_datasets(root), cfg,
                    mesh=make_mesh(jax.devices()[:2]), input_shape=(1, CROP, CROP, 3))
    init = variables(jax.device_get(jt.state))
    jt.train_sampler.set_epoch(0)
    jt.train_epoch(0)
    want_val = jt.validate()
    with open(cfg.metrics_out) as f:
        want = [r for r in map(json.loads, f) if r.get("kind") == "train"]
    job = dict(task="trainer", model=dict(stage_sizes=(1, 1), block="bottleneck",
                                          num_classes=CLASSES, num_filters=8, fused=True),
               params=resnet_params_from_jax(init, fused=True), datasets=port_datasets(root),
               config=dict(epochs=1, batch_size=2, lr=0.05, log_every=1, num_workers=2,
                           prefetch=2, save_dir=str(tmp_path / "port")),
               backend="gloo", rendezvous=f"file://{tmp_path}/rendezvous",
               out=str(tmp_path / "out"), device="cpu", timeout_s=120)
    dp_check.run(job, 2)
    assert want_val["count"] == 8 and len(want) == 3
    for r in dp_check.load(job, 2):
        assert r["steps_per_epoch"] == 3 and r["native_batches"] == [3, 2]
        np.testing.assert_allclose([h["loss"] for h in r["history"]],
                                   [w["loss"] for w in want], rtol=1e-5)
        for k, v in want_val.items():
            np.testing.assert_allclose(r["val"][k], v, rtol=1e-5, err_msg=k)


def test_the_dp_recipe_runs_from_raw_splits_on_two_cpu_ranks(tmp_path):
    root = raw_splits(tmp_path, n_train=16, n_val=8)
    summary = resnet_dp.main(["--device", "cpu", "--tiny", "--cpu-replicas", "2", "--epochs",
                              "1", "--batch-size", "2", "--save-dir", str(tmp_path / "out")],
                             datasets=(*port_datasets(root), CROP, CLASSES))
    assert summary["count"] == 8 and np.isfinite(summary["loss"])
