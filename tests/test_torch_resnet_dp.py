"""The slice as a whole: data-parallel ResNet training against the JAX
package's.

Two gloo ranks on the CPU (``tools/dp_check.py``, a ``file://``
rendezvous under the test's temporary directory, one spawn per grid that
runs every case) against JAX ``make_train_step`` and ``Trainer`` over a
2-device mesh of the virtual CPU devices, fp32, from the same weights on
the same global batches (each replica takes its contiguous rows, as
``shard_batch`` lays them out):

- three DP steps of the tiny Bottleneck ResNet, plain and fused blocks,
  per-replica and sync-BN, with and without ``nan_guard``; the guarded
  cases plant an inf in rank 1's rows at step 1, just before the
  ``step_lr`` boundary, so step 2's lr tells whether the schedule counts
  the skipped step (optax's count does not);
- one epoch and a validation pass of ``Trainer(mesh=)`` against JAX's
  ``Trainer``, the validation set leaving a partial last batch that is
  wrap-padded to the replicas (its duplicates counted);
- the recipes' rank grid, their refusals, and ``resnet_dp`` on two CPU
  ranks to the end.

Tolerances are ``test_torch_resnet_train.py``'s (fp32 summation order):
1e-5 relative on losses and metrics, 2e-5 absolute on parameters and
BatchNorm statistics.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data import SyntheticImageClassification as JaxSynthetic
from pytorch_distributed_tpu.models import resnet as jresnet
from pytorch_distributed_tpu.ops.optim import sgd_with_weight_decay as jax_sgd
from pytorch_distributed_tpu.ops.schedules import step_lr as jax_step_lr
from pytorch_distributed_tpu.parallel import make_mesh, replicated_sharding, shard_batch
from pytorch_distributed_tpu.train import Trainer as JaxTrainer
from pytorch_distributed_tpu.train import TrainerConfig as JaxTrainerConfig
from pytorch_distributed_tpu.train.state import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.step import make_train_step as jax_make_train_step
from pytorch_distributed_tpu_torch.data.loader import rank_rows
from pytorch_distributed_tpu_torch.models.convert import (
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from pytorch_distributed_tpu_torch.recipes import common, resnet_ddp, resnet_ddp_amp
from pytorch_distributed_tpu_torch.recipes import resnet_dp, resnet_single
from pytorch_distributed_tpu_torch.tools import dp_check

RANKS, BATCH, SIZE, CLASSES = 2, 8, 16, 10
SCHEDULE = (0.1, 1, 2, 0.1)  # step_lr: one step an epoch, lr x0.1 from the third update
PLANT = (1, 1)  # an inf in rank 1's rows at step 1
CASES = {f"{kind}/{'sync' if sync else 'local'}/{'guard' if guard else 'plain'}":
         (kind, sync, guard)
         for kind in ("plain", "fused") for sync in (False, True) for guard in (False, True)}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spec(fused: bool, sync: bool = False) -> dict:
    return dict(stage_sizes=(1, 1), block="bottleneck", num_classes=CLASSES, num_filters=8,
                fused=fused, sync_bn=sync)


def jax_model(fused: bool, sync: bool = False):
    return jresnet.ResNet(stage_sizes=(1, 1), block_cls=jresnet.BottleneckBlock,
                          num_classes=CLASSES, num_filters=8, fused_bottleneck=fused,
                          bn_cross_replica_axis="data" if sync else None)


def batches():
    rng = np.random.default_rng(3)
    return [{"image": rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "label": rng.integers(0, CLASSES, BATCH).astype(np.int32)} for _ in range(3)]


def planted(batch):
    bad = dict(batch, image=batch["image"].copy())
    bad["image"][PLANT[1] * (BATCH // RANKS), 0, 0, 0] = np.inf
    return bad


def jax_state(fused: bool, sync: bool, scaler=None):
    """The JAX state from seed 0 (initialised without the sync axis, which
    only ``shard_map`` binds; the parameter tree is the same), placed on
    the 2-device mesh."""
    state = JaxTrainState.create(jax_model(fused), jax_sgd(jax_step_lr(*SCHEDULE), 0.9, 1e-4),
                                 jax.random.key(0), (1, SIZE, SIZE, 3), scaler=scaler)
    state = state.replace(apply_fn=jax_model(fused, sync).apply)
    return state, make_mesh(jax.devices()[:RANKS])


def variables(state) -> dict:
    return {"params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}


@functools.lru_cache(maxsize=None)
def jax_run(kind: str, sync: bool, guard: bool):
    state, mesh = jax_state(kind == "fused", sync)
    state = jax.device_put(state, replicated_sharding(mesh))
    step = jax_make_train_step(mesh, nan_guard=guard)
    metrics = []
    for i, b in enumerate(batches()):
        if guard and i == PLANT[0]:
            b = planted(b)
        state, m = step(state, shard_batch(mesh, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, variables(jax.device_get(state)), int(state.step)


def assert_tree_close(got, want, atol, what=""):
    fg, tg = jax.tree_util.tree_flatten_with_path(got)
    fw, tw = jax.tree_util.tree_flatten_with_path(want)
    assert tg == tw
    for (path, a), (_, b) in zip(fg, fw):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def spawn(tmp, job: dict):
    job = dict(job, backend="gloo", rendezvous=f"file://{tmp}/rendezvous", out=str(tmp / "out"),
               device="cpu", timeout_s=120)
    dp_check.run(job, RANKS)
    return dp_check.load(job, RANKS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this process, as the gloo ranks it spawns take:
    the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_steps(tmp_path_factory):
    init = {kind: variables(jax_state(kind == "fused", False)[0]) for kind in ("plain", "fused")}
    cases = {name: dict(model=spec(kind == "fused", sync), nan_guard=guard, schedule=SCHEDULE,
                        params=resnet_params_from_jax(init[kind], fused=kind == "fused"),
                        **({"plant": PLANT} if guard else {}))
             for name, (kind, sync, guard) in CASES.items()}
    return spawn(tmp_path_factory.mktemp("steps"),
                 dict(task="steps", cases=cases, batches=batches()))


@pytest.mark.parametrize("name", list(CASES))
def test_three_dp_steps_match_jax(port_steps, name):
    """Metrics each step (rtol 1e-5; the guarded step's loss is NaN on
    both sides), parameters and BatchNorm statistics after three steps
    (atol 2e-5), on every rank."""
    kind, sync, guard = CASES[name]
    want_metrics, want, want_step = jax_run(kind, sync, guard)
    for r in port_steps:
        got = r[name]["metrics"]
        assert r[name]["step"] == want_step == 3
        assert r[name]["updates"] == (2 if guard else 3)
        for i, jm in enumerate(want_metrics):
            for k, v in jm.items():
                np.testing.assert_allclose(got[k][i], v, rtol=1e-5, err_msg=f"{k}@{i}")
        assert got["launches"] == [[0, 0, 0]] * 3  # CPU tensors: the plain versions
    if guard:  # the skipped step left parameters and momenta as they were
        assert port_steps[0][name]["metrics"]["param_change"][PLANT[0]] == 0.0
        assert port_steps[0][name]["metrics"]["momentum_change"][PLANT[0]] == 0.0
    tree = resnet_params_to_jax(port_steps[0][name]["params"])
    assert_tree_close(tree["params"], want["params"], 2e-5, "params")
    assert_tree_close(tree["batch_stats"], want["batch_stats"], 2e-5, "batch_stats")


def test_sync_bn_ranks_equal_one_rank_on_the_whole_batch(port_steps):
    """Sync-BN on 2 ranks is BatchNorm over the concatenated batch: its
    first-step loss equals the JAX single-device step's on the global
    batch (no axis), for both block kinds."""
    from pytorch_distributed_tpu.parallel import single_device_mesh

    for kind in ("plain", "fused"):
        state = JaxTrainState.create(jax_model(kind == "fused"),
                                     jax_sgd(jax_step_lr(*SCHEDULE), 0.9, 1e-4),
                                     jax.random.key(0), (1, SIZE, SIZE, 3))
        _, m = jax_make_train_step(single_device_mesh())(
            state, {k: jnp.asarray(v) for k, v in batches()[0].items()})
        got = port_steps[0][f"{kind}/sync/plain"]["metrics"]["loss"][0]
        np.testing.assert_allclose(got, float(m["loss"]), rtol=1e-5)


@functools.lru_cache(maxsize=None)
def jax_trainer_run(tmp: str):
    cfg = JaxTrainerConfig(epochs=1, batch_size=4, lr=0.05, save_dir=tmp, log_every=1,
                           num_workers=0, prefetch=1, flush_every=0,
                           metrics_out=os.path.join(tmp, "metrics.jsonl"))
    trainer = JaxTrainer(jax_model(True), JaxSynthetic(20, SIZE, CLASSES),
                         JaxSynthetic(13, SIZE, CLASSES, seed=1), cfg,
                         mesh=make_mesh(jax.devices()[:RANKS]), input_shape=(1, SIZE, SIZE, 3))
    init = variables(jax.device_get(trainer.state))
    trainer.train_sampler.set_epoch(0)
    trainer.train_epoch(0)
    val = trainer.validate()
    with open(cfg.metrics_out) as f:
        train = [r for r in map(json.loads, f) if r.get("kind") == "train"]
    return init, train, val


def test_trainer_epoch_and_validation_match_jax(tmp_path_factory):
    """20 training images (2 steps of 2 x 4) and 13 validation images: the
    last node batch of 5 is wrap-padded to 6, 3 a rank, the duplicate
    counted (count 14), as the JAX ``validate`` does."""
    init, want_train, want_val = jax_trainer_run(str(tmp_path_factory.mktemp("jax_trainer")))
    job = dict(task="trainer", model=spec(True), params=resnet_params_from_jax(init, fused=True),
               data=dict(n_train=20, n_val=13, size=SIZE, classes=CLASSES),
               config=dict(epochs=1, batch_size=4, lr=0.05, log_every=1))
    results = spawn(tmp_path_factory.mktemp("trainer"), job)
    assert want_val["count"] == 14
    for r in results:
        assert r["steps_per_epoch"] == 2 and len(r["history"]) == len(want_train) == 2
        for got, want in zip(r["history"], want_train):
            assert got["step"] == want["step"]
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(100.0 * got["correct1"] / got["count"], want["acc1"],
                                       rtol=1e-5)
        for k, v in want_val.items():
            np.testing.assert_allclose(r["val"][k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("n_rows, part, wrap, want", [
    (8, (0, 2), False, [0, 1, 2, 3]), (8, (1, 2), False, [4, 5, 6, 7]),
    (5, (1, 2), True, [3, 4, 0]),  # np.resize: 5 rows -> 6
    (1, (1, 4), True, [0]),  # fewer rows than replicas: each takes a copy
    (5, (1, 2), False, [4]), (3, (1, 2), False, []),
])
def test_rank_rows_lay_a_node_batch_out_as_shard_batch(n_rows, part, wrap, want):
    assert rank_rows(n_rows, 8, part, wrap).tolist() == want
    if wrap:
        padded = np.resize(np.arange(n_rows), n_rows + (-n_rows) % part[1])
        assert np.array_split(padded, part[1])[part[0]].tolist() == want


@pytest.mark.parametrize("device, cards, nodes, replicas, multi, want", [
    ("cpu", 0, 1, 2, True, (2, 2)),
    ("cpu", 0, 2, 2, True, (4, 2)),  # each node spawns its --cpu-replicas
    ("cpu", 0, 2, 2, False, (2, 2)),  # resnet_dp ignores the environment
    (None, 1, 1, 1, True, (1, 1)),  # one card: the in-process path
    (None, 0, 1, 1, True, (1, 1)),  # no card: the in-process path raises
    (None, 4, 1, 1, False, (4, 4)),
    (None, 4, 2, 1, True, (8, 4)),
    (None, 4, 2, 1, False, (4, 4)),
])
def test_recipe_grid_factors_the_cards_as_jax(monkeypatch, device, cards, nodes, replicas,
                                              multi, want):
    """``(replicas, ranks on this node)``: a rank a card on every node of
    the environment contract (DDP) or of this one (DP); on the CPU
    ``--cpu-replicas`` a node."""
    monkeypatch.setattr("torch.cuda.device_count", lambda: cards)
    if nodes > 1:
        monkeypatch.setenv("MASTER_IP", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "29500")
        monkeypatch.setenv("WORLD_SIZE", str(nodes))
    else:
        monkeypatch.delenv("MASTER_IP", raising=False)
    argv = ["--tiny", "--cpu-replicas", str(replicas)] + (["--device", device] if device else [])
    assert common.grid(common.parse_args("", argv, replicas=True), multi) == want


@pytest.mark.parametrize("recipe", [resnet_dp, resnet_ddp, resnet_ddp_amp])
def test_recipes_refuse_what_they_cannot_run(monkeypatch, recipe):
    monkeypatch.delenv("MASTER_IP", raising=False)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 0)
    with pytest.raises(SystemExit, match="--cpu-replicas is for --device cpu"):
        recipe.main(["--tiny", "--cpu-replicas", "2"])
    with pytest.raises(SystemExit, match="--cpu-replicas must be >= 1"):
        recipe.main(["--tiny", "--device", "cpu", "--cpu-replicas", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recipe.main(["--tiny", "--synthetic"])  # without a card and --device cpu
    with pytest.raises(SystemExit):
        resnet_single.main(["--tiny", "--cpu-replicas", "2"])  # one card, no replicas


@pytest.mark.parametrize("recipe", ["resnet_dp", "resnet_ddp", "resnet_ddp_amp"])
def test_recipes_run_two_cpu_ranks_to_the_end(recipe, tmp_path):
    """``python -m ...<recipe> --device cpu --tiny --synthetic
    --cpu-replicas 2``: two gloo ranks, two epochs and their validation."""
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_IP", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"  # one torch thread in the recipe's process too
    r = subprocess.run([sys.executable, "-m", f"pytorch_distributed_tpu_torch.recipes.{recipe}",
                        "--device", "cpu", "--tiny", "--synthetic", "--cpu-replicas", "2",
                        "--save-dir", str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    precision = "bf16" if recipe.endswith("amp") else "fp32"
    assert f"2 replicas (1 node(s)), global batch 8, precision {precision}" in r.stdout
    assert r.stdout.count("val loss") == 2 and "done: best acc1" in r.stdout


def test_ranks_per_node_is_known_or_the_trainers_refuse(monkeypatch, tmp_path):
    """The trainers lay a node batch over ``ranks_per_node`` ranks, so it is
    never guessed: a ``tcp://`` rendezvous needs ``procs_per_node``; a
    ``file://`` one holds every rank; a group joined through
    ``torch.distributed`` itself takes ``LOCAL_WORLD_SIZE`` (``torchrun``),
    and without it ``Trainer(mesh=)`` raises."""
    import torch.distributed as dist

    from pytorch_distributed_tpu_torch.data import SyntheticImageClassification
    from pytorch_distributed_tpu_torch.models.resnet import BasicBlock, ResNet
    from pytorch_distributed_tpu_torch.parallel import distributed
    from pytorch_distributed_tpu_torch.parallel.mesh import local_replica_count
    from pytorch_distributed_tpu_torch.parallel.mesh import make_mesh as port_make_mesh
    from pytorch_distributed_tpu_torch.train import Trainer, TrainerConfig

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="pass procs_per_node"):
        distributed.init_process_group("gloo", init_method="tcp://localhost:1",
                                       world_size=2, rank=0)
    assert not dist.is_initialized() and distributed.ranks_per_node() == 1
    distributed.init_process_group("gloo", init_method=f"file://{tmp_path}/a",
                                   world_size=1, rank=0)
    try:
        assert distributed.ranks_per_node() == 1 == distributed.node_count()
    finally:
        distributed.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/b", world_size=1, rank=0)
    try:
        mesh = port_make_mesh(1)
        with pytest.raises(RuntimeError, match="ranks per node unknown"):
            Trainer(ResNet(stage_sizes=(1, 1), block_cls=BasicBlock, num_classes=10,
                           num_filters=8), SyntheticImageClassification(8, 16, 10),
                    SyntheticImageClassification(8, 16, 10), TrainerConfig(batch_size=4),
                    device="cpu", mesh=mesh)
        monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
        assert distributed.ranks_per_node() == 1 == local_replica_count(mesh)
        assert distributed.node_index() == 0 and distributed.node_count() == 1
    finally:
        distributed.destroy_process_group()
