"""The port's ResNet training path against the JAX package's.

Same weights (the JAX ``TrainState``'s, carried across by
``resnet_params_from_jax``), same numpy batches, fp32: three SGD steps of
the whole train step under ``step_lr`` against ``make_train_step`` on a
one-device mesh (losses, metrics, parameters, BatchNorm statistics), the
eval step, the optimizer and schedule against optax, the synthetic data
sample for sample, and the trainer and recipe run to their end on the CPU.

Tolerances are fp32 summation-order ones: 1e-5 relative on losses and
metrics, 2e-5 absolute on parameters and statistics of order 1 after three
steps at lr 0.1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_tpu.data import SyntheticImageClassification as JaxSynthetic
from pytorch_distributed_tpu.data.loader import _collate as jax_collate
from pytorch_distributed_tpu.models import resnet as jresnet
from pytorch_distributed_tpu.ops.metrics import ClassificationMetrics as JaxMetrics
from pytorch_distributed_tpu.ops.metrics import topk_correct as jax_topk
from pytorch_distributed_tpu.ops.optim import sgd_with_weight_decay as jax_sgd
from pytorch_distributed_tpu.ops.schedules import step_lr as jax_step_lr
from pytorch_distributed_tpu.parallel import single_device_mesh
from pytorch_distributed_tpu.train.state import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.step import make_eval_step as jax_make_eval_step
from pytorch_distributed_tpu.train.step import make_train_step as jax_make_train_step
from pytorch_distributed_tpu.train.step import prepare_image as jax_prepare_image
from pytorch_distributed_tpu_torch.data import SyntheticImageClassification, image_collate
from pytorch_distributed_tpu_torch.models import resnet
from pytorch_distributed_tpu_torch.models.convert import (
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from pytorch_distributed_tpu_torch.ops.metrics import ClassificationMetrics, topk_correct
from pytorch_distributed_tpu_torch.ops.optim import sgd_with_weight_decay
from pytorch_distributed_tpu_torch.ops.precision import NoOpLossScaler, bf16_policy, fp32_policy
from pytorch_distributed_tpu_torch.ops.schedules import step_lr
from pytorch_distributed_tpu_torch.recipes import resnet_single
from pytorch_distributed_tpu_torch.train import (
    Trainer,
    TrainerConfig,
    create_resnet_state,
    make_eval_step,
    make_train_step,
    prepare_image,
)

MODELS = {"basic": (jresnet.BasicBlock, resnet.BasicBlock, False),
          "fused": (jresnet.BottleneckBlock, resnet.BottleneckBlock, True)}


def batches(n, b=4, size=32, classes=10, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((b, size, size, 3)).astype(np.float32),
             "label": rng.integers(0, classes, b).astype(np.int32)} for _ in range(n)]


def assert_tree_close(got, want, atol, what=""):
    fg, tg = jax.tree_util.tree_flatten_with_path(got)
    fw, tw = jax.tree_util.tree_flatten_with_path(want)
    assert tg == tw
    for (path, a), (_, b) in zip(fg, fw):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("kind,smoothing,clip", [("basic", 0.1, 0.0), ("fused", 0.0, 1.0)])
def test_three_sgd_steps_match_make_train_step(kind, smoothing, clip):
    """Losses, metrics, parameters and BatchNorm statistics of three steps
    under step_lr (lr drops by gamma at step 2), with label smoothing or
    global-norm clipping; then the eval step's sums."""
    jblock, tblock, fused = MODELS[kind]
    jmodel = jresnet.ResNet(stage_sizes=(1, 1), block_cls=jblock, num_classes=10,
                            num_filters=8, fused_bottleneck=fused)
    jschedule = jax_step_lr(0.1, steps_per_epoch=1, step_size_epochs=2, gamma=0.1)
    jstate = JaxTrainState.create(jmodel, jax_sgd(jschedule, 0.9, 1e-4), jax.random.key(0),
                                  (1, 32, 32, 3))
    mesh = single_device_mesh()
    jstep = jax_make_train_step(mesh, label_smoothing=smoothing, grad_clip_norm=clip)
    variables = {"params": jax.tree.map(np.asarray, jstate.params),
                 "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}

    model = resnet.ResNet(stage_sizes=(1, 1), block_cls=tblock, num_classes=10, num_filters=8,
                          fused_bottleneck=fused)
    state = create_resnet_state(model, lr_schedule=step_lr(0.1, 1, 2, 0.1),
                                params=resnet_params_from_jax(variables, fused=fused),
                                device="cpu")
    step = make_train_step(label_smoothing=smoothing, grad_clip_norm=clip)
    for i, b in enumerate(batches(3)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=f"{k}@{i}")
    assert state.step == int(jstate.step) == 3
    got = resnet_params_to_jax(state.model.state_dict())
    assert_tree_close(got["params"], jstate.params, 2e-5, "params")
    assert_tree_close(got["batch_stats"], jstate.batch_stats, 2e-5, "batch_stats")

    eb = batches(1, seed=9)[0]
    jmet = jax_make_eval_step(mesh)(
        jstate, {k: jnp.asarray(v) for k, v in eb.items()},
        JaxMetrics.empty())
    met = make_eval_step()(state, {k: torch.from_numpy(v) for k, v in eb.items()},
                           ClassificationMetrics.empty())
    for k, v in jax.device_get(jmet).summary().items():
        np.testing.assert_allclose(met.summary()[k], v, rtol=1e-5, err_msg=k)


def test_nan_guard_keeps_parameters_momenta_and_statistics():
    model = resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BottleneckBlock, num_classes=10,
                          num_filters=8, fused_bottleneck=True)
    state = create_resnet_state(model, lr_schedule=lambda s: 0.1, device="cpu")
    step = make_train_step(nan_guard=True)
    b = {k: torch.from_numpy(v) for k, v in batches(1)[0].items()}
    state, m = step(state, b)
    assert float(m["step_good"]) == 1.0
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    bad = dict(b, image=b["image"].clone())
    bad["image"][0, 0, 0, 0] = float("nan")
    state, m = step(state, bad)
    assert float(m["step_good"]) == 0.0 and state.step == 2
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)


def test_sgd_and_step_lr_match_optax():
    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(4)]
    jschedule = jax_step_lr(0.1, steps_per_epoch=2, step_size_epochs=1, gamma=0.5)
    tx = jax_sgd(jschedule, 0.9, 1e-4)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("a", "b")]
    opt = sgd_with_weight_decay(tp, 0.9, 1e-4)
    schedule = step_lr(0.1, steps_per_epoch=2, step_size_epochs=1, gamma=0.5)
    for i, g in enumerate(grads):
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for group in opt.param_groups:
            group["lr"] = schedule(i)
        for p, k in zip(tp, ("a", "b")):
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for p, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{k}@{i}")
    for s in (0, 1, 2, 3, 5, 6, 59, 60, 61, 100):
        for args in ((0.1, 2, 1, 0.5), (0.1, 7, 30, 0.1), (0.05, 1, 3, 0.1)):
            np.testing.assert_allclose(step_lr(*args)(s), float(jax_step_lr(*args)(s)),
                                       rtol=1e-6, err_msg=f"{args}@{s}")


def test_metrics_precision_and_prepare_image_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    got = topk_correct(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jax_topk(jnp.asarray(logits), jnp.asarray(labels))
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    few = topk_correct(torch.from_numpy(logits[:, :3]), torch.from_numpy(labels % 3))
    assert float(few["correct5"]) == 16.0  # top-5 of 3 classes always hits
    pixels = rng.integers(0, 256, (2, 4, 4, 3)).astype(np.uint8)
    np.testing.assert_allclose(prepare_image(torch.from_numpy(pixels)).numpy(),
                               np.asarray(jax_prepare_image(jnp.asarray(pixels))), rtol=1e-6)
    floats = torch.from_numpy(logits)
    assert prepare_image(floats) is floats
    assert fp32_policy().compute_dtype == torch.float32
    assert bf16_policy().cast_to_compute({"x": floats, "i": torch.ones(2, dtype=torch.int32)})[
        "x"].dtype == torch.bfloat16
    scaler = NoOpLossScaler()
    assert scaler.scale_loss(floats) is floats and scaler.update(True) is scaler


def test_synthetic_images_equal_the_jax_package_sample_for_sample():
    for seed in (0, 1):
        mine = SyntheticImageClassification(50, 16, 10, seed=seed)
        ref = JaxSynthetic(50, 16, 10, seed=seed)
        assert len(mine) == len(ref)
        for i in (0, 1, 9, 10, 49):
            a, b = mine[i], ref[i]
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
        got, want = image_collate([mine[i] for i in range(4)]), jax_collate(
            [ref[i] for i in range(4)])
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(IndexError):
        SyntheticImageClassification(3, 8, 2)[3]


def test_trainer_fit_runs_to_the_end_on_cpu(tmp_path):
    model = resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BottleneckBlock, num_classes=4,
                          num_filters=8, fused_bottleneck=True)
    cfg = TrainerConfig(epochs=2, batch_size=8, lr=0.05, log_every=1, save_dir=str(tmp_path))
    trainer = Trainer(model, SyntheticImageClassification(32, 16, 4),
                      SyntheticImageClassification(12, 16, 4, seed=1), cfg, device="cpu")
    summary = trainer.fit()
    assert trainer.state.step == 8
    assert len(trainer.history) == 8
    assert all(np.isfinite(r["loss"]) and r["step_s"] >= r["data_s"] >= 0
               for r in trainer.history)
    assert summary["count"] == 12 and np.isfinite(summary["loss"])
    assert summary["best_acc"] == max(summary["acc1"], trainer.best_acc)
    # the lr schedule steps by epoch: 4 steps an epoch, StepLR(30) keeps lr
    assert trainer.state.lr_schedule(7) == pytest.approx(0.05)


def test_recipe_runs_to_the_end_on_cpu(tmp_path):
    summary = resnet_single.main(["--tiny", "--synthetic", "--device", "cpu", "--epochs", "1",
                                  "--save-dir", str(tmp_path)])
    assert summary["count"] == 64 and np.isfinite(summary["loss"])
    # without --synthetic the recipe reads the packed splits of --data-dir,
    # and a directory without them names the tool that packs them
    with pytest.raises(FileNotFoundError, match="pack_imagenet"):
        resnet_single.main(["--device", "cpu", "--data-dir", str(tmp_path / "none")])
