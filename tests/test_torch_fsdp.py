"""ZeRO-3 FSDP in the port against the JAX package's.

Two gloo ranks on the CPU (``tools/parallel_check.py``, one spawn of the
dp 2 grid running every case, and one of the dp 2 x sp 2 grid) against
JAX ``make_lm_train_step(fsdp=True)`` and the FSDP ``make_train_step``
(``Trainer(fsdp=True)``'s step) over meshes of the virtual CPU devices,
the tiny configs in fp32, from the JAX weights, on the same global
batches:

- ``fsdp_dim`` picks JAX's dimension for every shape of a table;
- three LM steps at dp 2, clipping on and off: losses and grad norms to
  1e-5 relative, the gathered parameters to the JAX ones (AdamW turns the
  rounding noise of a near-zero gradient into about lr a step, so 2e-5
  absolute after three steps at lr 3e-4), and the port's replicated dp 2
  run alike; the eval step's sums equal the replicated run's; each rank's
  parameter and optimizer bytes are at most 0.55 of the replicated
  rank's;
- three LM steps at dp 2 x sp 2 with ring attention, against JAX;
- three ResNet steps under FSDP (fused bottleneck blocks) against JAX,
  and the fp16 scaler with an inf in rank 1's rows: every rank skips the
  update and halves the scale;
- checkpoints: an FSDP trainer's suspend resumes into a replicated trainer
  and the reverse, each ending where the uninterrupted run of its kind
  ends; a JAX FSDP ``LMTrainer``'s suspend checkpoint restores into the
  port bit for bit;
- ``recipes/lm_pretrain.py --device cpu --tiny --fsdp`` runs to its end.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data.tokens import SyntheticTokens as JaxTokens
from pytorch_distributed_tpu.models import resnet as jresnet
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.ops.optim import build_optimizer as jax_build_optimizer
from pytorch_distributed_tpu.ops.optim import sgd_with_weight_decay as jax_sgd
from pytorch_distributed_tpu.ops.schedules import step_lr as jax_step_lr
from pytorch_distributed_tpu.ops.schedules import warmup_cosine as jax_warmup_cosine
from pytorch_distributed_tpu.parallel import make_mesh, shard_batch, shard_fsdp_state
from pytorch_distributed_tpu.parallel.fsdp import fsdp_dim as jax_fsdp_dim
from pytorch_distributed_tpu.resilience import faults as jfaults
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from pytorch_distributed_tpu.train.lm_trainer import LMTrainerConfig as JaxLMTrainerConfig
from pytorch_distributed_tpu.train.lm_trainer import shard_lm_batch as jax_shard_lm_batch
from pytorch_distributed_tpu.train.state import TrainState as JaxTrainState
from pytorch_distributed_tpu.train.step import make_train_step as jax_make_train_step
from pytorch_distributed_tpu.utils.suspend import SuspendWatcher as JaxSuspendWatcher
from pytorch_distributed_tpu_torch.data import SyntheticTokens
from pytorch_distributed_tpu_torch.models import params_from_jax, params_to_jax, tiny_config
from pytorch_distributed_tpu_torch.models.convert import resnet_params_from_jax
from pytorch_distributed_tpu_torch.parallel.fsdp import fsdp_dim
from pytorch_distributed_tpu_torch.tools import parallel_check
from pytorch_distributed_tpu_torch.train import LMTrainer, LMTrainerConfig, lm_collate

SEQ, BATCH, VOCAB = 16, 4, 128
SCHED = (3e-4, 100, 0, 3e-4)  # warmup_cosine: lr 3e-4 throughout the three steps
MODEL = dict(vocab_size=VOCAB, num_layers=2, num_heads=2, embed_dim=32, max_seq_len=SEQ,
             dtype="float32", attention="dense")
RESNET = dict(stage_sizes=(1, 1), block="bottleneck", num_classes=10, num_filters=16,
              fused=True)
RESNET_SCHEDULE = (0.1, 1, 30, 0.1)  # step_lr: lr 0.1 throughout
IMAGE = 16
PLANT = (1, 1)  # an inf in rank 1's rows at step 1


def lm_batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [lm_collate(list(rng.integers(1, VOCAB, (BATCH, SEQ)).astype(np.int32)))
            for _ in range(n)]


def image_batches():
    rng = np.random.default_rng(3)
    return [{"image": rng.standard_normal((8, IMAGE, IMAGE, 3)).astype(np.float32),
             "label": rng.integers(0, 10, 8).astype(np.int32)} for _ in range(3)]


def jax_resnet_state(scaler=None):
    model = jresnet.ResNet(stage_sizes=(1, 1), block_cls=jresnet.BottleneckBlock,
                           num_classes=10, num_filters=16, fused_bottleneck=True)
    return JaxTrainState.create(model, jax_sgd(jax_step_lr(*RESNET_SCHEDULE), 0.9, 1e-4),
                                jax.random.key(0), (1, IMAGE, IMAGE, 3), scaler=scaler)


def jax_lm_state(attention="dense"):
    cfg = jax_tiny_config(attention=attention, max_seq_len=SEQ)
    tx = jax_build_optimizer("adamw", jax_warmup_cosine(*SCHED), weight_decay=0.1)
    return cfg, jax_lm.create_lm_state(cfg, tx, jax.random.key(0), init_len=SEQ)


def as_np(tree):
    return jax.tree.map(lambda x: np.array(jax.device_get(x)), tree)


@functools.lru_cache(maxsize=None)
def jax_lm_run(clip: float, sp: int = 1):
    """JAX FSDP: three steps on a (2 x sp) mesh and the eval sums."""
    attention = "ring" if sp > 1 else "dense"
    cfg, state = jax_lm_state(attention)
    mesh = make_mesh(jax.devices()[:2 * sp], seq_parallel=sp)
    state, specs = jax_lm.shard_lm_state(mesh, state, cfg, fsdp=True)
    step = jax_lm.make_lm_train_step(mesh, state_specs=specs, config=cfg, fsdp=True,
                                     grad_clip_norm=clip)
    metrics = []
    for b in lm_batches():
        state, m = step(state, jax_shard_lm_batch(mesh, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, as_np(state.params)


def jax_init_params(attention="dense"):
    return params_from_jax(as_np(jax_lm_state(attention)[1].params))


def jax_resnet_init():
    s = jax_resnet_state()
    return resnet_params_from_jax({"params": as_np(s.params),
                                   "batch_stats": as_np(s.batch_stats)}, fused=True)


@functools.lru_cache(maxsize=None)
def jax_resnet_run():
    mesh = make_mesh(jax.devices()[:2])
    state, specs = shard_fsdp_state(mesh, jax_resnet_state())
    step = jax_make_train_step(mesh, state_specs=specs)
    metrics = []
    for b in image_batches():
        state, m = step(state, shard_batch(mesh, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, as_np(state.params)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this process, as the gloo ranks it spawns take:
    the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spawn(tmp, job: dict):
    job = dict(job, backend="gloo", rendezvous=f"file://{tmp}/rendezvous", out=str(tmp / "out"),
               device="cpu", timeout_s=120)
    parallel_check.run(job, parallel_check.world(job))
    return parallel_check.load(job)


def trainer_run(save_dir, fsdp: bool, suspend_at=None) -> dict:
    return dict(model=MODEL, batch=2, seq=SEQ, n_train=16, n_val=4, suspend_at=suspend_at,
                config=dict(epochs=1, batch_size=2, lr=3e-4, warmup_steps=0, log_every=1,
                            save_dir=str(save_dir), fsdp=fsdp))


TRAINER_RUNS = (("fsdp full", True, None, "a"), ("replicated full", False, None, "b"),
                ("fsdp suspended", True, 2, "x"), ("replicated resumed", False, None, "x"),
                ("replicated suspended", False, 2, "y"), ("fsdp resumed", True, None, "y"))


@pytest.fixture(scope="module")
def port_dp2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_dp2")
    init = jax_init_params()
    lm_cases = {f"{mode}/clip={clip}": dict(model=MODEL, mode=mode, clip=clip, params=init)
                for mode in ("fsdp", "replicated") for clip in (0.0, 1.0)}
    resnet_init = jax_resnet_init()
    resnet_cases = {
        "fsdp": dict(model=RESNET, fsdp=True, schedule=RESNET_SCHEDULE, params=resnet_init),
        "fsdp fp16": dict(model=dict(RESNET, fused=False), fsdp=True, scaler={},
                          schedule=RESNET_SCHEDULE, plant=PLANT),
    }
    runs = [trainer_run(tmp / d, fsdp, at) for _, fsdp, at, d in TRAINER_RUNS]
    jobs = {"lm": dict(task="lm", cases=lm_cases, batches=lm_batches(),
                       val_batches=lm_batches(2, seed=9), schedule=SCHED),
            "resnet": dict(task="resnet", cases=resnet_cases, batches=image_batches()),
            "trainer": dict(task="trainer", runs=runs)}
    for fsdp in (True, False):
        jobs[f"image trainer fsdp={fsdp}"] = dict(
            task="image_trainer", model=dict(RESNET, fused=False),
            data=dict(n_train=16, n_val=6, size=IMAGE, classes=10),
            config=dict(epochs=1, batch_size=2, lr=0.05, num_workers=0, log_every=1,
                        save_dir=str(tmp / f"image-{fsdp}"), fsdp=fsdp))
    return spawn(tmp, dict(task="many", jobs=jobs, dp=2))


@pytest.fixture(scope="module")
def port_dp2_sp2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_dp2_sp2")
    cases = {"fsdp": dict(model=dict(MODEL, attention="ring"), mode="fsdp", clip=1.0,
                          params=jax_init_params("ring"))}
    return spawn(tmp, dict(task="lm", cases=cases, batches=lm_batches(), schedule=SCHED,
                           dp=2, sp=2))


SHAPES = [(4096, 128), (127, 4096), (63,), (1031, 1031), (), (32000, 768), (768, 2304),
          (3, 3, 64, 64), (2048,), (1024,), (1000,), (7, 7, 3, 64), (2048, 1000), (4, 32, 128),
          (2, 2, 2, 2, 64)]


@pytest.mark.parametrize("axis", [2, 4, 8])
def test_fsdp_dim_equals_jax(axis):
    for shape in SHAPES:
        assert fsdp_dim(shape, axis) == jax_fsdp_dim(shape, axis), shape


LR = SCHED[0]


def assert_params_close(got: dict, want: dict, atol: float, key_bias_atol: float = 3 * LR):
    """Leaf by leaf to ``atol``, but the attention's key bias, whose
    gradient is zero but for rounding noise (softmax ignores a shift of
    the keys) that AdamW scales to about lr a step, to 3 steps' lr
    (``tests/test_torch_lm_dp.py``)."""
    got, want = jax.tree.map(np.array, got), jax.tree.map(np.array, want)
    for p in (got, want):
        for name, block in p.items():
            if name.startswith("block") and "qkv" in block["attn"]:
                k_bias = block["attn"]["qkv"]["bias"][1].copy()
                block["attn"]["qkv"]["bias"][1] = 0.0
                p[name]["k_bias"] = {"value": k_bias}
    fg, tg = jax.tree_util.tree_flatten_with_path(got)
    fw, tw = jax.tree_util.tree_flatten_with_path(want)
    assert tg == tw
    for (path, a), (_, b) in zip(fg, fw):
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, b, rtol=0, err_msg=name,
                                   atol=key_bias_atol if "k_bias" in name else atol)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_fsdp_lm_steps_match_jax_fsdp(port_dp2, clip):
    want, want_params = jax_lm_run(clip)
    cfg = tiny_config(attention="dense", max_seq_len=SEQ)
    for mode in ("fsdp", "replicated"):
        for r in port_dp2:
            got = r["lm"][f"{mode}/clip={clip}"]["metrics"]
            for i, w in enumerate(want):
                for k in ("loss", "tokens") + (("grad_norm",) if clip else ()):
                    np.testing.assert_allclose(got[k][i], w[k], rtol=1e-5,
                                               err_msg=f"{mode} {k}@{i}")
            assert r["lm"][f"{mode}/clip={clip}"]["step"] == 3
        assert_params_close(params_to_jax(port_dp2[0]["lm"][f"{mode}/clip={clip}"]["params"],
                                          cfg), want_params, 2e-5)


def test_fsdp_lm_matches_the_ports_replicated_run(port_dp2):
    """The same steps, sharded or not: losses and grad norms to 1e-6."""
    for r in port_dp2:
        for clip in (0.0, 1.0):
            f, p = (r["lm"][f"{m}/clip={clip}"]["metrics"] for m in ("fsdp", "replicated"))
            for k in ("loss", "grad_norm") if clip else ("loss",):
                np.testing.assert_allclose(f[k], p[k], rtol=1e-6, err_msg=k)


def test_fsdp_eval_equals_replicated_eval(port_dp2):
    for r in port_dp2:
        f, p = r["lm"]["fsdp/clip=1.0"]["val"], r["lm"]["replicated/clip=1.0"]["val"]
        assert f["tokens"] == p["tokens"] == 2 * BATCH * (SEQ - 1)
        np.testing.assert_allclose(f["loss_sum"], p["loss_sum"], rtol=1e-6)


def test_fsdp_rank_holds_at_most_055_of_the_replicated_state(port_dp2):
    for r in port_dp2:
        f, p = (r["lm"][f"{m}/clip=1.0"]["state_bytes"] for m in ("fsdp", "replicated"))
        assert f <= 0.55 * p, (f, p)


def test_fsdp_dp2_sp2_ring_matches_jax(port_dp2_sp2):
    want, want_params = jax_lm_run(1.0, sp=2)
    for r in port_dp2_sp2:
        got = r["fsdp"]["metrics"]
        for i, w in enumerate(want):
            for k in ("loss", "grad_norm", "tokens"):
                np.testing.assert_allclose(got[k][i], w[k], rtol=1e-5, err_msg=f"{k}@{i}")
    cfg = tiny_config(attention="ring", max_seq_len=SEQ)
    assert_params_close(params_to_jax(port_dp2_sp2[0]["fsdp"]["params"], cfg), want_params, 2e-5)


def test_fsdp_resnet_steps_match_jax_fsdp(port_dp2):
    from pytorch_distributed_tpu_torch.models.convert import resnet_params_to_jax

    want, want_params = jax_resnet_run()
    for r in port_dp2:
        got = r["resnet"]["fsdp"]["metrics"]
        for i, w in enumerate(want):
            for k in ("loss", "correct1", "count"):
                np.testing.assert_allclose(got[k][i], w[k], rtol=1e-5, err_msg=f"{k}@{i}")
        assert got["launches"] == [[0, 0, 0]] * 3  # CPU tensors: the plain versions
        assert r["resnet"]["fsdp"]["updates"] == 3
    tree = resnet_params_to_jax(port_dp2[0]["resnet"]["fsdp"]["params"])
    assert_params_close(tree["params"], want_params, 2e-5)


def test_the_image_trainer_under_fsdp_trains_as_replicated(port_dp2):
    """``Trainer(fsdp=True)``: an epoch and a validation pass equal the
    replicated trainer's (losses to 1e-6, the validation counts exactly)."""
    for r in port_dp2:
        f, p = (r[f"image trainer fsdp={x}"] for x in (True, False))
        assert len(f["history"]) == len(p["history"]) == 4
        np.testing.assert_allclose([h["loss"] for h in f["history"]],
                                   [h["loss"] for h in p["history"]], rtol=1e-6)
        assert f["val"]["count"] == p["val"]["count"] == 6
        np.testing.assert_allclose(f["val"]["loss"], p["val"]["loss"], rtol=1e-6)


def test_fsdp_fp16_scaler_skips_an_inf_on_one_rank(port_dp2):
    for r in port_dp2:
        case = r["resnet"]["fsdp fp16"]
        m = case["metrics"]
        assert m["grads_finite"] == [1.0, 0.0, 1.0]
        assert m["param_change"][PLANT[0]] == 0.0
        assert m["scale"][PLANT[0]] == m["scale"][0] / 2
        assert case["updates"] == 2


def _trainer_params(port_dp2, label):
    i = [t[0] for t in TRAINER_RUNS].index(label)
    return port_dp2[0]["trainer"][i]


@pytest.mark.parametrize("suspended,resumed,full", [
    ("fsdp suspended", "replicated resumed", "replicated full"),
    ("replicated suspended", "fsdp resumed", "fsdp full")])
def test_fsdp_and_replicated_checkpoints_interchange(port_dp2, suspended, resumed, full):
    """A suspend of one kind resumes in the other and ends where the
    uninterrupted run of the other kind ends (the two kinds' sums differ
    only in rounding: 2e-5 absolute, AdamW at lr 3e-4)."""
    first = _trainer_params(port_dp2, suspended)
    assert first["suspended"] and first["step"] == 2
    got, want = _trainer_params(port_dp2, resumed), _trainer_params(port_dp2, full)
    assert not got["suspended"] and got["step"] == want["step"] == 4
    cfg = tiny_config(attention="dense", max_seq_len=SEQ)
    assert_params_close(params_to_jax(got["params"], cfg), params_to_jax(want["params"], cfg),
                        2e-5, 4 * LR)


def test_a_jax_fsdp_checkpoint_restores_into_the_port(tmp_path):
    """JAX ``LMTrainer(fsdp=True)`` on two devices, suspended after step 2:
    the port reads its sharded leaves back bit for bit."""
    from pytorch_distributed_tpu.data.tokens import SyntheticTokens as JT

    spec = [jfaults.FaultSpec("train.step", "suspend", at=2)]
    jfaults.install_plan(jfaults.FaultPlan(spec))
    try:
        cfg = JaxLMTrainerConfig(epochs=1, batch_size=2, lr=3e-4, warmup_steps=0, log_every=0,
                                 save_dir=str(tmp_path), flush_every=0, fsdp=True,
                                 metrics_out=str(tmp_path / "metrics.jsonl"))
        jt = JaxLMTrainer(jax_tiny_config(attention="dense", max_seq_len=SEQ),
                          JaxTokens(16, SEQ, VOCAB), JT(4, SEQ, VOCAB, seed=1), cfg,
                          mesh=make_mesh(jax.devices()[:2]),
                          suspend_watcher=JaxSuspendWatcher(install_handlers=False))
        with pytest.raises(SystemExit):
            jt.fit()
    finally:
        jfaults.clear_plan()
    want = as_np(jt.state.params)
    port = LMTrainer(tiny_config(attention="dense", max_seq_len=SEQ),
                     SyntheticTokens(16, SEQ, VOCAB), SyntheticTokens(4, SEQ, VOCAB, seed=1),
                     LMTrainerConfig(epochs=1, batch_size=4, save_dir=str(tmp_path)),
                     device="cpu")
    assert port.try_resume()
    assert port.state.step == int(jt.state.step) == port.start_step == 3
    got = params_to_jax(port.state.model.state_dict(), tiny_config(max_seq_len=SEQ))
    assert_params_close(got, want, 0.0, 0.0)


def test_the_recipe_runs_fsdp_on_cpu_ranks(tmp_path):
    from pytorch_distributed_tpu_torch.recipes import lm_pretrain

    summary = lm_pretrain.main(["--device", "cpu", "--tiny", "--fsdp",
                                "--epochs", "1", "--steps", "2", "--log-every", "1",
                                "--save-dir", str(tmp_path / "out")])
    assert np.isfinite(summary["loss"]) and summary["ppl"] > 1.0, summary
