"""Suspend and resume through both trainers, against the uninterrupted run
and against the JAX package.

- Within the port, on the CPU: a run suspended at step k (mid-epoch, and
  on an epoch's last step, which resumes into validation) and resumed by
  a fresh trainer ends bit for bit where the uninterrupted run ends:
  every state tensor, ``step``, ``updates``, the fp16 scaler and
  ``best_acc`` / ``best_ppl``.
- From a JAX checkpoint: the JAX ``Trainer`` / ``LMTrainer`` suspends at
  step k; the port resumes from that directory (``models.convert``) and
  ends where the uninterrupted JAX run ends: losses to 1e-5 relative,
  parameters to 2e-5 absolute (fp32 summation order, the tolerances of
  ``tests/test_torch_resnet_train.py`` and ``tests/test_torch_lm_train.py``;
  the LM's key bias to 3 lr, as there).
- Two gloo ranks (``tools/resume_check.py``): only rank 1 gets the
  signal; both save at the agreement step and exit 0, and the resume is
  exact; with ``suspend_sync_every=2`` the save waits for the next
  agreement step.
- The recipes: a flag-file suspend and a second run that resumes, and a
  SIGKILL inside a shard write (``PDT_FAULT_PLAN``) that the relaunch
  survives.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data import SyntheticImageClassification as JaxSynthetic
from pytorch_distributed_tpu.data import SyntheticTokens as JaxTokens
from pytorch_distributed_tpu.models import resnet as jresnet
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.parallel import make_mesh, single_device_mesh
from pytorch_distributed_tpu.resilience import faults as jfaults
from pytorch_distributed_tpu.train import LMTrainer as JaxLMTrainer
from pytorch_distributed_tpu.train import LMTrainerConfig as JaxLMTrainerConfig
from pytorch_distributed_tpu.train import Trainer as JaxTrainer
from pytorch_distributed_tpu.train import TrainerConfig as JaxTrainerConfig
from pytorch_distributed_tpu.utils.suspend import SuspendWatcher as JaxSuspendWatcher
from pytorch_distributed_tpu_torch.data import SyntheticImageClassification, SyntheticTokens
from pytorch_distributed_tpu_torch.models import params_to_jax, resnet, tiny_config
from pytorch_distributed_tpu_torch.models.convert import resnet_params_to_jax
from pytorch_distributed_tpu_torch.recipes import lm_pretrain, resnet_single
from pytorch_distributed_tpu_torch.resilience import faults
from pytorch_distributed_tpu_torch.resilience.faults import FaultPlan, FaultSpec
from pytorch_distributed_tpu_torch.tools import resume_check
from pytorch_distributed_tpu_torch.train import LMTrainer, LMTrainerConfig, Trainer, TrainerConfig
from pytorch_distributed_tpu_torch.train.state import state_payload
from pytorch_distributed_tpu_torch.utils.suspend import SuspendWatcher

REPO = Path(__file__).resolve().parent.parent
SIZE, CLASSES, SEQ, VOCAB = 16, 4, 16, 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread in this process, as the gloo ranks it spawns take:
    the test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear_plan()
    jfaults.clear_plan()
    yield
    faults.clear_plan()
    jfaults.clear_plan()


def suspend_at(k: int):
    """The ``train.step`` suspend directive at step k, in both packages."""
    spec = [FaultSpec("train.step", "suspend", at=k)]
    faults.install_plan(FaultPlan(spec))
    jfaults.install_plan(jfaults.FaultPlan.from_json(FaultPlan(spec).to_json()))


def resnet_trainer(save_dir, watcher=None, precision="fp32", epochs=2) -> Trainer:
    model = resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BottleneckBlock,
                          num_classes=CLASSES, num_filters=8, fused_bottleneck=True)
    cfg = TrainerConfig(epochs=epochs, batch_size=8, lr=0.05, precision=precision,
                        save_dir=str(save_dir), log_every=0)
    return Trainer(model, SyntheticImageClassification(32, SIZE, CLASSES),
                   SyntheticImageClassification(12, SIZE, CLASSES, seed=1), cfg, device="cpu",
                   suspend_watcher=watcher)


def lm_trainer(save_dir, watcher=None, attention="flash", epochs=2, n_train=16, batch=4,
               lr=3e-3) -> LMTrainer:
    cfg = LMTrainerConfig(epochs=epochs, batch_size=batch, lr=lr,
                          log_every=0, grad_clip_norm=1.0, save_dir=str(save_dir))
    return LMTrainer(tiny_config(attention=attention, max_seq_len=SEQ),
                     SyntheticTokens(n_train, SEQ, VOCAB), SyntheticTokens(6, SEQ, VOCAB, seed=1),
                     cfg, device="cpu", suspend_watcher=watcher)


def snapshot(trainer) -> dict:
    out = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
           for k, v in state_payload(trainer.state).items()}
    out["best"] = trainer.best_acc if hasattr(trainer, "best_acc") else trainer.best_ppl
    return out


def assert_bitwise(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == got[k].dtype and torch.equal(got[k], v), k
        else:
            assert got[k] == v, k


def suspend_then_resume(make, tmp_path, k):
    """The uninterrupted run, and the run suspended at step k then fitted
    to its end by a fresh trainer on the same directory."""
    full = make(tmp_path / "full")
    full_summary = full.fit()
    suspend_at(k)
    first = make(tmp_path / "resumed", SuspendWatcher(install_handlers=False))
    with pytest.raises(SystemExit) as e:
        first.fit()
    assert e.value.code == 0 and first.ckpt.has_latest()
    faults.clear_plan()
    second = make(tmp_path / "resumed")
    summary = second.fit()
    return full, full_summary, first, second, summary


@pytest.mark.parametrize("k, precision", [(2, "fp16"), (3, "fp32"), (5, "fp32")])
def test_resnet_resume_is_bitwise_the_uninterrupted_run(tmp_path, k, precision):
    """4 steps an epoch: k = 2 mid-epoch (fp16: the scaler's state too),
    3 (the first epoch's last step: the resume starts with its
    validation), 5 (the second epoch, after a best save)."""
    full, want, first, second, got = suspend_then_resume(
        lambda d, w=None: resnet_trainer(d, w, precision), tmp_path, k)
    assert first.state.step == k + 1
    assert_bitwise(snapshot(second), snapshot(full))
    assert got == want
    if precision == "fp16":
        assert "state/scaler/scale" in snapshot(second)


@pytest.mark.parametrize("k", [1, 3])
def test_lm_resume_is_bitwise_the_uninterrupted_run(tmp_path, k):
    """4 steps an epoch of 4 sequences: k = 1 mid-epoch, 3 the epoch's last
    step; AdamW's moments and step, updates and best_ppl."""
    full, want, first, second, got = suspend_then_resume(lm_trainer, tmp_path, k)
    assert first.state.step == k + 1
    assert_bitwise(snapshot(second), snapshot(full))
    assert got == want
    assert any(p.endswith("/exp_avg_sq") for p in snapshot(second))


def assert_close_tree(got, want, atol, what=""):
    fg, tg = jax.tree_util.tree_flatten_with_path(got)
    fw, tw = jax.tree_util.tree_flatten_with_path(want)
    assert tg == tw
    for (path, a), (_, b) in zip(fg, fw):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def test_resnet_resumes_from_a_jax_checkpoint(tmp_path):
    """The JAX fused-bottleneck ``Trainer`` suspends at step 5 (the second
    epoch); the port resumes from its directory: parameters, statistics,
    momenta, the schedule's count and best_acc carry over."""

    def jax_trainer(d, watcher=None):
        model = jresnet.ResNet(stage_sizes=(1, 1), block_cls=jresnet.BottleneckBlock,
                               num_classes=CLASSES, num_filters=8, fused_bottleneck=True)
        cfg = JaxTrainerConfig(epochs=2, batch_size=8, lr=0.05, save_dir=str(d), log_every=0,
                               num_workers=0, prefetch=1, flush_every=0,
                               metrics_out=str(d / "metrics.jsonl"))
        return JaxTrainer(model, JaxSynthetic(32, SIZE, CLASSES),
                          JaxSynthetic(12, SIZE, CLASSES, seed=1), cfg,
                          mesh=single_device_mesh(), suspend_watcher=watcher,
                          input_shape=(1, SIZE, SIZE, 3))

    full = jax_trainer(tmp_path / "full")
    want = full.fit()
    suspend_at(5)
    with pytest.raises(SystemExit):
        jax_trainer(tmp_path / "jax", JaxSuspendWatcher(install_handlers=False)).fit()
    faults.clear_plan()
    port = resnet_trainer(tmp_path / "jax")
    got = port.fit()
    assert (port.state.step, port.state.updates) == (int(full.state.step), 8)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["best_acc"] == pytest.approx(want["best_acc"], rel=1e-5)
    tree = resnet_params_to_jax(port.state.model.state_dict())
    for part in ("params", "batch_stats"):
        assert_close_tree(tree[part], jax.device_get(getattr(full.state, part)), 2e-5, part)
    momenta = resnet_params_to_jax({
        name: port.state.optimizer.state[p]["momentum_buffer"]
        for name, p in port.state.model.named_parameters()})["params"]
    assert_close_tree(momenta, jax.device_get(full.state.opt_state[1].trace), 2e-5, "trace")


def test_lm_resumes_from_a_jax_checkpoint(tmp_path):
    """The JAX ``LMTrainer`` (dense attention, AdamW, clip 1.0) suspends at
    step 3 of 6; the port resumes from its directory: AdamW's moments and
    count, updates and best_ppl carry over."""
    lr = 1e-2

    def jax_trainer(d, watcher=None):
        cfg = JaxLMTrainerConfig(epochs=1, batch_size=2, lr=lr, warmup_steps=0, log_every=0,
                                 grad_clip_norm=1.0, save_dir=str(d), flush_every=0,
                                 metrics_out=str(d / "metrics.jsonl"))
        return JaxLMTrainer(jax_tiny_config(attention="dense", max_seq_len=SEQ),
                            JaxTokens(12, SEQ, VOCAB), JaxTokens(6, SEQ, VOCAB, seed=1), cfg,
                            mesh=make_mesh(jax.devices()[:1]), suspend_watcher=watcher)

    full = jax_trainer(tmp_path / "full")
    want = full.fit()
    suspend_at(3)
    with pytest.raises(SystemExit):
        jax_trainer(tmp_path / "jax", JaxSuspendWatcher(install_handlers=False)).fit()
    faults.clear_plan()
    port = lm_trainer(tmp_path / "jax", attention="dense", epochs=1, n_train=12, batch=2,
                      lr=lr)
    got = port.fit()
    assert (port.state.step, port.state.updates) == (int(full.state.step), 6)
    for k in ("loss", "ppl", "best_ppl"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    cfg = tiny_config(attention="dense", max_seq_len=SEQ)
    mine = params_to_jax(port.state.model.state_dict(), cfg)
    theirs = jax.tree.map(np.array, jax.device_get(full.state.params))
    for i in range(cfg.num_layers):
        # the key bias holds rounding noise scaled by Adam to about lr a step
        # on both sides (tests/test_torch_lm_train.py): 3 resumed steps
        k_got, k_want = (p[f"block{i}"]["attn"]["qkv"]["bias"][1] for p in (mine, theirs))
        np.testing.assert_allclose(k_got, k_want, rtol=0, atol=3 * lr)
        for p in (mine, theirs):
            p[f"block{i}"]["attn"]["qkv"]["bias"][1] = 0.0
    assert_close_tree(mine, theirs, 2e-5, "params")


def spawn_runs(tmp_path, name, runs):
    job = dict(backend="gloo", device="cpu", timeout_s=120,
               rendezvous=f"file://{tmp_path / (name + '.rendezvous')}",
               out=str(tmp_path / name),
               model=dict(stage_sizes=(1, 1), block="bottleneck", num_classes=CLASSES,
                          num_filters=8, fused=True),
               data=dict(n_train=48, n_val=8, size=SIZE, classes=CLASSES),
               config=dict(epochs=2, batch_size=4, lr=0.05, log_every=0), runs=runs)
    resume_check.run(job, 2)
    return resume_check.load(job, 2)


def test_two_ranks_agree_on_a_suspend_only_rank_1_saw(tmp_path):
    """Global batch 8 on 2 gloo ranks, 6 steps an epoch. SIGUSR1 reaches
    rank 1 alone before step 2: both ranks save at step 2 and exit 0.
    With ``suspend_sync_every=2`` a signal before step 3 waits for step 4
    (no deadlock). Each resume ends bitwise where the uninterrupted run
    ends, the state the same on both ranks."""
    d = lambda n: str(tmp_path / n)  # noqa: E731
    one = spawn_runs(tmp_path, "one", [
        dict(name="full", dir=d("full")),
        dict(name="sync1", dir=d("sync1"), signal=[1, 2])])
    two = spawn_runs(tmp_path, "two", [
        dict(name="resume1", dir=d("sync1")),
        dict(name="sync2", dir=d("sync2"), signal=[1, 3], config=dict(suspend_sync_every=2))])
    three = spawn_runs(tmp_path, "three", [dict(name="resume2", dir=d("sync2"))])
    for r in range(2):
        assert one[r]["sync1"]["suspended_at"] == (0, 3) and one[r]["sync1"]["exit"] == 0
        assert one[r]["sync1"]["step"] == 3
        assert two[r]["sync2"]["suspended_at"] == (0, 5) and two[r]["sync2"]["exit"] == 0
        assert one[r]["full"]["step"] == two[r]["resume1"]["step"] == \
            three[r]["resume2"]["step"] == 12
    want = one[0]["full"]["state"]
    for got in (two[0]["resume1"], three[0]["resume2"]):
        assert_bitwise(got["state"], want)
    for runs in (one, two, three):
        for name in runs[0]:
            assert runs[0][name]["checksums"] == runs[1][name]["checksums"], name


def test_recipes_suspend_on_the_flag_file_and_resume(tmp_path, monkeypatch):
    """``SUSPEND_FLAG_FILE`` present: the recipe saves at its first step and
    exits 0; the same command again resumes there and ends as the
    uninterrupted run does."""
    flag = tmp_path / "flag"
    for name, main, argv in (
            ("resnet", resnet_single.main, ["--device", "cpu", "--tiny", "--synthetic"]),
            ("lm", lm_pretrain.main, ["--device", "cpu", "--tiny", "--steps", "3"])):
        want = main(argv + ["--save-dir", str(tmp_path / name / "full")])
        monkeypatch.setenv("SUSPEND_FLAG_FILE", str(flag))
        flag.write_text("")
        run = argv + ["--save-dir", str(tmp_path / name / "run")]
        with pytest.raises(SystemExit) as e:
            main(run)
        assert e.value.code == 0 and (tmp_path / name / "run" / "latest.ckpt").is_dir()
        flag.unlink()
        assert main(run) == want, name
        monkeypatch.delenv("SUSPEND_FLAG_FILE")


def test_a_kill_inside_a_shard_write_is_survived(tmp_path):
    """``PDT_FAULT_PLAN`` SIGKILLs the LM recipe in its second interval
    save's shard write (the tmp file written, not yet renamed); the
    relaunch resumes from the first save and runs to the end."""
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_IP", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"  # one torch thread in the recipe's process too
    cmd = [sys.executable, "-m", "pytorch_distributed_tpu_torch.recipes.lm_pretrain",
           "--device", "cpu", "--tiny", "--epochs", "1", "--save-every-n-steps", "2",
           "--save-dir", str(tmp_path)]
    plan = '{"faults": [{"site": "ckpt.shard_write", "kind": "kill", "at": 1}]}'
    r = subprocess.run(cmd, cwd=REPO, env=dict(env, PDT_FAULT_PLAN=plan),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == -9, r.stderr[-2000:]
    torn = tmp_path / "step-00000004.ckpt"
    assert torn.is_dir() and not (torn / "manifest.json").exists()
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"resumed from {tmp_path / 'step-00000002.ckpt'}: epoch 0 step 2" in r.stdout
    assert '"best_ppl"' in r.stdout.splitlines()[-1]


@pytest.mark.parametrize("flag, value", [("--save-every-n-steps", "-1"),
                                         ("--keep-last-ckpts", "0")])
def test_the_lm_recipe_refuses_bad_checkpoint_flags(tmp_path, flag, value):
    with pytest.raises(SystemExit, match=flag):
        lm_pretrain.main(["--device", "cpu", "--tiny", "--save-dir", str(tmp_path), flag, value])
    assert not any(tmp_path.iterdir())
