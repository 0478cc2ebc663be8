"""The port's resilience plane against the JAX package's: the fault plan
(one plan drives both packages alike), bounded retry, the step guard and
its rollback through the trainers, the watchdog, and the suspend watcher
(the cases of ``tests/test_suspend.py``).

Tolerances: the rollback run's final parameters and statistics 2e-5
absolute against the JAX run's from the same weights (fp32 summation
order, as ``tests/test_torch_resnet_train.py``); its loss 1e-5 relative.
"""

import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data import SyntheticImageClassification as JaxSynthetic
from pytorch_distributed_tpu.models import resnet as jresnet
from pytorch_distributed_tpu.parallel import single_device_mesh
from pytorch_distributed_tpu.resilience import faults as jfaults
from pytorch_distributed_tpu.resilience.retry import backoff_delays as jax_backoff_delays
from pytorch_distributed_tpu.resilience.stepguard import StepGuard as JaxStepGuard
from pytorch_distributed_tpu.train import Trainer as JaxTrainer
from pytorch_distributed_tpu.train import TrainerConfig as JaxTrainerConfig
from pytorch_distributed_tpu_torch.data import SyntheticImageClassification
from pytorch_distributed_tpu_torch.models import resnet
from pytorch_distributed_tpu_torch.models.convert import (
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from pytorch_distributed_tpu_torch.resilience import faults, retry
from pytorch_distributed_tpu_torch.resilience.faults import (
    FaultPlan,
    FaultSpec,
    InjectedFault,
    poison_batch,
)
from pytorch_distributed_tpu_torch.resilience.stepguard import RollbackRequested, StepGuard
from pytorch_distributed_tpu_torch.resilience.watchdog import Watchdog, dump_all_stacks
from pytorch_distributed_tpu_torch.train import Trainer, TrainerConfig
from pytorch_distributed_tpu_torch.utils.suspend import NullSuspendWatcher, SuspendWatcher

SIZE, CLASSES = 16, 4


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test starts and ends without a fault plan in either package."""
    faults.clear_plan()
    jfaults.clear_plan()
    yield
    faults.clear_plan()
    jfaults.clear_plan()


def both_plans(*specs):
    """The same plan installed in both packages, from one JSON text."""
    text = FaultPlan([FaultSpec(**s) for s in specs]).to_json()
    return (faults.install_plan(FaultPlan.from_json(text)),
            jfaults.install_plan(jfaults.FaultPlan.from_json(text)))


# ---- the fault plan ----


def test_one_plan_file_fires_alike_in_both_packages(tmp_path, monkeypatch):
    path = tmp_path / "plan.json"
    path.write_text('{"faults": [{"site": "s", "kind": "raise", "at": 1, "times": 2}, '
                    '{"site": "train.step", "kind": "nan", "at": 2}]}')
    monkeypatch.setenv(faults.ENV_PLAN, f"@{path}")
    assert faults.ENV_PLAN == jfaults.ENV_PLAN
    ours, theirs = faults.active_plan(), jfaults.active_plan()
    for site in ["s", "s", "train.step", "s", "train.step", "train.step", "s", "other"]:
        a, b = ours.tick(site), theirs.tick(site)
        assert (a and (a.site, a.kind, a.at, a.times)) == (b and (b.site, b.kind, b.at, b.times))
    assert ours.fired == theirs.fired == [("s", 1, "raise"), ("s", 2, "raise"),
                                          ("train.step", 2, "nan")]
    assert FaultPlan.from_json(ours.to_json()).specs == ours.specs


def test_fault_point_kinds_and_spec_validation():
    faults.install_plan(FaultPlan([FaultSpec("x", "raise"), FaultSpec("y", "suspend"),
                                   FaultSpec("z", "hang", seconds=0.05)]))
    with pytest.raises(InjectedFault):
        faults.fault_point("x")
    assert faults.fault_point("x") is None  # the window is one occurrence
    assert faults.fault_point("y").kind == "suspend"
    t0 = time.monotonic()
    assert faults.fault_point("z") is None and time.monotonic() - t0 >= 0.05
    assert isinstance(InjectedFault("io"), OSError)
    with pytest.raises(ValueError):
        FaultSpec(site="s", kind="explode")
    with pytest.raises(ValueError):
        FaultSpec(site="s", kind="raise", times=0)


def test_poison_batch_nans_floats_only():
    batch = {"tokens": torch.arange(4, dtype=torch.int32), "weights": torch.ones(4),
             "image": np.ones((2, 2), np.float32), "label": np.arange(2)}
    out = poison_batch(batch)
    assert torch.isnan(out["weights"]).all() and np.isnan(out["image"]).all()
    assert torch.equal(out["tokens"], batch["tokens"]) and out["label"] is batch["label"]
    with pytest.raises(ValueError):
        poison_batch({"tokens": torch.arange(4)})


# ---- retry ----


@pytest.mark.parametrize("args", [dict(), dict(retries=4, base_delay=0.1, max_delay=0.5,
                                               seed=7)])
def test_backoff_delays_equal_the_jax_schedule(args):
    assert retry.backoff_delays(**args) == jax_backoff_delays(**args)


def test_retry_call_recovers_then_exhausts(monkeypatch):
    sleeps = []
    monkeypatch.setattr(retry.time, "sleep", sleeps.append)
    calls = []

    def flaky(n):
        calls.append(1)
        if len(calls) < n:
            raise InjectedFault("transient")
        return "ok"

    assert retry.retry_call(flaky, 3, retries=3) == "ok"
    assert sleeps == retry.backoff_delays(3)[:2]
    calls.clear()
    with pytest.raises(InjectedFault):
        retry.retry_call(flaky, 10, retries=2)
    assert len(calls) == 3
    with pytest.raises(ValueError):  # not retried
        retry.retry_call(lambda: (_ for _ in ()).throw(ValueError("hard")))

    @retry.retrying(retries=1)
    def once_flaky():
        calls.append(1)
        if len(calls) % 2:
            raise OSError("again")
        return len(calls)

    calls.clear()
    assert once_flaky() == 2


# ---- the step guard ----


@pytest.mark.parametrize("max_bad, lag, flags", [
    (3, 1, [1, 0, 0, 0, 1, 0]),
    (2, 0, [0, 1, 0, 0, 0, 0]),
    (0, 1, [0] * 6),
    (2, 2, [1, 0, 0, 1, 0, 0, 0]),
])
def test_stepguard_counts_as_the_jax_guard(max_bad, lag, flags):
    """The same flag sequence through both guards: the same streaks,
    totals and rollbacks, raised at the same observation."""
    ours, theirs = StepGuard(max_bad, lag), JaxStepGuard(max_bad, lag)
    for i, f in enumerate(flags + [None]):
        events = []
        for guard, flag, exc in ((ours, None if f is None else torch.tensor(float(f)),
                                  RollbackRequested),
                                 (theirs, None if f is None else jnp.float32(f), Exception)):
            try:
                guard.flush() if f is None else guard.observe(flag)
                events.append(None)
            except exc as e:
                events.append(type(e).__name__)
        assert events[0] == events[1], i
        assert (ours.bad_total, ours.bad_consecutive, ours.rollbacks) == \
            (theirs.bad_total, theirs.bad_consecutive, theirs.rollbacks)
    with pytest.raises(ValueError):
        StepGuard(lag=-1)


def jax_trainer(save_dir, **over):
    model = jresnet.ResNet(stage_sizes=(1, 1), block_cls=jresnet.BasicBlock,
                           num_classes=CLASSES, num_filters=8)
    cfg = JaxTrainerConfig(epochs=1, batch_size=8, lr=0.05, save_dir=str(save_dir), log_every=0,
                           num_workers=0, prefetch=1, flush_every=0,
                           metrics_out=os.path.join(str(save_dir), "metrics.jsonl"), **over)
    return JaxTrainer(model, JaxSynthetic(64, SIZE, CLASSES), JaxSynthetic(8, SIZE, CLASSES, seed=1),
                      cfg, mesh=single_device_mesh(), input_shape=(1, SIZE, SIZE, 3))


def port_trainer(save_dir, variables=None, watcher=None, **over):
    model = resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BasicBlock, num_classes=CLASSES,
                          num_filters=8)
    cfg = TrainerConfig(epochs=1, batch_size=8, lr=0.05, save_dir=str(save_dir), log_every=0,
                        **over)
    t = Trainer(model, SyntheticImageClassification(64, SIZE, CLASSES),
                SyntheticImageClassification(8, SIZE, CLASSES, seed=1), cfg, device="cpu",
                suspend_watcher=watcher)
    if variables is not None:
        t.state.model.load_state_dict(resnet_params_from_jax(variables))
    return t


def test_consecutive_nans_roll_back_as_the_jax_trainer(tmp_path):
    """The plan of ``tests/test_resilience.py::test_consecutive_nans_roll_back_to_checkpoint``
    on both trainers from the same weights: the same rollbacks and skipped
    steps, and the same final state."""
    over = dict(nan_guard=True, max_bad_steps=3, save_every_n_steps=1, keep_last_ckpts=2)
    jt = jax_trainer(tmp_path / "jax", **over)
    init = jax.device_get({"params": jt.state.params, "batch_stats": jt.state.batch_stats})
    pt = port_trainer(tmp_path / "port", init, **over)
    plan_spec = {"site": "train.step", "kind": "nan", "at": 3, "times": 6}
    ours, theirs = both_plans(plan_spec)
    want = jt.fit()
    got = pt.fit()
    assert pt.rollbacks == jt.rollbacks >= 1
    assert pt.guard.bad_total == jt.guard.bad_total >= 3
    assert ours.fired == theirs.fired
    assert pt.state.step == int(jt.state.step) == len(pt.train_loader)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    tree = resnet_params_to_jax(pt.state.model.state_dict())
    for part in ("params", "batch_stats"):
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(tree[part])[0],
                jax.tree_util.tree_flatten_with_path(jax.device_get(
                    getattr(jt.state, part)))[0]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-5,
                                       err_msg=jax.tree_util.keystr(path))


def test_rollback_without_a_checkpoint_is_fatal(tmp_path):
    faults.install_plan(FaultPlan([FaultSpec("train.step", "nan", times=10_000)]))
    t = port_trainer(tmp_path, nan_guard=True, max_bad_steps=2)
    with pytest.raises(RuntimeError, match="no restorable checkpoint"):
        t.fit()


def test_nan_steps_skip_only_without_a_limit(tmp_path):
    faults.install_plan(FaultPlan([FaultSpec("train.step", "nan", at=2)]))
    t = port_trainer(tmp_path, nan_guard=True)
    out = t.fit()
    assert t.guard.bad_total == 1 and t.rollbacks == 0 and np.isfinite(out["loss"])
    assert t.state.step == len(t.train_loader) == t.state.updates + 1


# ---- the watchdog ----


def test_watchdog_dumps_stacks_and_latches_suspend(tmp_path):
    dump = tmp_path / "stall.log"
    watcher = SuspendWatcher(install_handlers=False)
    stalls = []
    wd = Watchdog(0.2, watcher=watcher, dump_path=str(dump), on_stall=stalls.append,
                  poll_s=0.05)
    with wd:
        wd.beat()
        time.sleep(0.7)  # no beat: one stall, one dump
        assert wd.stalls == 1
        wd.beat()
    assert watcher.receive_suspend_command()
    assert stalls and "pdt-watchdog" in stalls[0]
    text = dump.read_text()
    assert "watchdog stall #1" in text and "MainThread" in text
    assert "MainThread" in dump_all_stacks()
    with pytest.raises(ValueError):
        Watchdog(0.0)


def test_hang_trips_the_watchdog_then_the_suspend_save(tmp_path):
    """A hang inside the step loop: the watchdog dumps the stacks to
    ``watchdog_stall.log`` and latches the suspend; the loop recovers,
    saves ``latest.ckpt`` and yields (the JAX
    ``test_hang_triggers_watchdog_then_suspend_checkpoint``)."""
    faults.install_plan(FaultPlan([FaultSpec("train.step", "hang", at=2, seconds=1.2)]))
    t = port_trainer(tmp_path, watcher=SuspendWatcher(install_handlers=False),
                     watchdog_timeout_s=0.3)
    try:
        with pytest.raises(SystemExit) as e:
            t.fit()
    finally:
        t.watchdog.stop()
    assert e.value.code == 0 and t.watchdog.stalls >= 1
    assert t.ckpt.has_latest()
    assert (tmp_path / "watchdog_stall.log").exists()
    resumed = port_trainer(tmp_path)
    assert resumed.try_resume() and resumed.start_step == t.state.step


# ---- the suspend watcher (the cases of tests/test_suspend.py) ----


def test_request_suspend_is_sticky():
    w = SuspendWatcher(install_handlers=False)
    assert not w.receive_suspend_command()
    w.request_suspend()
    assert w.receive_suspend_command() and w.receive_suspend_command()


def test_flag_file_polling(tmp_path):
    flag = tmp_path / "suspend.flag"
    w = SuspendWatcher(flag_file=str(flag), poll_interval=0.0, install_handlers=False)
    assert not w.receive_suspend_command()
    flag.write_text("")
    assert w.receive_suspend_command()
    flag.unlink()
    assert w.receive_suspend_command()  # sticky


def test_flag_file_from_env(tmp_path, monkeypatch):
    flag = tmp_path / "env.flag"
    monkeypatch.setenv("SUSPEND_FLAG_FILE", str(flag))
    w = SuspendWatcher(poll_interval=0.0, install_handlers=False)
    assert w.flag_file == str(flag)
    flag.write_text("")
    assert w.receive_suspend_command()


def test_signal_delivery_latches():
    w = SuspendWatcher(signals=(signal.SIGUSR1,))
    try:
        assert not w.receive_suspend_command()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert w.receive_suspend_command()
    finally:
        w.uninstall()


def test_signal_handler_chains_previous():
    calls = []

    def mine(s, f):
        calls.append(s)

    prev = signal.signal(signal.SIGUSR1, mine)
    try:
        w = SuspendWatcher(signals=(signal.SIGUSR1,))
        try:
            os.kill(os.getpid(), signal.SIGUSR1)
            assert w.receive_suspend_command()
            assert calls == [signal.SIGUSR1]
        finally:
            w.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is mine
        os.kill(os.getpid(), signal.SIGUSR1)
        assert len(calls) == 2
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_uninstall_leaves_foreign_handler():
    base = signal.getsignal(signal.SIGUSR1)
    w = SuspendWatcher(signals=(signal.SIGUSR1,))
    top = lambda s, f: None  # noqa: E731
    signal.signal(signal.SIGUSR1, top)
    try:
        w.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is top
    finally:
        signal.signal(signal.SIGUSR1, base)


def test_go_suspend_exits():
    with pytest.raises(SystemExit) as e:
        SuspendWatcher(install_handlers=False).go_suspend(3)
    assert e.value.code == 3


def test_null_watcher_never_fires():
    w = NullSuspendWatcher()
    w.request_suspend()
    assert not w.receive_suspend_command()
