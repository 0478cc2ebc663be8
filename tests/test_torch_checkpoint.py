"""The port's sharded checkpoints against the JAX package's format.

The JAX ``validate_checkpoint`` and ``ManifestReader`` read what the port
wrote, leaf for leaf and bit for bit (bf16 among the dtypes); on the same
damaged directories both packages find a problem and rank the
restorable candidates alike; the commit point's fault sites leave the
old or the new checkpoint whole; a non-blocking save keeps the bytes of
its step while the next step updates the state in place; retention.
Every comparison here is exact.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.utils import checkpoint as jckpt
from pytorch_distributed_tpu_torch.data import SyntheticImageClassification
from pytorch_distributed_tpu_torch.models import resnet
from pytorch_distributed_tpu_torch.resilience import faults, retry
from pytorch_distributed_tpu_torch.resilience.faults import FaultPlan, FaultSpec, InjectedFault
from pytorch_distributed_tpu_torch.train import Trainer, TrainerConfig
from pytorch_distributed_tpu_torch.train.state import restore_state, state_payload
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
from pytorch_distributed_tpu_torch.utils.checkpoint import MANIFEST, Checkpointer, ManifestReader


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear_plan()
    yield
    faults.clear_plan()


def payload(step: int) -> dict:
    g = torch.Generator().manual_seed(step)
    return {
        "state/step": step, "state/w": torch.randn(4, 5, generator=g),
        "state/half": torch.randn(3, 2, generator=g).to(torch.bfloat16),
        "state/f16": torch.randn(7, generator=g).half(),
        "state/mask": torch.tensor([True, False, True]),
        "state/codes": torch.arange(-4, 4, dtype=torch.int8),
        "state/count": torch.tensor(3.0), "state/ids": torch.arange(6).reshape(2, 3),
        "state/np": np.arange(5, dtype=np.float64).reshape(5, 1),
        "epoch": 1, "step": step + 1, "best_acc": 12.5,
    }


def as_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def shard_of(d: str) -> str:
    return os.path.join(d, next(n for n in os.listdir(d) if n.endswith(".npz")))


def truncate(path: str) -> None:
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])


def tiny_trainer(save_dir, **over) -> Trainer:
    model = resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BottleneckBlock, num_classes=4,
                          num_filters=8, fused_bottleneck=True)
    cfg = TrainerConfig(epochs=1, batch_size=8, lr=0.05, save_dir=str(save_dir), log_every=0,
                        **over)
    return Trainer(model, SyntheticImageClassification(32, 16, 4),
                   SyntheticImageClassification(8, 16, 4, seed=1), cfg, device="cpu")


@pytest.mark.parametrize("block", [True, False])
def test_the_jax_reader_reads_every_leaf_bitwise(tmp_path, block):
    ck = Checkpointer(str(tmp_path), device="cpu")
    want = payload(7)
    ck.save_latest(want, block=block)
    ck.wait()
    d = ck.latest_path
    assert jckpt.validate_checkpoint(d) == [] == ckpt.validate_checkpoint(d)
    reader, ours = jckpt.ManifestReader(d), ManifestReader(d)
    assert sorted(reader.leaf_paths()) == sorted(want) == sorted(ours.leaf_paths())
    for path, x in want.items():
        meta = reader.leaf_meta(path)
        got = reader.read_region(path, [0] * len(meta["shape"]), meta["shape"])
        ref = x if isinstance(x, (torch.Tensor, np.ndarray)) else np.asarray(x)
        assert list(got.shape) == list(ref.shape), path
        assert as_bytes(got) == as_bytes(ref), path
        assert meta["dtype"] == str(got.dtype)
        assert as_bytes(ours.read(path)) == as_bytes(ref), path
    assert str(reader.leaf_meta("state/half")["dtype"]) == "bfloat16"
    assert int(jckpt.peek_leaf(d, "state/step")) == 7


def test_the_jax_reader_reads_a_trainer_checkpoint(tmp_path):
    """The trainer's interval save at its last step: the JAX reader sees
    the port's state, momenta and data cursor."""
    t = tiny_trainer(tmp_path, save_every_n_steps=2)
    t.fit()
    d = t.ckpt.step_checkpoints()[-1][1]
    live = state_payload(t.state)
    reader = jckpt.ManifestReader(d)
    for path, x in live.items():
        meta = reader.leaf_meta(path)
        got = reader.read_region(path, [0] * len(meta["shape"]), meta["shape"])
        assert as_bytes(got) == as_bytes(torch.as_tensor(x)), path
    assert int(reader.read_region("step", [], [])) == len(t.train_loader)
    assert {"epoch", "step", "best_acc", "state/updates"} <= set(reader.leaf_paths())
    assert any(p.endswith("/momentum_buffer") for p in reader.leaf_paths())


def damage(kind: str, old: str, new: str) -> None:
    if kind == "truncated":
        truncate(shard_of(new))
    elif kind == "token":  # save 1's shard under save 2's file name
        shutil.copyfile(shard_of(old), shard_of(new))
    elif kind == "manifest":
        os.remove(os.path.join(new, MANIFEST))
    elif kind == "block":  # a block the manifest names but no file holds
        import json

        with open(os.path.join(new, MANIFEST)) as f:
            m = json.load(f)
        m["leaves"]["state/w"]["blocks"][0]["key"] = "state/w#9"
        with open(os.path.join(new, MANIFEST), "w") as f:
            json.dump(m, f)
    elif kind == "missing":
        os.remove(shard_of(new))


@pytest.mark.parametrize("kind", ["truncated", "token", "manifest", "block", "missing"])
def test_damage_is_found_by_both_packages_and_ranked_alike(tmp_path, kind):
    d = str(tmp_path)
    ck = Checkpointer(d, device="cpu")
    for s in (1, 2):
        ck.save_step(payload(s), s, keep_last=4, block=True)
    ck.save_latest(payload(3))
    old, new = ck.step_path(1), ck.step_path(2)
    jck = jckpt.Checkpointer(d)
    assert ck.restorable_paths() == jck.restorable_paths() == [ck.latest_path, new, old]
    damage(kind, old, ck.latest_path)
    damage(kind, old, new)
    for p in (new, ck.latest_path):
        ours, theirs = ckpt.validate_checkpoint(p), jckpt.validate_checkpoint(p)
        assert ours and theirs and len(ours) == len(theirs), (ours, theirs)
    assert ck.restorable_paths() == jck.restorable_paths() == [old]
    assert ck.newest_restorable() == old


def test_a_pre_commit_fault_keeps_the_old_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path), device="cpu")
    ck.save_latest(payload(1))
    faults.install_plan(FaultPlan([FaultSpec("ckpt.pre_commit", "raise")]))
    with pytest.raises(InjectedFault):
        ck.save_latest(payload(2))
    assert ckpt.validate_checkpoint(ck.latest_path) == []
    got = ManifestReader(ck.newest_restorable())
    assert int(got.read("state/step")) == 1
    assert torch.equal(got.read("state/w"), payload(1)["state/w"])
    # the next save commits and removes the torn save's file
    ck.save_latest(payload(3))
    assert int(ManifestReader(ck.latest_path).read("state/step")) == 3
    assert len([n for n in os.listdir(ck.latest_path) if n.endswith(".npz")]) == 1


def test_a_post_commit_fault_keeps_the_new_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path), device="cpu")
    ck.save_latest(payload(1))
    faults.install_plan(FaultPlan([FaultSpec("ckpt.post_commit", "raise")]))
    with pytest.raises(InjectedFault):
        ck.save_latest(payload(2))
    # the old shard file is still there (no clean-up ran), unreferenced
    assert len([n for n in os.listdir(ck.latest_path) if n.endswith(".npz")]) == 2
    assert ckpt.validate_checkpoint(ck.latest_path) == []
    assert torch.equal(ManifestReader(ck.newest_restorable()).read("state/w"),
                       payload(2)["state/w"])


def test_a_shard_write_fault_is_retried_then_fails_before_the_commit(tmp_path, monkeypatch):
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    ck = Checkpointer(str(tmp_path), device="cpu")
    ck.save_latest(payload(1))
    faults.install_plan(FaultPlan([FaultSpec("ckpt.shard_write", "raise", times=2)]))
    ck.save_latest(payload(2))  # two transient failures, then the third try lands
    assert int(ManifestReader(ck.latest_path).read("state/step")) == 2
    faults.install_plan(FaultPlan([FaultSpec("ckpt.shard_write", "raise", times=10)]))
    ck.save_latest(payload(3), block=False)
    with pytest.raises(InjectedFault):
        ck.wait()
    assert int(ManifestReader(ck.newest_restorable()).read("state/step")) == 2


def test_a_trainer_resumes_from_the_old_checkpoint_after_a_torn_save(tmp_path):
    """``ckpt.pre_commit`` during the second interval save: the run fails
    there, and a fresh trainer resumes from the first save's step."""
    faults.install_plan(FaultPlan([FaultSpec("ckpt.pre_commit", "raise", at=1)]))
    t = tiny_trainer(tmp_path, save_every_n_steps=1)
    with pytest.raises(InjectedFault):
        t.fit()
    fresh = tiny_trainer(tmp_path)
    assert fresh.try_resume() and fresh.state.step == 1 and fresh.start_step == 1


def test_a_non_blocking_save_keeps_its_steps_bytes(tmp_path):
    """The step after a non-blocking save updates parameters, statistics
    and momenta in place before the write has run: the checkpoint still
    holds the state at the save."""
    t = tiny_trainer(tmp_path)
    batches = t.train_loader.iter_batches(0)
    t.state, _ = t.train_step(t.state, next(batches))
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in state_payload(t.state).items()}
    t.ckpt.save_step(t._payload_live(0, 1), t.state.step, block=False)
    t.state, _ = t.train_step(t.state, next(batches))
    after = state_payload(t.state)
    assert any(not torch.equal(before[k], after[k]) for k in before
               if k.endswith("momentum_buffer"))
    t.ckpt.wait()
    reader = ManifestReader(t.ckpt.step_path(1))
    for k, v in before.items():
        assert as_bytes(reader.read(k)) == as_bytes(torch.as_tensor(v)), k
    # and the restore puts those bytes back in place
    restore_state(t.state, {k: reader.read(k) for k in reader.leaf_paths()})
    for k, v in state_payload(t.state).items():
        assert as_bytes(v if isinstance(v, torch.Tensor) else torch.as_tensor(v)) == \
            as_bytes(torch.as_tensor(before[k])), k


def test_retention_keeps_the_newest_and_never_an_uncommitted_save(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, device="cpu")
    for s in (1, 2, 3):
        ck.save_step(payload(s), s, keep_last=2, block=True)
    assert sorted(n for n in os.listdir(d) if n.startswith("step-")) == [
        "step-00000002.ckpt", "step-00000003.ckpt"]
    ck.save_step(payload(4), 4, keep_last=1, block=False)
    assert os.path.exists(ck.step_path(2)) and os.path.exists(ck.step_path(3))
    ck.wait()
    assert [p for _s, p in ck.step_checkpoints()] == [ck.step_path(4)]
    assert jckpt.Checkpointer(d).step_checkpoints() == ck.step_checkpoints()
    with pytest.raises(ValueError):
        ck.save_step(payload(5), 5, keep_last=0)


@pytest.mark.parametrize("change, error", [("drop", KeyError), ("reshape", ValueError)])
def test_restore_refuses_a_checkpoint_of_another_model(tmp_path, change, error):
    """A leaf missing, or of another shape: refused before anything of the
    state changes."""
    t = tiny_trainer(tmp_path)
    leaves = dict(state_payload(t.state))
    key = "state/model/conv_init/weight"
    if change == "drop":
        del leaves[key]
    else:
        leaves[key] = leaves[key].reshape(-1)
    ck = Checkpointer(str(tmp_path), device="cpu")
    ck.save_latest(leaves)
    before = {k: v.clone() for k, v in t.state.model.state_dict().items()}
    reader = ManifestReader(ck.latest_path)
    with pytest.raises(error):
        restore_state(t.state, {k: reader.read(k) for k in reader.leaf_paths()})
    assert all(torch.equal(v, before[k]) for k, v in t.state.model.state_dict().items())


def test_the_checkpointer_runs_on_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Checkpointer(str(tmp_path))
    assert Checkpointer(str(tmp_path), device="cpu").device.type == "cpu"


def test_the_port_reads_a_jax_directory_with_sharded_leaves(tmp_path, devices8):
    """A JAX save of leaves sharded over a 4 x 2 mesh (one block a shard,
    bf16 among them) and replicated ones: the port's reader assembles
    each leaf whole, bit for bit, and validates the directory."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from pytorch_distributed_tpu.parallel import make_mesh

    mesh = make_mesh(devices8, data_parallel=4, model_parallel=2)
    rng = np.random.default_rng(0)
    want = {"state": {
        "w": jax.device_put(jnp.asarray(rng.normal(size=(8, 16)), jnp.float32),
                            NamedSharding(mesh, P("data", "model"))),
        "h": jax.device_put(jnp.asarray(rng.normal(size=(4, 6)), jnp.bfloat16),
                            NamedSharding(mesh, P(None, "model"))),
        "step": jax.device_put(jnp.asarray(7, jnp.int32), NamedSharding(mesh, P()))},
        "epoch": 3}
    d = str(tmp_path / "jax.ckpt")
    jckpt.save_sharded(d, want)
    assert ckpt.validate_checkpoint(d) == []
    reader = ManifestReader(d)
    assert len(reader.leaf_meta("state/w")["blocks"]) == 8
    for path, x in (("state/w", want["state"]["w"]), ("state/h", want["state"]["h"]),
                    ("state/step", want["state"]["step"]), ("epoch", 3)):
        got = reader.read(path)
        assert list(got.shape) == list(np.shape(x)), path
        assert as_bytes(got) == np.asarray(x).tobytes(), path
    assert reader.read("state/h").dtype == torch.bfloat16
