"""The port's ``LMTrainer`` over two data replicas against the JAX
package's: which rows each replica trains on and what validation counts.

Two gloo ranks (dp 2 x sp 1, ``tools/ring_check.py``'s trainer task)
against JAX ``LMTrainer`` over a 2-device mesh of the virtual CPU devices,
the tiny dense-attention config in fp32, from the JAX trainer's weights.
11 training sequences at 2 a replica are two node batches of 4 in JAX
(the last 3 dropped); 7 validation sequences are a node batch of 4 and one
of 3 padded with a zero-weight row, so validation counts 7 sequences'
tokens. Tolerances: 1e-5 relative on losses and grad norms (fp32
summation order), the token counts exact.

Also on one device: a step that ``nan_guard`` skips right before the
warmup's lr rises, against JAX ``make_lm_train_step``: the next step's lr
comes from the applied updates (optax's count), not the steps taken.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pytorch_distributed_tpu.data.tokens import SyntheticTokens as JaxTokens
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.ops.optim import build_optimizer as jax_build_optimizer
from pytorch_distributed_tpu.ops.schedules import warmup_cosine as jax_warmup_cosine
from pytorch_distributed_tpu.parallel import make_mesh
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from pytorch_distributed_tpu.train.lm_trainer import LMTrainerConfig as JaxLMTrainerConfig
from pytorch_distributed_tpu_torch.models import params_from_jax, params_to_jax, tiny_config
from pytorch_distributed_tpu_torch.ops.schedules import warmup_cosine
from pytorch_distributed_tpu_torch.tools import ring_check
from pytorch_distributed_tpu_torch.train import create_lm_state, lm_collate, make_lm_train_step

SEQ, BATCH, N_TRAIN, N_VAL = 16, 2, 11, 7
MODEL = dict(vocab_size=128, num_layers=2, num_heads=2, embed_dim=32, max_seq_len=SEQ,
             dtype="float32", attention="dense")


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("jax_lm"))
    cfg = JaxLMTrainerConfig(batch_size=BATCH, lr=3e-4, warmup_steps=0, log_every=1,
                             grad_clip_norm=1.0, save_dir=tmp, flush_every=0,
                             metrics_out=os.path.join(tmp, "metrics.jsonl"))
    trainer = JaxLMTrainer(jax_tiny_config(attention="dense", max_seq_len=SEQ),
                           JaxTokens(N_TRAIN, SEQ, 128), JaxTokens(N_VAL, SEQ, 128, seed=1),
                           cfg, mesh=make_mesh(jax.devices()[:2]))
    params = jax.tree.map(np.asarray, jax.device_get(trainer.state.params))
    trainer.train_sampler.set_epoch(0)
    trainer.train_epoch(0)
    val = trainer.validate()
    with open(cfg.metrics_out) as f:
        train = [r for r in map(json.loads, f) if r.get("kind") == "train"]
    return params, train, val


@pytest.fixture(scope="module")
def port_trainer(jax_trainer, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port_lm")
    job = dict(task="trainer", backend="gloo", rendezvous=f"file://{tmp}/rendezvous",
               out=str(tmp / "out"), dp=2, sp=1, device="cpu", timeout_s=120,
               models={"dense": MODEL}, batch=BATCH, seq=SEQ, n_train=N_TRAIN, n_val=N_VAL,
               params=params_from_jax(jax_trainer[0]))
    ring_check.run(job, 2)
    return [r["dense"] for r in ring_check.load(job)]


def test_lm_trainer_trains_on_the_jax_rows(jax_trainer, port_trainer):
    """Two steps, each on the node batch's 4 sequences (rows 0-1 to
    replica 0, 2-3 to replica 1), with JAX's losses and grad norms."""
    _, want, _ = jax_trainer
    assert len(want) == 2
    for r in port_trainer:
        assert [h["step"] for h in r["history"]] == [w["step"] for w in want]
        for got, w in zip(r["history"], want):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[k], w[k], rtol=1e-5, err_msg=k)
            assert got["tokens"] == w["tokens"]


def test_lm_validation_counts_each_sequence_once(jax_trainer, port_trainer):
    """The partial last node batch's padding row and any sampler
    duplicate weigh nothing: 7 sequences of 15 predicted tokens."""
    _, _, want = jax_trainer
    assert want["tokens"] == N_VAL * (SEQ - 1)
    for r in port_trainer:
        assert r["val"]["tokens"] == want["tokens"]
        np.testing.assert_allclose(r["val"]["loss"], want["loss"], rtol=1e-5)


def test_lm_guarded_step_before_an_lr_change_matches_jax():
    """warmup_cosine with 2 warmup steps: lr 0, 5e-3, 1e-2 at counts 0, 1,
    2. Step 1's weights hold a NaN, so both guards skip it; step 2 runs at
    count 1's lr on both sides (the step counter would give count 2's)."""
    sched = (1e-2, 6, 2, 1e-3)
    jcfg = jax_tiny_config(attention="dense", max_seq_len=SEQ)
    tx = jax_build_optimizer("adamw", jax_warmup_cosine(*sched), weight_decay=0.1)
    jstate = jax_lm.create_lm_state(jcfg, tx, jax.random.key(0), init_len=SEQ)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seq"))
    jstep = jax_lm.make_lm_train_step(mesh, config=jcfg, grad_clip_norm=1.0, nan_guard=True)
    tcfg = tiny_config(attention="dense", max_seq_len=SEQ)
    state = create_lm_state(tcfg, lr_schedule=warmup_cosine(*sched), weight_decay=0.1,
                            params=params_from_jax(jax.tree.map(np.asarray, jstate.params)),
                            device="cpu")
    step = make_lm_train_step(grad_clip_norm=1.0, nan_guard=True)
    rng = np.random.default_rng(8)
    for i in range(3):
        batch = lm_collate(list(rng.integers(1, 128, (2, SEQ)).astype(np.int32)))
        if i == 1:
            batch["weights"][0, 0] = np.nan
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert m["step_good"].item() == float(jm["step_good"]) == float(i != 1)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 3 and state.updates == 2
    got = params_to_jax(state.model.state_dict(), tcfg)
    want = jax.tree.map(np.array, jstate.params)  # writable copies
    for i in range(tcfg.num_layers):  # the key bias: rounding noise Adam scales to ~lr
        k_got, k_want = (p[f"block{i}"]["attn"]["qkv"]["bias"][1] for p in (got, want))
        np.testing.assert_allclose(k_got, k_want, rtol=0, atol=3 * sched[0])
        for p in (got, want):
            p[f"block{i}"]["attn"]["qkv"]["bias"][1] = 0.0
    fa, ta = jax.tree_util.tree_flatten(got)
    fb, tb = jax.tree_util.tree_flatten(want)
    assert ta == tb
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=2e-5)
