"""The port's LM training path against the JAX package's.

Same weights (the flax tree carried across by ``params_from_jax``), same
numpy inputs, fp32 unless a test says otherwise: the training forward, the
loss tails, AdamW with clipping and its schedule, the data path, and three
steps of the whole train step against ``make_lm_train_step`` on a
one-device mesh. JAX flash attention runs in the Pallas interpreter, the
port's on its plain version.

Tolerances are fp32 summation-order ones unless stated: 1e-5 relative on
losses, 1e-5 absolute on parameters and activations of order 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from pytorch_distributed_tpu.data import DataLoader as JaxLoader
from pytorch_distributed_tpu.data import DistributedSampler as JaxSampler
from pytorch_distributed_tpu.data import SyntheticTokens as JaxSynthetic
from pytorch_distributed_tpu.data import TokenArrayDataset as JaxTokenArray
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.ops.fused_ce import fused_linear_cross_entropy as jax_fused_ce
from pytorch_distributed_tpu.ops.losses import cross_entropy_loss as jax_ce
from pytorch_distributed_tpu.ops.optim import build_optimizer as jax_build_optimizer
from pytorch_distributed_tpu.ops.optim import clip_grads_by_global_norm as jax_clip
from pytorch_distributed_tpu.ops.schedules import warmup_cosine as jax_warmup_cosine
from pytorch_distributed_tpu.resilience.stepguard import finite_ok as jax_finite_ok
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu.train.lm_trainer import lm_collate as jax_lm_collate
from pytorch_distributed_tpu_torch.data import (
    DataLoader,
    DistributedSampler,
    SyntheticTokens,
    TokenArrayDataset,
)
from pytorch_distributed_tpu_torch.models import (
    TransformerLM,
    params_from_jax,
    params_to_jax,
    tiny_config,
)
from pytorch_distributed_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_tpu_torch.ops.optim import adamw, clip_grads_by_global_norm
from pytorch_distributed_tpu_torch.ops.schedules import warmup_cosine
from pytorch_distributed_tpu_torch.recipes import lm_pretrain
from pytorch_distributed_tpu_torch.resilience import finite_ok
from pytorch_distributed_tpu_torch.train import (
    LMTrainer,
    LMTrainerConfig,
    create_lm_state,
    lm_collate,
    make_lm_eval_step,
    make_lm_train_step,
    shift_labels,
)

SEQ = 32


def jax_params(jcfg, seed=0):
    params = JaxLM(jcfg).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return params, jax.tree.map(np.asarray, params)


def tokens(b=2, l=SEQ, vocab=128, seed=0):
    return np.random.default_rng(seed).integers(1, vocab, (b, l)).astype(np.int32)


def assert_trees_close(a, b, **tol):
    fa, ta = jax.tree_util.tree_flatten(a)
    fb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_training_forward_matches_flax(attention):
    """Logits and ``return_hidden`` of the port's training forward against
    ``TransformerLM.apply``, fp32, at offset 0 and at a position offset."""
    jcfg = jax_tiny_config(attention=attention, max_seq_len=64)
    params, np_params = jax_params(jcfg)
    model = TransformerLM(tiny_config(attention=attention, max_seq_len=64))
    model.load_state_dict(params_from_jax(np_params))
    toks = tokens()
    for offset in (0, 16):
        want = JaxLM(jcfg).apply({"params": params}, jnp.asarray(toks),
                                 position_offset=offset)
        want_h = JaxLM(jcfg).apply({"params": params}, jnp.asarray(toks),
                                   position_offset=offset, return_hidden=True)
        with torch.no_grad():
            got = model(torch.from_numpy(toks), position_offset=offset)
            got_h = model(torch.from_numpy(toks), position_offset=offset,
                          return_hidden=True)
        assert got.dtype == torch.float32 and got_h.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-4, atol=1e-5)


def test_bf16_compute_on_fp32_parameters_follows_flax():
    """flax trains fp32 parameters with bf16 compute: the port with
    ``param_dtype=fp32, dtype=bf16`` keeps fp32 parameters and agrees
    with flax's bf16 forward to bf16 rounding (logits of order 1: 0.1,
    a few bf16 ulps after 2 layers, where the two frameworks round in
    other places)."""
    jcfg = jax_tiny_config(attention="dense", max_seq_len=64, dtype=jnp.bfloat16)
    params, np_params = jax_params(jcfg)
    cfg = tiny_config(max_seq_len=64, dtype=torch.bfloat16, param_dtype=torch.float32)
    model = TransformerLM(cfg)
    model.load_state_dict(params_from_jax(np_params))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    toks = tokens()
    want = JaxLM(jcfg).apply({"params": params}, jnp.asarray(toks))
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0.1)


def test_params_to_jax_inverts_params_from_jax():
    jcfg = jax_tiny_config(max_seq_len=64)
    _, np_params = jax_params(jcfg, seed=3)
    back = params_to_jax(params_from_jax(np_params), tiny_config(max_seq_len=64))
    assert_trees_close(back, np_params, rtol=0, atol=0)


def test_training_config_refuses_unported_branches():
    """Only expert parallelism is left (and MoE under TP); tensor
    parallelism needs its mesh axis, as in JAX."""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tiny_config(ep_size=2)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tiny_config(n_experts=4, ep_size=2)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tiny_config(n_experts=4, tp_size=2, model_axis="model")
    with pytest.raises(ValueError, match="requires model_axis"):
        tiny_config(tp_size=2)
    assert tiny_config(tp_size=2, model_axis="model").tp_size == 2


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_fused_ce_matches_jax(compute):
    """Value and grads of the chunked CE (N = 40 rows, block 16 with a
    ragged last block, zero weights included) against the JAX scan. fp32
    to 1e-5; bf16 operands with fp32 accumulation on both sides, so the
    same products: 1e-4 relative, summation order only."""
    rng = np.random.default_rng(0)
    n, e, v = 40, 32, 128
    x = rng.standard_normal((n, e), np.float32)
    w = rng.standard_normal((e, v), np.float32) * 0.2
    labels = rng.integers(0, v, n).astype(np.int32)
    weights = (rng.random(n) > 0.2).astype(np.float32)
    cdt = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}[compute]
    val, (dx, dw) = jax.value_and_grad(
        lambda a, b: jax_fused_ce(a, b, jnp.asarray(labels), jnp.asarray(weights),
                                  block_n=16, compute_dtype=cdt[0]),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w.T.copy(), requires_grad=True)  # nn.Linear layout [V, E]
    got = fused_linear_cross_entropy(tx, tw, torch.from_numpy(labels),
                                     torch.from_numpy(weights), block_n=16,
                                     compute_dtype=cdt[1])
    got.backward()
    tol = dict(rtol=1e-5, atol=1e-5) if compute == "float32" else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.item(), float(val), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(dx), **tol)
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(dw), **tol)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((12, 10), np.float32) * 3
    labels = rng.integers(0, 10, 12)
    for reduction in ("mean", "sum", "none"):
        want = jax_ce(jnp.asarray(logits), jnp.asarray(labels), smoothing, reduction)
        got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                 smoothing, reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_warmup_cosine_matches_jax_step_by_step():
    """The values the JAX schedule gives at each count (fp32 there, so
    1e-6 relative)."""
    for args in [(3e-4, 20, 5, 3e-5), (1e-2, 10, 0, 0.0), (1.0, 4, 8, 0.1)]:
        want, got = jax_warmup_cosine(*args), warmup_cosine(*args)
        for step in range(25):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    assert warmup_cosine(3e-4, 20, 5)(0) == 0.0  # optax's first update runs at count 0


def test_adamw_with_clipping_matches_optax():
    """Three updates of ``torch.optim.AdamW`` (lr set from the schedule at
    the pre-update count, global-norm clip to 0.5) against the JAX step's
    ``clip_grads_by_global_norm`` + ``optax.adamw``: parameters to 1e-6,
    pre-clip norms to 1e-6 relative."""
    rng = np.random.default_rng(2)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    p0 = [rng.standard_normal(s, np.float32) for s in shapes]
    grads = [[rng.standard_normal(s, np.float32) for s in shapes] for _ in range(3)]
    sched_args = (1e-2, 10, 2, 1e-3)
    tx = jax_build_optimizer("adamw", jax_warmup_cosine(*sched_args), weight_decay=0.1)
    jp = [jnp.asarray(p) for p in p0]
    opt_state = tx.init(jp)
    params = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    opt = adamw(params, weight_decay=0.1)
    schedule = warmup_cosine(*sched_args)
    for step, g in enumerate(grads):
        gc, jnorm = jax_clip([jnp.asarray(x) for x in g], 0.5)
        updates, opt_state = tx.update(gc, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(params, g):
            p.grad = torch.tensor(x)
        norm = clip_grads_by_global_norm([p.grad for p in params], 0.5)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
        np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
        for p, w in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


def test_nan_guard_skips_the_update_and_advances_the_step():
    cfg = tiny_config(max_seq_len=SEQ)
    state = create_lm_state(cfg, lr_schedule=lambda s: 1e-2, device="cpu")
    step = make_lm_train_step(grad_clip_norm=1.0, nan_guard=True)
    batch = {k: torch.from_numpy(v) for k, v in lm_collate(list(tokens())).items()}
    state, m = step(state, batch)
    assert m["step_good"].item() == 1.0 and state.step == 1
    with torch.no_grad():
        state.model.blocks[0].mlp_up.bias[0] = float("nan")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in s.items()}
               for p, s in state.optimizer.state.items()}
    state, m = step(state, batch)
    assert m["step_good"].item() == 0.0 and state.step == 2
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0, equal_nan=True)
    for p, s in state.optimizer.state.items():
        for k, v in s.items():
            torch.testing.assert_close(v, moments[id(p)][k], rtol=0, atol=0)
    # the verdict agrees with the JAX guard on the same values
    loss, grads = np.float32(1.0), [np.array([1.0, np.inf], np.float32)]
    assert bool(finite_ok(torch.tensor(loss), [torch.tensor(grads[0])])) == bool(
        jax_finite_ok(jnp.asarray(loss), [jnp.asarray(grads[0])]))


def test_data_path_matches_jax():
    """Synthetic and windowed tokens, next-token labels, collation, the
    sampler's index sequences and the loader's batch order."""
    for i in range(5):
        np.testing.assert_array_equal(SyntheticTokens(10, 16, 100, seed=3)[i],
                                      JaxSynthetic(10, 16, 100, seed=3)[i])
    flat = np.arange(103, dtype=np.int32)
    ours, theirs = TokenArrayDataset(flat, 10), JaxTokenArray(flat, 10)
    assert len(ours) == len(theirs) == 10
    np.testing.assert_array_equal(ours[9], theirs[9])
    toks = tokens(b=3, l=8)
    for a, b in zip(shift_labels(toks), jax_lm.shift_labels(toks)):
        np.testing.assert_array_equal(a, b)
    samples = [toks[0], toks[1]]
    ours, theirs = lm_collate(samples), jax_lm_collate(samples)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
        assert ours[k].dtype == theirs[k].dtype
    for size, n_rep, shuffle, drop_last in [(10, 1, True, False), (10, 3, True, False),
                                            (11, 4, False, False), (11, 4, True, True)]:
        for rank in range(n_rep):
            s = DistributedSampler(size, n_rep, rank, shuffle=shuffle, seed=7,
                                   drop_last=drop_last)
            j = JaxSampler(size, n_rep, rank, shuffle=shuffle, seed=7, drop_last=drop_last)
            for epoch in (0, 2):
                s.set_epoch(epoch)
                j.set_epoch(epoch)
                assert list(s) == list(j) and len(s) == len(j)
                assert list(s.iter_from(2)) == list(j.iter_from(2))
    data = SyntheticTokens(11, 8, 50, seed=2)
    for drop_last in (True, False):
        s, j = DistributedSampler(11, shuffle=True, seed=1), JaxSampler(11, shuffle=True, seed=1)
        ours = DataLoader(data, 4, lm_collate, sampler=s, drop_last=drop_last)
        theirs = JaxLoader(data, 4, sampler=j, drop_last=drop_last, prefetch=1,
                           collate_fn=jax_lm_collate)
        assert len(ours) == len(theirs)
        for start in (0, 1):
            got, want = list(ours.iter_batches(start)), list(theirs.iter_batches(start))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                for k in b:
                    np.testing.assert_array_equal(a[k].numpy(), b[k])


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_three_train_steps_match_make_lm_train_step(attention):
    """The slice as a whole: the port's train step (fused CE, clip 1.0,
    warmup-cosine AdamW with decay 0.1) against ``make_lm_train_step`` on
    a one-device mesh, from the same weights on the same batches, fp32:
    losses and grad norms to 1e-5 relative each step, parameters (through
    ``params_to_jax``) to 2e-5 after three."""
    jcfg = jax_tiny_config(attention=attention, max_seq_len=SEQ)
    sched = (1e-2, 6, 1, 1e-3)
    tx = jax_build_optimizer("adamw", jax_warmup_cosine(*sched), weight_decay=0.1)
    jstate = jax_lm.create_lm_state(jcfg, tx, jax.random.key(0), init_len=SEQ)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seq"))
    jstep = jax_lm.make_lm_train_step(mesh, config=jcfg, grad_clip_norm=1.0)
    np_params = jax.tree.map(np.asarray, jstate.params)
    tcfg = tiny_config(attention=attention, max_seq_len=SEQ)
    state = create_lm_state(tcfg, lr_schedule=warmup_cosine(*sched), weight_decay=0.1,
                            params=params_from_jax(np_params), device="cpu")
    step = make_lm_train_step(grad_clip_norm=1.0)
    for i in range(3):
        batch = lm_collate(list(tokens(b=2, seed=10 + i)))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        assert m["tokens"].item() == float(jm["tokens"])
    assert state.step == int(jstate.step) == 3
    got = params_to_jax(state.model.state_dict(), tcfg)
    want = jax.tree.map(np.array, jstate.params)  # writable copies
    for i in range(tcfg.num_layers):
        # The key bias's gradient is zero in exact arithmetic (softmax
        # ignores a constant added to a row's logits), so both sides hold
        # rounding noise there, which Adam scales to steps of about lr:
        # compared to 3 lr, the rest to 2e-5.
        k_got, k_want = (p[f"block{i}"]["attn"]["qkv"]["bias"][1] for p in (got, want))
        np.testing.assert_allclose(k_got, k_want, rtol=0, atol=3 * sched[0])
        for p in (got, want):
            p[f"block{i}"]["attn"]["qkv"]["bias"][1] = 0.0
    assert_trees_close(got, want, rtol=1e-4, atol=2e-5)


def test_eval_step_accumulates_the_weighted_loss():
    cfg = tiny_config(max_seq_len=SEQ)
    state = create_lm_state(cfg, lr_schedule=lambda s: 0.0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in lm_collate(list(tokens())).items()}
    acc = make_lm_eval_step()(state, batch, {"loss_sum": torch.zeros(()),
                                             "tokens": torch.zeros(())})
    plain = make_lm_eval_step(fused_ce=False)(state, batch, {"loss_sum": torch.zeros(()),
                                                             "tokens": torch.zeros(())})
    assert acc["tokens"].item() == 2 * (SEQ - 1)
    np.testing.assert_allclose(acc["loss_sum"].item(), plain["loss_sum"].item(), rtol=1e-5)


def test_trainer_fits_on_the_cpu(tmp_path):
    cfg = LMTrainerConfig(epochs=2, batch_size=4, lr=3e-3, log_every=1, grad_clip_norm=1.0,
                          nan_guard=True, save_dir=str(tmp_path))
    trainer = LMTrainer(tiny_config(attention="flash", max_seq_len=16),
                        SyntheticTokens(16, 16, 128), SyntheticTokens(6, 16, 128, seed=1),
                        cfg, device="cpu")
    summary = trainer.fit()
    assert len(trainer.history) == 8 and trainer.state.step == 8
    assert all(np.isfinite(r["loss"]) and r["step_good"] == 1.0 for r in trainer.history)
    assert summary["tokens"] == 6 * 15 and np.isfinite(summary["loss"])
    assert summary["best_ppl"] <= summary["ppl"]
    assert trainer.history[-1]["loss"] < trainer.history[0]["loss"]


def test_recipe_trains_tiny_on_the_cpu(tmp_path):
    summary = lm_pretrain.main(["--device", "cpu", "--tiny", "--steps", "3", "--epochs", "1",
                                "--log-every", "1", "--save-dir", str(tmp_path)])
    assert np.isfinite(summary["loss"]) and summary["tokens"] == 8 * 31
    # tensor parallelism runs (tests/test_torch_vocab_parallel.py); the
    # pipeline still refuses it, as the JAX recipe does
    with pytest.raises(SystemExit, match="drop --model-parallel"):
        lm_pretrain.main(["--device", "cpu", "--tiny", "--model-parallel", "2",
                          "--pipeline-stages", "2"])


def test_create_lm_state_keeps_fp32_parameters():
    cfg = dataclasses.replace(tiny_config(max_seq_len=SEQ), dtype=torch.bfloat16)
    state = create_lm_state(cfg, lr_schedule=lambda s: 0.0, device="cpu")
    assert state.model.cfg.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert state.param_count() == sum(p.numel() for p in state.model.parameters())
