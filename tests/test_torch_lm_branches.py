"""The LM's remaining branches in the port: blockwise attention, dropout,
the config's validation and the recipe's flags, and JAX checkpoints of
such models.

Blockwise attention (plain PyTorch, as XLA in JAX) is held to the JAX
``blockwise_attention`` and to dense attention, forward and gradients, fp32
to rtol 1e-4 / atol 1e-5, and the LM on it to flax's. Dropout cannot draw
``jax.random``'s bits, so the port is held to JAX's contract instead: at
rate 0, and in evaluation, a model with dropout is exactly the model
without; the keep rate is within 3σ of 1 - p and kept values are scaled
by 1 / (1 - p); a step's masks are a function of (seed, step, shard)
alone, so two runs from one seed are bit-equal and a suspended and resumed
run is bit-equal to the uninterrupted one. The config raises JAX's
``ValueError`` messages; ``tp_size``/``ep_size`` > 1 raise
``NotImplementedError``. One torch thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.data import SyntheticTokens as JaxTokens
from pytorch_distributed_tpu.models.transformer import TransformerConfig as JaxConfig
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.ops.attention import blockwise_attention as jax_blockwise
from pytorch_distributed_tpu.parallel import make_mesh
from pytorch_distributed_tpu.resilience import faults as jfaults
from pytorch_distributed_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from pytorch_distributed_tpu.train.lm_trainer import LMTrainerConfig as JaxLMTrainerConfig
from pytorch_distributed_tpu.utils.suspend import SuspendWatcher as JaxWatcher
from pytorch_distributed_tpu_torch.data import SyntheticTokens
from pytorch_distributed_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    params_from_jax,
    params_to_jax,
    tiny_config,
)
from pytorch_distributed_tpu_torch.models.transformer import dropout
from pytorch_distributed_tpu_torch.ops.attention import blockwise_attention, dense_attention
from pytorch_distributed_tpu_torch.recipes import lm_pretrain
from pytorch_distributed_tpu_torch.resilience import faults
from pytorch_distributed_tpu_torch.resilience.faults import FaultPlan, FaultSpec
from pytorch_distributed_tpu_torch.train import (
    LMTrainer,
    LMTrainerConfig,
    create_lm_state,
    lm_collate,
    make_lm_train_step,
)
from pytorch_distributed_tpu_torch.train.lm import dropout_generator
from pytorch_distributed_tpu_torch.train.state import state_payload
from pytorch_distributed_tpu_torch.utils.suspend import SuspendWatcher

SEQ = 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
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


def qkv(b=2, lq=32, lk=32, h=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, lq, h, d), (b, lk, h, d), (b, lk, h, d), (b, lq, h, d))]


@pytest.mark.parametrize("block,causal,offsets", [
    (8, True, (0, 0)), (32, True, (16, 16)), (8, False, (0, 0)), (16, True, (40, 8))])
def test_blockwise_matches_jax_and_dense(block, causal, offsets):
    """Output and gradients against JAX's (its scan under ``remat``) and
    against dense attention; the last case masks rows fully."""
    q, k, v, do = qkv(lk=32 if offsets[0] == offsets[1] else 48)
    qo, ko = offsets

    def jf(q_, k_, v_):
        return jax_blockwise(q_, k_, v_, causal=causal, block_size=block, q_offset=qo,
                             k_offset=ko)

    want, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    want_g = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = blockwise_attention(qt, kt, vt, causal=causal, block_size=block, q_offset=qo,
                              k_offset=ko)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    for g, w in zip((qt.grad, kt.grad, vt.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        dense = dense_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                q_offset=qo, k_offset=ko)
    np.testing.assert_allclose(got.detach().numpy(), dense.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="not divisible by block_size"):
        blockwise_attention(*(torch.from_numpy(x) for x in (q, k, v)), block_size=7)


def test_blockwise_lm_matches_flax():
    """``attention="blockwise"`` with blocks of 8 (``min(block_size, L)``)
    through the LM, at offsets 0 and 16."""
    jcfg = jax_tiny_config(attention="blockwise", block_size=8, max_seq_len=64)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLM(tiny_config(attention="blockwise", block_size=8, max_seq_len=64))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    toks = np.random.default_rng(0).integers(1, 128, (2, SEQ)).astype(np.int32)
    for offset in (0, 16):
        want = JaxLM(jcfg).apply({"params": params}, jnp.asarray(toks), position_offset=offset)
        with torch.no_grad():
            got = model(torch.from_numpy(toks), position_offset=offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_dropout_keep_rate_and_scale():
    """Kept share within 3σ of 1 - p over 2^18 draws, kept values x / (1 -
    p), the rest 0; one generator state, one mask."""
    n, p = 1 << 18, 0.1
    x = torch.ones(n)
    out = dropout(x, p, torch.Generator().manual_seed(0))
    kept = (out != 0).float().mean().item()
    assert abs(kept - (1 - p)) <= 3 * (p * (1 - p) / n) ** 0.5
    assert torch.allclose(out[out != 0], torch.full_like(out[out != 0], 1 / (1 - p)))
    again = dropout(x, p, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    bf = dropout(x.bfloat16(), 0.5, torch.Generator().manual_seed(1))
    assert bf.dtype == torch.bfloat16 and set(bf.unique().tolist()) <= {0.0, 2.0}


def test_dropout_masks_are_a_function_of_seed_step_and_shard():
    def draw(*key):
        return torch.rand(64, generator=dropout_generator(*key, "cpu"))

    assert torch.equal(draw(0, 3, 1), draw(0, 3, 1))
    for other in ((1, 3, 1), (0, 4, 1), (0, 3, 0)):
        assert not torch.equal(draw(0, 3, 1), draw(*other))


def batches(n=3, seed=10):
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(v) for k, v in lm_collate(
        list(rng.integers(1, 128, (2, SEQ)).astype(np.int32))).items()} for _ in range(n)]


def run_steps(cfg, n=3, seed=0):
    state = create_lm_state(cfg, lr_schedule=lambda s: 1e-2, seed=seed, device="cpu")
    step = make_lm_train_step(grad_clip_norm=1.0, config=cfg, dropout_seed=seed)
    losses = []
    for batch in batches(n):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    return state, losses


@pytest.mark.parametrize("kind", ["rate0", "eval"])
def test_dropout_off_is_exactly_the_model_without(kind):
    """Rate 0 trains bit for bit as the config without the field; at 0.3 in
    evaluation (or without a generator) the forward is exactly dropout-free."""
    base = tiny_config(attention="dense", max_seq_len=SEQ)
    if kind == "rate0":
        a, la = run_steps(base)
        b, lb = run_steps(dataclasses.replace(base, dropout=0.0))
        assert la == lb
        for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
            assert torch.equal(x, y), k
        return
    model = TransformerLM(dataclasses.replace(base, dropout=0.3))
    plain = TransformerLM(base)
    plain.load_state_dict(model.state_dict())
    toks = batches(1)[0]["tokens"]
    model.eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        assert torch.equal(model(toks, dropout_rng=gen), plain(toks))
        model.train()
        assert torch.equal(model(toks), plain(toks))  # no generator, no dropout
        assert not torch.equal(model(toks, dropout_rng=gen), plain(toks))


def test_dropout_runs_from_one_seed_are_bit_equal():
    cfg = tiny_config(attention="dense", max_seq_len=SEQ, dropout=0.1,
                      num_heads=4, num_kv_heads=2, pos_embedding="rope")
    a, la = run_steps(cfg)
    b, lb = run_steps(cfg)
    assert la == lb
    for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()):
        assert torch.equal(x, y)
    _, lc = run_steps(dataclasses.replace(cfg, dropout=0.0))
    assert la != lc


def lm_trainer(save_dir, watcher=None):
    cfg = LMTrainerConfig(epochs=2, batch_size=4, lr=3e-3, log_every=0, grad_clip_norm=1.0,
                          save_dir=str(save_dir))
    model = tiny_config(attention="dense", max_seq_len=16, dropout=0.1, num_heads=4,
                        num_kv_heads=2, pos_embedding="rope", n_experts=4)
    return LMTrainer(model, SyntheticTokens(16, 16, 128), SyntheticTokens(6, 16, 128, seed=1),
                     cfg, device="cpu", suspend_watcher=watcher)


def test_dropout_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """Dropout on GQA + RoPE + MoE: suspended at step 2 of 8 and fitted to
    the end by a fresh trainer, the state equals the uninterrupted run's
    bit for bit (the masks follow the step, not a carried generator)."""
    full = lm_trainer(tmp_path / "full")
    want = full.fit()
    faults.install_plan(FaultPlan([FaultSpec("train.step", "suspend", at=2)]))
    first = lm_trainer(tmp_path / "resumed", SuspendWatcher(install_handlers=False))
    with pytest.raises(SystemExit):
        first.fit()
    faults.clear_plan()
    second = lm_trainer(tmp_path / "resumed")
    got = second.fit()
    assert got == want
    a, b = state_payload(second.state), state_payload(full.state)
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        assert torch.equal(a[k], v) if isinstance(v, torch.Tensor) else a[k] == v, k


def test_a_jax_checkpoint_of_a_gqa_rope_moe_model_resumes_in_the_port(tmp_path):
    """The JAX ``LMTrainer`` on GQA + RoPE + MoE suspends at step 1 of 4;
    the port resumes from its directory (``q``/``kv``, no ``wpe``, the
    ``moe`` leaves and AdamW's moments across) and ends at the JAX run's
    parameters (2e-5; the key bias to 3 lr)."""
    lr, kw = 1e-2, dict(num_heads=4, num_kv_heads=2, pos_embedding="rope", n_experts=4)

    def jax_trainer(d, watcher=None):
        cfg = JaxLMTrainerConfig(epochs=1, batch_size=2, lr=lr, warmup_steps=0, log_every=0,
                                 grad_clip_norm=1.0, save_dir=str(d), flush_every=0,
                                 metrics_out=str(d / "metrics.jsonl"))
        return JaxLMTrainer(jax_tiny_config(attention="dense", max_seq_len=16, **kw),
                            JaxTokens(8, 16, 128), JaxTokens(4, 16, 128, seed=1), cfg,
                            mesh=make_mesh(jax.devices()[:1]), suspend_watcher=watcher)

    full = jax_trainer(tmp_path / "full")
    want = full.fit()
    spec = [FaultSpec("train.step", "suspend", at=1)]
    jfaults.install_plan(jfaults.FaultPlan.from_json(FaultPlan(spec).to_json()))
    with pytest.raises(SystemExit):
        jax_trainer(tmp_path / "jax", JaxWatcher(install_handlers=False)).fit()
    jfaults.clear_plan()
    cfg = tiny_config(attention="dense", max_seq_len=16, **kw)
    port = LMTrainer(cfg, SyntheticTokens(8, 16, 128), SyntheticTokens(4, 16, 128, seed=1),
                     LMTrainerConfig(epochs=1, batch_size=2, lr=lr, log_every=0,
                                     grad_clip_norm=1.0, save_dir=str(tmp_path / "jax")),
                     device="cpu")
    got = port.fit()
    assert port.state.step == int(full.state.step) == 4
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    mine = params_to_jax(port.state.model.state_dict(), cfg)
    theirs = jax.tree.map(np.array, jax.device_get(full.state.params))
    for i in range(cfg.num_layers):
        k_got, k_want = (p[f"block{i}"]["attn"]["kv"]["bias"][0] for p in (mine, theirs))
        np.testing.assert_allclose(k_got, k_want, rtol=0, atol=3 * lr)
        for p in (mine, theirs):
            p[f"block{i}"]["attn"]["kv"]["bias"][0] = 0.0
    fa, ta = jax.tree_util.tree_flatten(mine)
    fb, tb = jax.tree_util.tree_flatten(theirs)
    assert ta == tb
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(x, y, rtol=0, atol=2e-5)


BAD_CONFIGS = [
    dict(num_kv_heads=0), dict(num_heads=4, num_kv_heads=3), dict(pos_embedding="alibi"),
    dict(pos_embedding="rope", num_heads=4, embed_dim=36), dict(rope_theta=0.0),
    dict(dropout=1.0), dict(dropout=-0.1), dict(n_experts=4, moe_top_k=5),
    dict(n_experts=4, moe_top_k=0), dict(embed_dim=33),
]


@pytest.mark.parametrize("bad", BAD_CONFIGS, ids=lambda kw: ",".join(map(str, kw.items())))
def test_config_raises_jax_value_errors(bad):
    with pytest.raises(ValueError) as want:
        JaxConfig(**dict(dict(num_heads=2, embed_dim=32), **bad))
    with pytest.raises(ValueError) as got:
        TransformerConfig(**dict(dict(num_heads=2, embed_dim=32), **bad))
    assert str(got.value) == str(want.value)


def test_recipe_builds_the_branches_from_its_flags():
    """``--kv-heads``, ``--pos-embedding``, ``--dropout`` and ``blockwise``
    reach the config; ``--tiny`` takes ``--dropout`` alone, as in JAX; a
    bad ``--kv-heads`` fails with JAX's message."""
    args = lm_pretrain._parse(["--synthetic", "--kv-heads", "4", "--pos-embedding", "rope",
                               "--dropout", "0.1", "--attention", "blockwise"])
    cfg = lm_pretrain.model_config(args, 2048, 32000)
    assert (cfg.num_kv_heads, cfg.pos_embedding, cfg.dropout, cfg.attention) == (
        4, "rope", 0.1, "blockwise")
    assert (cfg.num_heads, cfg.embed_dim, cfg.head_dim, cfg.dtype) == (
        12, 768, 64, torch.bfloat16)
    tiny = lm_pretrain.model_config(lm_pretrain._parse(
        ["--tiny", "--dropout", "0.2", "--kv-heads", "1"]), 32, 128)
    assert tiny.dropout == 0.2 and tiny.num_kv_heads is None
    with pytest.raises(ValueError, match="num_heads 12 not divisible by num_kv_heads 5"):
        lm_pretrain.model_config(lm_pretrain._parse(["--kv-heads", "5"]), 2048, 32000)
    with pytest.raises(SystemExit):
        lm_pretrain._parse(["--pos-embedding", "alibi"])


def test_recipe_trains_the_branches_on_the_cpu(tmp_path, capsys):
    """The recipe to its end with GQA, RoPE, dropout and blockwise at a
    narrow width."""
    summary = lm_pretrain.main([
        "--device", "cpu", "--synthetic", "--steps", "2", "--batch-size", "2",
        "--layers", "2", "--heads", "4", "--kv-heads", "2", "--embed-dim", "32",
        "--vocab-size", "128", "--seq-len", "32", "--pos-embedding", "rope",
        "--dropout", "0.1", "--attention", "blockwise", "--save-dir", str(tmp_path)])
    assert np.isfinite(summary["loss"]) and summary["tokens"] > 0
