"""Grouped-query attention and rotary positions in the port against the JAX
package.

Same weights (the flax tree carried across by ``params_from_jax``), same
seeded numpy inputs, fp32: ``rope_apply`` at ``rope_angles`` against
``_rope_rotate``; the training forward and its gradients for GQA, RoPE and
both; three train steps against ``make_lm_train_step``; the paged
serve's greedy streams against the JAX ``Scheduler`` and the dense decode
against ``generate`` / ``generate_ragged``, at 4 query heads over 2 KV
heads, learned and rotary; and RoPE and GQA under the port's plain ring on
2 gloo ranks against one rank's dense step. JAX attention is ``dense``
wherever it computes the same thing, flash once (interpret-mode Pallas is
slow here).

Tolerances are ``test_torch_lm_train.py``'s: rtol 1e-4 and atol 1e-5 on
activations and gradients of order 1, 1e-5 relative on losses and grad
norms, 2e-5 on parameters after three steps (the key bias to 3 lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pytorch_distributed_tpu.models.generate import generate as jax_generate
from pytorch_distributed_tpu.models.generate import generate_ragged as jax_generate_ragged
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import _rope_rotate
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.ops.losses import cross_entropy_loss as jax_ce
from pytorch_distributed_tpu.ops.optim import build_optimizer as jax_build_optimizer
from pytorch_distributed_tpu.ops.schedules import warmup_cosine as jax_warmup_cosine
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu_torch.models import (
    TransformerLM,
    params_from_jax,
    params_to_jax,
    tiny_config,
)
from pytorch_distributed_tpu_torch.models.generate import generate, generate_ragged, init_cache
from pytorch_distributed_tpu_torch.models.transformer import rope_angles, rope_apply
from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_tpu_torch.ops.schedules import warmup_cosine
from pytorch_distributed_tpu_torch.serving import Scheduler, init_paged_cache
from pytorch_distributed_tpu_torch.tools import ring_check
from pytorch_distributed_tpu_torch.train import create_lm_state, lm_collate, make_lm_train_step

SEQ = 32
MAX_SEQ = 64
# 4 query heads over 2 KV heads (G = 2), head_dim 8
GQA = dict(num_heads=4, num_kv_heads=2)
BRANCHES = {"gqa": GQA, "rope": dict(pos_embedding="rope"),
            "gqa_rope": dict(GQA, pos_embedding="rope")}
SERVE = dict(n_slots=3, block_len=8, prefill_chunk=8)
SCHED = (1e-2, 6, 1, 1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_weights(jcfg, seed=0):
    params = JaxLM(jcfg).init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return params, jax.tree.map(np.asarray, params)


def port_model(cfg, np_params):
    model = TransformerLM(cfg)
    model.load_state_dict(params_from_jax(np_params))
    return model


def tokens(b=2, l=SEQ, seed=0):
    return np.random.default_rng(seed).integers(1, 128, (b, l)).astype(np.int32)


def trees_close(a, b, **tol):
    fa, ta = jax.tree_util.tree_flatten(a)
    fb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **tol)


@pytest.mark.parametrize("shared", [True, False])
def test_rope_rotate_matches_jax(shared):
    """Interleaved pairs at absolute positions, [1, L] shared and [B, L]
    per request (positions up to 2047, where the angles are largest)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    pos = (rng.integers(0, 2048, (1, 5)) if shared else rng.integers(0, 2048, (3, 5)))
    want = np.asarray(_rope_rotate(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    got = rope_apply(torch.from_numpy(x), rope_angles(torch.from_numpy(pos), 16, 10000.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the rotations come from the one position array, for every layer: the
    # JAX angles' cos and sin
    rot = rope_angles(torch.from_numpy(pos), 16, 10000.0)
    assert rot.shape == (pos.shape[0], 5, 1, 8) and rot.dtype == torch.complex64
    ang = pos[..., None].astype(np.float32) / np.float32(10000.0) ** (
        np.arange(0, 16, 2, dtype=np.float32) / 16)
    np.testing.assert_allclose(rot.real[:, :, 0].numpy(), np.cos(ang), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rot.imag[:, :, 0].numpy(), np.sin(ang), rtol=1e-4, atol=1e-5)
    # bf16 in, bf16 out; fp32 trig inside
    xb = torch.from_numpy(x).bfloat16()
    got_b = rope_apply(xb, rope_angles(torch.from_numpy(pos), 16, 500.0))
    want_b = _rope_rotate(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), 500.0)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(), np.asarray(want_b, np.float32),
                               rtol=0, atol=2 ** -7 * 4)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_training_forward_and_grads_match_flax(branch):
    """Logits at offsets 0 and 16, and the gradient of a CE loss against
    ``jax.grad`` of the same loss, dense attention."""
    kw = BRANCHES[branch]
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ, **kw)
    params, np_params = jax_weights(jcfg)
    cfg = tiny_config(attention="dense", max_seq_len=MAX_SEQ, **kw)
    model = port_model(cfg, np_params)
    toks = tokens()
    labels = tokens(seed=5)
    for offset in (0, 16):
        want = JaxLM(jcfg).apply({"params": params}, jnp.asarray(toks), position_offset=offset)
        with torch.no_grad():
            got = model(torch.from_numpy(toks), position_offset=offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)

    def jloss(p):
        logits = JaxLM(jcfg).apply({"params": p}, jnp.asarray(toks))
        return jax_ce(logits.reshape(-1, 128), jnp.asarray(labels).reshape(-1))

    want_g = jax.grad(jloss)(params)
    model.zero_grad()
    loss = cross_entropy_loss(model(torch.from_numpy(toks)).reshape(-1, 128),
                              torch.from_numpy(labels).reshape(-1).long())
    np.testing.assert_allclose(loss.item(), float(jloss(params)), rtol=1e-5)
    loss.backward()
    got_g = params_to_jax({k: p.grad for k, p in model.named_parameters()}, cfg)
    trees_close(got_g, jax.tree.map(np.asarray, want_g), rtol=1e-4, atol=1e-5)


def test_gqa_rope_flash_forward_and_grads_match_flax():
    """The one flash case: JAX's Pallas kernel in interpret mode, the port's
    plain versions, K/V repeated to the query heads before the kernel."""
    kw = BRANCHES["gqa_rope"]
    jcfg = jax_tiny_config(attention="flash", max_seq_len=MAX_SEQ, **kw)
    params, np_params = jax_weights(jcfg)
    cfg = tiny_config(attention="flash", max_seq_len=MAX_SEQ, **kw)
    model = port_model(cfg, np_params)
    toks = tokens(b=1)

    def jloss(p):
        return jnp.sum(JaxLM(jcfg).apply({"params": p}, jnp.asarray(toks)) ** 2) / toks.size

    want_g = jax.grad(jloss)(params)
    out = model(torch.from_numpy(toks))
    loss = (out ** 2).sum() / toks.size
    np.testing.assert_allclose(loss.item(), float(jloss(params)), rtol=1e-5)
    loss.backward()
    got_g = params_to_jax({k: p.grad for k, p in model.named_parameters()}, cfg)
    trees_close(got_g, jax.tree.map(np.asarray, want_g), rtol=1e-4, atol=1e-5)


def test_gqa_parameters_follow_the_flax_tree():
    """Separate ``q`` [E, H, D] and ``kv`` [E, 2, H_kv, D] projections with
    biases, no ``wpe`` under RoPE; MHA keeps the fused ``qkv``."""
    jcfg = jax_tiny_config(max_seq_len=MAX_SEQ, **BRANCHES["gqa_rope"])
    _, np_params = jax_weights(jcfg)
    assert "wpe" not in np_params
    attn = np_params["block0"]["attn"]
    assert attn["q"]["kernel"].shape == (32, 4, 8) and attn["kv"]["kernel"].shape == (32, 2, 2, 8)
    cfg = tiny_config(max_seq_len=MAX_SEQ, **BRANCHES["gqa_rope"])
    sd = params_from_jax(np_params)
    assert not any(k.startswith("wpe") or ".qkv." in k for k in sd)
    trees_close(params_to_jax(sd, cfg), np_params, rtol=0, atol=0)
    assert cfg.kv_heads == 2 and tiny_config().kv_heads == 2


def test_three_gqa_rope_train_steps_match_make_lm_train_step():
    """The port's train step (fused CE, clip 1.0, warmup-cosine AdamW)
    against ``make_lm_train_step`` on a one-device mesh, GQA + RoPE, fp32."""
    kw = BRANCHES["gqa_rope"]
    jcfg = jax_tiny_config(attention="dense", max_seq_len=SEQ, **kw)
    tx = jax_build_optimizer("adamw", jax_warmup_cosine(*SCHED), weight_decay=0.1)
    jstate = jax_lm.create_lm_state(jcfg, tx, jax.random.key(0), init_len=SEQ)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seq"))
    jstep = jax_lm.make_lm_train_step(mesh, config=jcfg, grad_clip_norm=1.0)
    tcfg = tiny_config(attention="dense", max_seq_len=SEQ, **kw)
    state = create_lm_state(tcfg, lr_schedule=warmup_cosine(*SCHED), weight_decay=0.1,
                            params=params_from_jax(jax.tree.map(np.asarray, jstate.params)),
                            device="cpu")
    step = make_lm_train_step(grad_clip_norm=1.0, config=tcfg)
    for i in range(3):
        batch = lm_collate(list(tokens(seed=10 + i)))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
    got = params_to_jax(state.model.state_dict(), tcfg)
    want = jax.tree.map(np.array, jstate.params)
    for i in range(tcfg.num_layers):
        # the key bias: rounding noise scaled to about lr by Adam (see
        # test_torch_lm_train.py), compared to 3 lr
        k_got, k_want = (p[f"block{i}"]["attn"]["kv"]["bias"][0] for p in (got, want))
        np.testing.assert_allclose(k_got, k_want, rtol=0, atol=3 * SCHED[0])
        for p in (got, want):
            p[f"block{i}"]["attn"]["kv"]["bias"][0] = 0.0
    trees_close(got, want, rtol=1e-4, atol=2e-5)


def serve_prompts(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=int(l)).astype(np.int32)
            for l in rng.integers(3, 25, size=n)]


def drain_all(sched, reqs, max_new=6):
    rids = [sched.submit(p, max_new) for p in reqs]
    out = sched.drain()
    return [[int(t) for t in out[r]] for r in rids]


@pytest.mark.parametrize("kv_dtype", [None, "fp8"])
@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_paged_serve_streams_match_jax_scheduler(pos, kv_dtype):
    """4 query heads over 2-head pools (half of MHA's bytes), learned or
    rotary positions, float and fp8 pools, an over-committed pool: greedy streams equal the JAX ``Scheduler``'s, the
    pools hold H_kv heads, every block comes back."""
    kw = dict(GQA, pos_embedding=pos)
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ, **kw)
    params, np_params = jax_weights(jcfg)
    reqs = serve_prompts()
    want = drain_all(JaxScheduler(jcfg, params, n_blocks=10, gather_impl="dense",
                                  kv_dtype=kv_dtype, **SERVE), reqs)
    cfg = tiny_config(max_seq_len=MAX_SEQ, **kw)
    s = Scheduler(cfg, params_from_jax(np_params), n_blocks=10, kv_dtype=kv_dtype,
                  device="cpu", **SERVE)
    assert s.engine.cache[0].key.shape[2] == 2
    assert drain_all(s, reqs) == want
    assert s.engine.allocator.in_use == 0
    assert init_paged_cache(cfg, 3, 8)[0].key.shape == (3, 8, 2, 8)


@pytest.mark.parametrize("pos", ["learned", "rope"])
def test_dense_decode_matches_jax(pos):
    """``generate`` and ``generate_ragged`` against JAX's on the H_kv-head
    dense cache, whose decode reads by group (never widened)."""
    kw = dict(GQA, pos_embedding=pos)
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ, **kw)
    params, np_params = jax_weights(jcfg)
    cfg = tiny_config(attention="dense", max_seq_len=MAX_SEQ, **kw)
    model = port_model(cfg, np_params)
    prompt = tokens(b=2, l=9, seed=2)
    want = np.asarray(jax_generate(jcfg, params, jnp.asarray(prompt), jax.random.key(1),
                                   max_new_tokens=8))
    np.testing.assert_array_equal(generate(cfg, model, prompt, 8).numpy(), want)
    lengths = [5, 17, 12]
    padded = np.zeros((3, 17), np.int32)
    rng = np.random.default_rng(3)
    for i, l in enumerate(lengths):
        padded[i, :l] = rng.integers(1, 128, l)
    want_r = np.asarray(jax_generate_ragged(jcfg, params, jnp.asarray(padded),
                                            jnp.asarray(lengths, jnp.int32), jax.random.key(1),
                                            max_new_tokens=8))
    np.testing.assert_array_equal(generate_ragged(cfg, model, padded, lengths, 8).numpy(),
                                  want_r)
    assert init_cache(cfg, 3, device="cpu")[0].key.shape == (3, MAX_SEQ, 2, 8)


RING_RUNS = {f"{layout}/{kind}": (layout, kind) for layout in ("contiguous", "zigzag")
             for kind in ("rope", "gqa_rope")}


def ring_batches():
    rng = np.random.default_rng(7)
    return [lm_collate(list(rng.integers(1, 128, (2, SEQ)).astype(np.int32)))
            for _ in range(3)]


def ring_model(kind, attention, layout="contiguous"):
    return dict(vocab_size=128, num_layers=2, embed_dim=32, max_seq_len=SEQ,
                dtype="float32", attention=attention, ring_layout=layout,
                **dict(BRANCHES[kind], num_heads=BRANCHES[kind].get("num_heads", 2)))


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """Three steps of the plain ring on 2 gloo ranks (one spawn, every
    case), and of one rank's dense step, from the same weights."""
    tmp = tmp_path_factory.mktemp("ring")
    params = {kind: params_from_jax(jax.tree.map(np.asarray, jax_weights(
        jax_tiny_config(max_seq_len=SEQ, **BRANCHES[kind]))[1])) for kind in ("rope", "gqa_rope")}
    out = {}
    for kind in ("rope", "gqa_rope"):
        models = {name: ring_model(kind, "ring", layout)
                  for name, (layout, k) in RING_RUNS.items() if k == kind}
        job = dict(task="train", backend="gloo", rendezvous=f"file://{tmp}/rv-{kind}",
                   out=str(tmp / f"out-{kind}"), dp=1, sp=2, device="cpu", models=models,
                   params=params[kind], batches=ring_batches(), schedule=SCHED,
                   weight_decay=0.1, grad_clip_norm=1.0, timeout_s=120)
        ring_check.run(job, 2)
        for r in ring_check.load(job):
            for name, res in r.items():
                out.setdefault(name, []).append(res)
        cfg = ring_check._model_config(ring_model(kind, "dense"))
        state = create_lm_state(cfg, lr_schedule=warmup_cosine(*SCHED), weight_decay=0.1,
                                params=params[kind], device="cpu")
        step = make_lm_train_step(grad_clip_norm=1.0)
        losses = []
        for batch in ring_batches():
            state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
            losses.append(m["loss"].item())
        out[f"dense/{kind}"] = (losses, {k: v.detach().clone()
                                         for k, v in state.model.state_dict().items()})
    return out


@pytest.mark.parametrize("name", list(RING_RUNS))
def test_plain_ring_with_rope_and_gqa_matches_dense(ring_runs, name):
    """The ring rotates each shard at its absolute positions (offset +
    arange, or the zigzag chunk map) and ships rotated, narrow K/V repeated
    at each visit: losses equal the dense step's to 1e-5 relative each step
    and the parameters to 2e-5 after three (as the JAX ``test_rope.py``
    holds its ring, there at 5e-4 and 2e-3 over bf16-free XLA rings)."""
    _, kind = RING_RUNS[name]
    want_losses, want_params = ring_runs[f"dense/{kind}"]
    for rank in ring_runs[name]:
        np.testing.assert_allclose(rank["metrics"]["loss"], want_losses, rtol=1e-5)
    got = ring_runs[name][0]["params"]
    for k, v in want_params.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=2e-5,
                                   err_msg=k)


def test_warmup_captures_the_same_programs_and_the_fingerprint_keys_the_branches():
    """The serve of the GQA + RoPE (and a tiny MoE) model predicts and warms
    the MHA serve's program names; the run fingerprint keys the new fields."""
    from pytorch_distributed_tpu_torch.compilecache import serving_registry
    from pytorch_distributed_tpu_torch.models import init_params

    regs = {}
    for name, kw in (("mha", {}), ("gqa_rope", BRANCHES["gqa_rope"]),
                     ("gqa_rope_moe", dict(BRANCHES["gqa_rope"], n_experts=4))):
        cfg = tiny_config(max_seq_len=MAX_SEQ, **kw)
        s = Scheduler(cfg, params_from_jax(init_params(cfg, 0)), device="cpu", **SERVE)
        s.warmup(background=False)
        reg = serving_registry(s.engine)
        reg.assert_covers(s.engine.compiled_program_names())
        regs[name] = (reg.names, reg.fingerprint)
    assert regs["mha"][0] == regs["gqa_rope"][0] == regs["gqa_rope_moe"][0]
    assert len({fp for _, fp in regs.values()}) == 3


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_continuous_batcher_matches_jax(layout):
    """``ContinuousBatcher`` on the GQA + RoPE model, both layouts: the
    JAX batcher's events for the same submits (slots reused), on an
    H_kv-head cache."""
    from pytorch_distributed_tpu.models.generate import ContinuousBatcher as JaxBatcher
    from pytorch_distributed_tpu_torch.models.generate import ContinuousBatcher

    def events(batcher, prompts, budgets):
        out, pending = [], list(range(len(prompts)))
        while pending or (np.asarray(batcher.remaining) > 0).any():
            while pending and batcher.free_slots():
                i = pending.pop(0)
                out.append(("submit", i, int(batcher.submit(prompts[i], budgets[i]))))
            out += [(int(slot), int(tok)) for slot, tok in batcher.step()]
        return out

    kw = BRANCHES["gqa_rope"]
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ, **kw)
    params, np_params = jax_weights(jcfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 128, (n,)).astype(np.int32) for n in (7, 13, 4, 21)]
    budgets = [6, 10, 8, 5]
    paged = dict(block_len=8, gather_impl="dense") if layout == "paged" else {}
    want = events(JaxBatcher(jcfg, params, n_slots=2, prefill_bucket=8, cache_layout=layout,
                             **paged), prompts, budgets)
    b = ContinuousBatcher(tiny_config(max_seq_len=MAX_SEQ, **kw), params_from_jax(np_params),
                          n_slots=2, prefill_bucket=8, cache_layout=layout, device="cpu",
                          **({"block_len": 8} if layout == "paged" else {}))
    assert events(b, prompts, budgets) == want
    cache = b.engine.cache if layout == "paged" else b.cache
    assert cache[0].key.shape[2] == 2


def test_swap_and_handoff_carry_narrow_pools():
    """The swap and host tier and the fleet's handoff take the pool's head
    count from the pools: an over-committed GQA + RoPE serve that swaps
    (fp8 pools) and a disaggregated fleet give the ample serve's streams."""
    from pytorch_distributed_tpu_torch.fleet import FleetRouter
    from pytorch_distributed_tpu_torch.models import init_params

    cfg = tiny_config(max_seq_len=MAX_SEQ, **BRANCHES["gqa_rope"])
    state = params_from_jax(init_params(cfg, 0))
    reqs = serve_prompts(8, seed=4)
    for kv in (None, "fp8"):
        ample = drain_all(Scheduler(cfg, state, kv_dtype=kv, device="cpu", **SERVE), reqs)
        s = Scheduler(cfg, state, kv_dtype=kv, n_blocks=8, offload=True, preempt_on_oom=True,
                      swap_policy="swap", device="cpu", **SERVE)
        assert drain_all(s, reqs) == ample
        m = s.metrics()
        assert m["swap_outs"] >= 1 and m["preempts"] == m["restores"]
        router = FleetRouter(cfg, state, n_replicas=2, disaggregate=True, device="cpu",
                             kv_dtype=kv, **SERVE)
        try:
            rids = [router.submit(p, 6) for p in reqs]
            out = router.drain()
            assert [[int(t) for t in out[r]] for r in rids] == ample
            assert router.metrics()["handoffs"] == len(reqs)
        finally:
            router.close()
