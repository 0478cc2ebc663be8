"""The port's mixture of experts against the JAX package's
``models/moe.py``.

The port spells ``topk_dispatch``'s routing with index tensors (an
expert and a slot a token and choice rank) where JAX multiplies one-hot
``[T, E, C]`` tensors; the tests rebuild the one-hot dispatch and combine
from the port's routes and hold them to JAX's: dispatch exactly, combine
to fp32 rounding (1e-6 relative), top-1 and top-2, with ample capacity
and with tokens dropped over it. Then ``MoEMLP``'s output, aux loss and
drop share (1e-5), the MoE LM's forward and gradients (rtol 1e-4, atol
1e-5), three train steps against ``make_lm_train_step`` (losses, grad
norms and ``moe_dropped_frac`` to 1e-5 relative, parameters 2e-5), the
evaluation's relaxed capacity against ``make_lm_eval_step`` (1e-5), and a
tiny MoE serve against the JAX ``Scheduler``'s greedy streams. fp32,
seeded numpy inputs, one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pytorch_distributed_tpu.models.moe import MoEMLP as JaxMoEMLP
from pytorch_distributed_tpu.models.moe import topk_dispatch
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.ops.optim import build_optimizer as jax_build_optimizer
from pytorch_distributed_tpu.ops.schedules import warmup_cosine as jax_warmup_cosine
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu_torch.models import (
    TransformerLM,
    init_params,
    params_from_jax,
    params_to_jax,
    tiny_config,
)
from pytorch_distributed_tpu_torch.models.moe import (
    MoEMLP,
    capacity_of,
    eval_capacity_factor,
    moe_layers,
    relaxed_capacity,
    stable_top_k,
    topk_routes,
)
from pytorch_distributed_tpu_torch.ops.schedules import warmup_cosine
from pytorch_distributed_tpu_torch.serving import Scheduler
from pytorch_distributed_tpu_torch.train import (
    create_lm_state,
    lm_collate,
    make_lm_eval_step,
    make_lm_train_step,
)
from pytorch_distributed_tpu_torch.train.lm import lm_loss_sum

SEQ = 32
SCHED = (1e-2, 6, 1, 1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def one_hot_of(routes, capacity, n_experts):
    """JAX's dispatch and combine ``[T, E, C]`` from the port's routes."""
    t, k = routes.slot.shape
    dispatch = np.zeros((t, n_experts, capacity), np.float32)
    combine = np.zeros_like(dispatch)
    for i in range(t):
        for r in range(k):
            if routes.keep[i, r]:
                e = int(routes.expert[i, r])
                c = int(routes.slot[i, r]) - e * capacity
                assert 0 <= c < capacity
                dispatch[i, e, c] = 1.0
                combine[i, e, c] = float(routes.gates[i, r])
    return dispatch, combine


ROUTING = {
    "top1 ample": (dict(t=16, e=4, seed=0), 16, 1),
    "top1 over capacity": (dict(t=16, e=4, seed=0), 3, 1),
    "top2 ample": (dict(t=16, e=4, seed=5), 16, 2),
    "top2 over capacity": (dict(t=24, e=4, seed=6), 5, 2),
    "top1 all to expert 0": (np.tile([5.0, 0.0], (6, 1)), 2, 1),
    "top2 rank priority": (np.tile([4.0, 2.0, -4.0], (3, 1)), 2, 2),
}


@pytest.mark.parametrize("case", list(ROUTING))
def test_routing_equals_topk_dispatch(case):
    spec, capacity, k = ROUTING[case]
    if isinstance(spec, dict):
        logits = np.random.default_rng(spec["seed"]).normal(size=(spec["t"], spec["e"]))
        logits = logits.astype(np.float32)
    else:
        logits = spec.astype(np.float32)
    want_d, want_c, want_aux, stats = topk_dispatch(jnp.asarray(logits), capacity, k=k)
    routes = topk_routes(torch.from_numpy(logits), capacity, k)
    got_d, got_c = one_hot_of(routes, capacity, logits.shape[1])
    np.testing.assert_array_equal(got_d, np.asarray(want_d))
    np.testing.assert_allclose(got_c, np.asarray(want_c), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(routes.aux.item(), float(want_aux), rtol=1e-6)
    assert routes.dropped_frac.item() == float(stats["dropped_frac"])
    if "over capacity" in case or "expert 0" in case or "priority" in case:
        assert routes.dropped_frac.item() > 0


def test_top_k_breaks_ties_to_the_lower_expert():
    """``lax.top_k``'s order: equal probabilities go to the lower index."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    _, idx = stable_top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 3]]
    assert capacity_of(1.25, 2, 16, 4) == 10 and capacity_of(0.01, 1, 4, 8) == 1


@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 1.25), (1, 0.5)])
def test_moe_mlp_matches_jax(top_k, cf):
    """Output, the sowed (pre-weighted) aux loss and the drop share, and
    the input gradient, from the same weights; cf 0.5 drops tokens."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 16)).astype(np.float32)
    jm = JaxMoEMLP(n_experts=4, mlp_dim=32, capacity_factor=cf, top_k=top_k)
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    (want, mut) = jm.apply(variables, jnp.asarray(x), mutable=["aux_loss", "moe_stats"])
    p = jax.tree.map(np.array, variables["params"])  # writable copies
    m = MoEMLP(4, 16, 32, capacity_factor=cf, top_k=top_k)
    m.load_state_dict({"router.weight": torch.from_numpy(p["router"]["kernel"].T.copy()),
                       "w_up": torch.from_numpy(p["w_up"]), "w_down": torch.from_numpy(p["w_down"])})
    xt = torch.from_numpy(x).requires_grad_()
    got = m(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.aux_loss.item(), float(mut["aux_loss"]["moe"][0]), rtol=1e-5)
    assert m.dropped_frac.item() == float(mut["moe_stats"]["dropped_frac"][0])
    want_gx = jax.grad(lambda z: jnp.sum(jm.apply(variables, z, mutable=["aux_loss"])[0] ** 2))(
        jnp.asarray(x))
    (got ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), rtol=1e-4, atol=1e-5)


def moe_kw(top_k=1):
    return dict(n_experts=4, moe_top_k=top_k)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_lm_forward_and_grads_match_flax(top_k):
    """MoE in every second block (``moe_every`` 2): logits and each
    parameter's gradient of the mean logit square plus the aux losses."""
    jcfg = jax_tiny_config(attention="dense", max_seq_len=64, **moe_kw(top_k))
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    np_params = jax.tree.map(np.asarray, params)
    assert set(np_params["block1"]["moe"]) == {"router", "w_up", "w_down"}
    cfg = tiny_config(attention="dense", max_seq_len=64, **moe_kw(top_k))
    model = TransformerLM(cfg)
    model.load_state_dict(params_from_jax(np_params))
    toks = np.random.default_rng(0).integers(1, 128, (2, SEQ)).astype(np.int32)

    def jloss(p):
        logits, mut = JaxLM(jcfg).apply({"params": p}, jnp.asarray(toks),
                                        mutable=["aux_loss", "moe_stats"])
        return jnp.mean(logits ** 2) + sum(jax.tree.leaves(mut["aux_loss"])), mut

    (want, mut), want_g = jax.value_and_grad(jloss, has_aux=True)(params)
    logits = model(torch.from_numpy(toks))
    aux = sum(m.aux_loss for m in moe_layers(model))
    loss = (logits ** 2).mean() + aux
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    dropped = [m.dropped_frac.item() for m in moe_layers(model)]
    assert dropped == [float(x) for x in jax.tree.leaves(mut["moe_stats"])]
    loss.backward()
    got_g = params_to_jax({k: q.grad for k, q in model.named_parameters()}, cfg)
    fa, ta = jax.tree_util.tree_flatten(got_g)
    fb, tb = jax.tree_util.tree_flatten(jax.tree.map(np.asarray, want_g))
    assert ta == tb
    for a, b in zip(fa, fb):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # init_params builds the same tree
    assert (jax.tree_util.tree_structure(init_params(cfg))
            == jax.tree_util.tree_structure(np_params))


@pytest.mark.parametrize("top_k", [1, 2])
def test_three_moe_train_steps_match_make_lm_train_step(top_k):
    """The aux losses in the loss, ``moe_dropped_frac`` the mean over the
    layers, at a capacity factor of 0.5 that drops tokens."""
    kw = dict(moe_kw(top_k), capacity_factor=0.5)
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
    rng = np.random.default_rng(10)
    for _ in range(3):
        batch = lm_collate(list(rng.integers(1, 128, (2, SEQ)).astype(np.int32)))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "moe_dropped_frac"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5, err_msg=key)
        assert float(jm["moe_dropped_frac"]) > 0
    got = params_to_jax(state.model.state_dict(), tcfg)
    want = jax.tree.map(np.array, jstate.params)
    for i in range(tcfg.num_layers):
        # the key bias: rounding noise scaled to about lr by Adam, to 3 lr
        k_got, k_want = (p[f"block{i}"]["attn"]["qkv"]["bias"][1] for p in (got, want))
        np.testing.assert_allclose(k_got, k_want, rtol=0, atol=3 * SCHED[0])
        for p in (got, want):
            p[f"block{i}"]["attn"]["qkv"]["bias"][1] = 0.0
    fa, _ = jax.tree_util.tree_flatten(got)
    fb, _ = jax.tree_util.tree_flatten(want)
    for a, b in zip(fa, fb):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5)


def test_moe_eval_runs_at_the_relaxed_capacity():
    """``make_lm_eval_step`` at min(4 cf, E): equal to JAX's, different
    from the training capacity's, and the layers' factor restored after."""
    kw = dict(moe_kw(), capacity_factor=0.5)
    jcfg = jax_tiny_config(attention="dense", max_seq_len=SEQ, **kw)
    tx = jax_build_optimizer("adamw", jax_warmup_cosine(*SCHED), weight_decay=0.1)
    jstate = jax_lm.create_lm_state(jcfg, tx, jax.random.key(0), init_len=SEQ)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seq"))
    batch = lm_collate(list(np.random.default_rng(3).integers(1, 128, (4, SEQ))
                            .astype(np.int32)))
    zero = {"loss_sum": jnp.zeros(()), "tokens": jnp.zeros(())}
    want = jax_lm.make_lm_eval_step(mesh, config=jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, zero)
    tcfg = tiny_config(attention="dense", max_seq_len=SEQ, **kw)
    assert eval_capacity_factor(tcfg) == 2.0
    state = create_lm_state(tcfg, lr_schedule=lambda s: 0.0,
                            params=params_from_jax(jax.tree.map(np.asarray, jstate.params)),
                            device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def acc():
        return {"loss_sum": torch.zeros(()), "tokens": torch.zeros(())}

    got = make_lm_eval_step(config=tcfg)(state, tb, acc())
    np.testing.assert_allclose(got["loss_sum"].item(), float(want["loss_sum"]), rtol=1e-5)
    assert all(m.capacity_factor == 0.5 for m in moe_layers(state.model))
    # the training capacity drops tokens, so its sum differs
    with torch.no_grad(), relaxed_capacity(state.model, 0.5):
        tight = lm_loss_sum(state.model(tb["tokens"], return_hidden=True), state.model, tb,
                            True).item()
    assert tight != pytest.approx(got["loss_sum"].item(), rel=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
def test_tiny_moe_serve_matches_jax_scheduler(top_k):
    """A tiny MoE LM served on the paged path: greedy streams equal the
    JAX ``Scheduler``'s (every static shape routes as JAX's, padding rows
    included)."""
    jcfg = jax_tiny_config(attention="dense", max_seq_len=64, **moe_kw(top_k))
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1, 128, size=int(n)).astype(np.int32)
            for n in rng.integers(3, 25, size=5)]
    serve = dict(n_slots=3, block_len=8, prefill_chunk=8)

    def drain(s):
        rids = [s.submit(p, 6) for p in reqs]
        out = s.drain()
        return [[int(t) for t in out[r]] for r in rids]

    want = drain(JaxScheduler(jcfg, params, gather_impl="dense", **serve))
    s = Scheduler(tiny_config(max_seq_len=64, **moe_kw(top_k)),
                  params_from_jax(jax.tree.map(np.asarray, params)), device="cpu", **serve)
    assert drain(s) == want
    assert s.engine.allocator.in_use == 0


FULL_WIDTH = dict(vocab_size=32_000, num_layers=2, num_heads=12, embed_dim=768,
                  max_seq_len=2048, n_experts=8)  # moe_every 2, capacity 1.25


def mean_share(x):
    """The share of the rows' mean square that lies along their mean."""
    x = x.reshape(-1, x.shape[-1])
    return (x.mean(0).square().sum() / x.square().sum(-1).mean()).item()


@pytest.fixture(scope="module")
def full_width():
    """The full-width MoE LM (width 768, 12 heads, 8 experts in every
    second block, the 32,000-token vocabulary) cut to its first MoE block
    (block 1 of 2), fp32, weights ``init_params(seed=0)``; one batch of
    1 × 1024 tokens. Returns the flax tree, the tokens, the MoE layer's
    input and router logits and its drop share in the port's forward, and
    the mean-direction share of each part of that input."""
    cfg = tiny_config(**FULL_WIDTH)
    np_params = init_params(cfg, seed=0)
    model = TransformerLM(cfg)
    model.load_state_dict(params_from_jax(np_params))
    model.eval().requires_grad_(False)
    b0, b1 = model.blocks
    parts = {}

    def keep(name):
        return lambda mod, args, out: parts.setdefault(name, out)

    hooks = [b0.register_forward_pre_hook(lambda mod, args: parts.setdefault("embed", args[0])),
             b0.attn.register_forward_hook(keep("attn0")),
             b0.mlp_down.register_forward_hook(keep("mlp0")),
             b1.attn.register_forward_hook(keep("attn1")),
             b1.moe.register_forward_pre_hook(lambda mod, args: parts.setdefault("moe_in",
                                                                                 args[0]))]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 1024)).astype(np.int32)
    with torch.no_grad():
        model(torch.from_numpy(toks))
        logits = b1.moe.router(parts["moe_in"].reshape(-1, cfg.embed_dim))
    for h in hooks:
        h.remove()
    return dict(params=np_params, tokens=toks, logits=logits,
                dropped=b1.moe.dropped_frac.item(),
                shares={k: mean_share(v) for k, v in parts.items()})


@pytest.mark.parametrize("top_k", [1, 2])
def test_full_width_moe_routing_equals_topk_dispatch(full_width, top_k):
    """At the full width, on the router logits of the port's forward, the
    port's routes rebuild ``topk_dispatch``'s dispatch exactly, the aux
    loss to 1e-6 and the drop share exactly; JAX's own forward of the same
    weights and tokens drops the same share (to one token, 1/1024: its
    logits may round apart from the port's).

    It also pins down why most tokens are dropped at random weights: the
    embedding is small against block 0's MLP output, which carries the
    GELU's positive mean through ``mlp_down`` (a direction shared by every
    token); block 1's near-uniform causal attention averages the values
    over each prefix, so its output is almost all that shared direction.
    The router's input thus has a large share along the tokens' mean, its
    logits a per-expert offset common to all tokens, and a few experts take
    most first choices past their capacity of 1.25 T / E."""
    logits, t = full_width["logits"], full_width["logits"].shape[0]
    capacity = capacity_of(1.25, top_k, t, 8)
    want_d, _, want_aux, stats = topk_dispatch(jnp.asarray(logits.numpy()), capacity, k=top_k)
    routes = topk_routes(logits, capacity, top_k)
    got_d, _ = one_hot_of(routes, capacity, 8)
    np.testing.assert_array_equal(got_d, np.asarray(want_d))
    np.testing.assert_allclose(routes.aux.item(), float(want_aux), rtol=1e-6)
    assert routes.dropped_frac.item() == float(stats["dropped_frac"])
    if top_k == 1:
        assert routes.dropped_frac.item() == full_width["dropped"]
    jcfg = jax_tiny_config(attention="dense", moe_top_k=top_k, **FULL_WIDTH)
    _, mut = JaxLM(jcfg).apply({"params": full_width["params"]},
                               jnp.asarray(full_width["tokens"]), mutable=["moe_stats"])
    jax_dropped = float(jax.tree.leaves(mut["moe_stats"])[0])
    assert abs(jax_dropped - routes.dropped_frac.item()) <= 1 / t
    first = torch.bincount(routes.expert[:, 0], minlength=8).sort(descending=True).values / t
    shares = full_width["shares"]
    print(f"full width, top-{top_k}: dropped {routes.dropped_frac.item():.4f} (JAX's forward "
          f"{jax_dropped:.4f}); first-choice fractions {[round(float(f), 4) for f in first]}; "
          f"router logits' spread of per-expert means "
          f"{np.ptp(logits.mean(0).numpy()):.3f}, per-token std "
          f"{logits.std(0).mean().item():.3f}; mean-direction shares "
          f"{ {k: round(v, 4) for k, v in shares.items()} }")
    assert shares["embed"] < 0.01 and shares["attn1"] > 0.8 and shares["moe_in"] > 0.4
    assert first[:2].sum() > 0.8
    assert routes.dropped_frac.item() > (0.5 if top_k == 1 else 0.05)
