"""Megatron tensor parallelism in the port against the JAX package's.

Gloo ranks on the CPU (``tools/parallel_check.py``: one spawn of two
ranks at (dp, sp, tp) = (1, 1, 2) running every case, one of four ranks
at (2, 1, 2) and (1, 2, 2)) against JAX ``make_lm_train_step`` over
meshes of the virtual CPU devices of the same shape (``tests/test_tp.py``
builds its runs the same way), the tiny config at 4 heads in fp32, from
the JAX weights, on the same global batches:

- ``tp_copy`` / ``tp_reduce`` / ``tp_all_gather``: values and gradients
  against the JAX custom vjps under ``shard_map``;
- the placement rules claim the leaves JAX
  ``test_partition_rules_shard_expected_leaves`` names, and a rank's
  ``qkv`` part holds its heads of q, of k and of v;
- three steps at (1, 1, 2), (2, 1, 2) and (1, 2, 2) with the ring, and GQA
  at 2 K/V heads: losses and grad norms (clip 1.0) to 1e-5 relative, the
  gathered parameters to 2e-5 (the attention key bias, whose gradient is
  rounding noise that AdamW scales to ~lr a step, to 3 lr), and the
  port's one-rank step alike;
- dropout draws one mask on both model ranks: the TP run equals the
  one-rank run with the same seed;
- a NaN planted in one TP part's gradient on model rank 1 makes
  ``nan_guard`` skip the update on both ranks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.ops.optim import build_optimizer as jax_build_optimizer
from pytorch_distributed_tpu.ops.schedules import warmup_cosine as jax_warmup_cosine
from pytorch_distributed_tpu.parallel import make_mesh
from pytorch_distributed_tpu.parallel.mesh import shard_map
from pytorch_distributed_tpu.parallel.tensor import match_partition_rules as jax_match
from pytorch_distributed_tpu.parallel.tensor import path_str
from pytorch_distributed_tpu.parallel.tensor import tp_all_gather as jax_tp_all_gather
from pytorch_distributed_tpu.parallel.tensor import tp_copy as jax_tp_copy
from pytorch_distributed_tpu.parallel.tensor import tp_reduce as jax_tp_reduce
from pytorch_distributed_tpu.train import lm as jax_lm
from pytorch_distributed_tpu.train.lm_trainer import shard_lm_batch as jax_shard_lm_batch
from pytorch_distributed_tpu_torch.models import params_from_jax, params_to_jax, tiny_config
from pytorch_distributed_tpu_torch.models.convert import tp_join, tp_parts
from pytorch_distributed_tpu_torch.ops.schedules import warmup_cosine
from pytorch_distributed_tpu_torch.tools import parallel_check
from pytorch_distributed_tpu_torch.train import create_lm_state, lm_collate, make_lm_train_step
from pytorch_distributed_tpu_torch.train.lm import tp_layout

SEQ, BATCH, VOCAB = 16, 4, 128
SCHED = (3e-4, 100, 0, 3e-4)  # warmup_cosine: lr 3e-4 throughout the three steps
LR = SCHED[0]
MODEL = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, embed_dim=32, max_seq_len=SEQ,
             dtype="float32", attention="dense")
TP2 = dict(tp_size=2, model_axis="model")
GQA = dict(num_kv_heads=2, pos_embedding="rope")


def lm_batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [lm_collate(list(rng.integers(1, VOCAB, (BATCH, SEQ)).astype(np.int32)))
            for _ in range(n)]


def as_np(tree):
    return jax.tree.map(lambda x: np.array(jax.device_get(x)), tree)


def jax_cfg(attention="dense", tp=2, **kw):
    return jax_tiny_config(**dict(dict(attention=attention, max_seq_len=SEQ, num_heads=4,
                                       model_axis="model" if tp > 1 else None, tp_size=tp),
                                  **kw))


def jax_state(cfg):
    tx = jax_build_optimizer("adamw", jax_warmup_cosine(*SCHED), weight_decay=0.1)
    return jax_lm.create_lm_state(cfg, tx, jax.random.key(0), init_len=SEQ)


def jax_init(**kw):
    return params_from_jax(as_np(jax_state(jax_cfg(tp=1, **kw)).params))


@functools.lru_cache(maxsize=None)
def jax_run(dp: int, sp: int, gqa: bool = False):
    """JAX TP at (dp, sp, 2): three steps (clip 1.0) and the parameters."""
    kw = GQA if gqa else {}
    cfg = jax_cfg("ring" if sp > 1 else "dense", **kw)
    mesh = make_mesh(jax.devices()[:dp * sp * 2], data_parallel=dp, seq_parallel=sp,
                     model_parallel=2)
    state, specs = jax_lm.shard_lm_state(mesh, jax_state(cfg), cfg)
    step = jax_lm.make_lm_train_step(mesh, state_specs=specs, config=cfg, grad_clip_norm=1.0)
    metrics = []
    for b in lm_batches():
        state, m = step(state, jax_shard_lm_batch(mesh, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, as_np(state.params)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spawn(tmp, job: dict):
    job = dict(job, backend="gloo", rendezvous=f"file://{tmp}/rendezvous", out=str(tmp / "out"),
               device="cpu", timeout_s=120)
    parallel_check.run(job, parallel_check.world(job))
    return parallel_check.load(job)


@pytest.fixture(scope="module")
def port_tp2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp2")
    init, init_gqa = jax_init(), jax_init(**GQA)
    cases = {
        "mha": dict(model=dict(MODEL, **TP2), mode="replicated", clip=1.0, params=init),
        "gqa": dict(model=dict(MODEL, **TP2, **GQA), mode="replicated", clip=1.0,
                    params=init_gqa),
        "dropout": dict(model=dict(MODEL, **TP2, dropout=0.1), mode="replicated",
                        params=init, dropout_seed=7),
        "nan": dict(model=dict(MODEL, **TP2), mode="replicated", params=init,
                    nan_guard=True, plant=(1, float("nan"))),
    }
    rng = np.random.default_rng(4)
    ops = dict(task="tp_ops", x=rng.standard_normal((2, 3, 8)).astype(np.float32),
               cot={"copy": rng.standard_normal((2, 3, 8)).astype(np.float32),
                    "reduce": rng.standard_normal((2, 3, 8)).astype(np.float32),
                    "gather": rng.standard_normal((2, 3, 16)).astype(np.float32)},
               ce=dict(x=rng.standard_normal((20, 8)).astype(np.float32),
                       w=(0.3 * rng.standard_normal((12, 8))).astype(np.float32),
                       labels=rng.integers(0, 12, 20).astype(np.int64),
                       weights=(rng.random(20) > 0.2).astype(np.float32), block_n=8))
    jobs = {"lm": dict(task="lm", cases=cases, batches=lm_batches(), schedule=SCHED),
            "ops": ops}
    return spawn(tmp, dict(task="many", jobs=jobs, mp=2)), ops


@pytest.fixture(scope="module")
def port_tp4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp4")
    init = jax_init()
    jobs = {
        "dp2": dict(task="lm", dp=2, sp=1, mp=2, batches=lm_batches(), schedule=SCHED, cases={
            "mha": dict(model=dict(MODEL, **TP2), mode="replicated", clip=1.0, params=init)}),
        "sp2": dict(task="lm", dp=1, sp=2, mp=2, batches=lm_batches(), schedule=SCHED, cases={
            "mha": dict(model=dict(MODEL, **TP2, attention="ring"), mode="replicated",
                        clip=1.0, params=init)}),
    }
    return spawn(tmp, dict(task="many", jobs=jobs, dp=2, mp=2))


@functools.lru_cache(maxsize=None)
def port_one_rank(kind: str):
    """The port's one-device steps from the JAX weights (clip 1.0, or the
    dropout case's seed)."""
    kw = dict(GQA) if kind == "gqa" else dict(dropout=0.1) if kind == "dropout" else {}
    cfg = tiny_config(attention="dense", max_seq_len=SEQ, num_heads=4, **kw)
    init = jax_init(**GQA) if kind == "gqa" else jax_init()
    state = create_lm_state(cfg, lr_schedule=warmup_cosine(*SCHED), weight_decay=0.1,
                            params=init, device="cpu")
    step = make_lm_train_step(grad_clip_norm=0.0 if kind == "dropout" else 1.0, config=cfg,
                              dropout_seed=7)
    metrics = []
    for b in lm_batches():
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def assert_params_close(got: dict, want: dict, atol: float = 2e-5,
                        key_bias_atol: float = 3 * LR):
    """Flax trees leaf by leaf to ``atol``, the attention's key bias (MHA's
    qkv bias [1], GQA's kv bias [0]) to ``key_bias_atol``."""
    got, want = jax.tree.map(np.array, got), jax.tree.map(np.array, want)
    for p in (got, want):
        for name, block in p.items():
            if not name.startswith("block"):
                continue
            attn = block["attn"]
            src = attn["qkv"]["bias"][1] if "qkv" in attn else attn["kv"]["bias"][0]
            p[name]["k_bias"] = {"value": src.copy()}
            src[...] = 0.0
    fg, tg = jax.tree_util.tree_flatten_with_path(got)
    fw, tw = jax.tree_util.tree_flatten_with_path(want)
    assert tg == tw
    for (path, a), (_, b) in zip(fg, fw):
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(a, b, rtol=0, err_msg=name,
                                   atol=key_bias_atol if "k_bias" in name else atol)


def close_metrics(got: dict, want: list, keys=("loss", "grad_norm", "tokens")):
    for i, w in enumerate(want):
        for k in keys:
            np.testing.assert_allclose(got[k][i], w[k], rtol=1e-5, err_msg=f"{k}@{i}")


# ---- the collectives ----

def jax_ops(ops: dict) -> dict:
    """The JAX f / g / gather and vocab-parallel fused CE on 2 devices."""
    from pytorch_distributed_tpu.ops.fused_ce import fused_linear_cross_entropy

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("model",))
    spec = P("model")
    out = {}
    for name, op in (("copy", jax_tp_copy), ("reduce", jax_tp_reduce),
                     ("gather", jax_tp_all_gather)):
        def local(x, cot, op=op):
            y = op(x[0], "model")
            dx = jax.grad(lambda x: jnp.sum(op(x[0], "model") * cot[0]))(x)
            return y[None], dx

        f = shard_map(local, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                      check_vma=False)
        y, dx = f(jnp.asarray(ops["x"]), jnp.asarray(ops["cot"][name]))
        out[name] = (np.asarray(y), np.asarray(dx))
    ce = ops["ce"]

    def loss_fn(x, kernel):
        return fused_linear_cross_entropy(x, kernel, jnp.asarray(ce["labels"]),
                                          jnp.asarray(ce["weights"]), block_n=ce["block_n"],
                                          compute_dtype=jnp.float32, vocab_axis="model")

    def local_ce(x, kernel):
        loss, (dx, dk) = jax.value_and_grad(loss_fn, argnums=(0, 1))(x, kernel)
        return loss[None], dx[None], dk

    f = shard_map(local_ce, mesh=mesh, in_specs=(P(), P(None, "model")),
                  out_specs=(spec, spec, P(None, "model")), check_vma=False)
    loss, dx, dk = f(jnp.asarray(ce["x"]), jnp.asarray(ce["w"].T))
    out["ce"] = (np.asarray(loss), np.asarray(dx), np.asarray(dk))
    return out


def test_tp_collectives_match_jax_custom_vjps(port_tp2):
    results, ops = port_tp2
    want = jax_ops(ops)
    for r in (0, 1):
        got = results[r]["ops"]
        for name in ("copy", "reduce", "gather"):
            y, dx = got[name]
            np.testing.assert_allclose(y.numpy(), want[name][0][r], rtol=1e-6, atol=1e-6,
                                       err_msg=name)
            np.testing.assert_allclose(dx.numpy(), want[name][1][r], rtol=1e-6, atol=1e-6,
                                       err_msg=name)


def test_vocab_parallel_fused_ce_matches_jax(port_tp2):
    """``fused_linear_cross_entropy(vocab_axis=)`` on 2 ranks against the
    JAX one: the loss and dx the same on both ranks, each rank's dW its
    rows of JAX's ``[E, V]`` kernel gradient."""
    results, ops = port_tp2
    loss, dx, dk = jax_ops(ops)["ce"]
    n = ops["ce"]["w"].shape[0] // 2
    for r in (0, 1):
        got_loss, got_dx, got_dw = results[r]["ops"]["ce"]
        np.testing.assert_allclose(got_loss, loss[r], rtol=1e-6)
        np.testing.assert_allclose(got_dx.numpy(), dx[r], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_dw.numpy(), dk[:, r * n:(r + 1) * n].T, rtol=1e-5,
                                   atol=1e-6)


# ---- the placement rules ----

def _torch_name(path: str):
    """A flax parameter path's port state-dict name (the leaves the rules
    cover)."""
    parts = path.split("/")
    leaf = {"kernel": "weight", "bias": "bias", "scale": "weight", "embedding": "weight"}
    if parts[0].startswith("block"):
        return ".".join(["blocks", parts[0][5:], *parts[1:-1], leaf[parts[-1]]])
    return f"{parts[0]}.{leaf[parts[-1]]}"


@pytest.mark.parametrize("gqa", [False, True])
def test_rules_claim_the_leaves_jax_shards(gqa):
    """Every leaf of the tiny LM: the port's rule claims it iff the JAX
    ``TRANSFORMER_TP_RULES`` spec names the model axis
    (``test_partition_rules_shard_expected_leaves``: qkv and mlp_up
    kernels sharded, ln1 and wte whole)."""
    params = jax_state(jax_cfg(tp=1, **(GQA if gqa else {}))).params
    specs = jax_match(jax_lm.TRANSFORMER_TP_RULES, params)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    shapes = {n: tuple(v.shape) for n, v in params_from_jax(as_np(params)).items()}
    claimed = tp_layout(tiny_config(num_heads=4, **TP2, **(GQA if gqa else {})), shapes, 0,
                        (0, 1))
    seen = set()
    for path, spec in flat:
        name = _torch_name(path_str(path))
        seen.add(name)
        assert (name in claimed) == ("model" in str(spec)), (name, spec)
    assert seen == set(shapes)
    assert "blocks.0.attn.qkv.weight" in claimed or gqa
    assert "blocks.0.mlp_up.weight" in claimed and "blocks.0.ln1.weight" not in claimed
    assert "wte.weight" not in claimed


def test_a_ranks_qkv_part_holds_its_heads_of_q_k_and_v():
    """Rank r of T 2: its ``qkv`` rows are heads [2r, 2r + 2) of q, of k and
    of v (the JAX kernel ``[E, 3, H, D]`` cut on H); its ``proj`` columns
    and ``mlp_up`` rows its slice; ``tp_join`` puts the ranks' parts back."""
    params = as_np(jax_state(jax_cfg(tp=1)).params)
    sd = params_from_jax(params)
    cfg = tiny_config(num_heads=4, **TP2)
    shapes = {n: tuple(v.shape) for n, v in sd.items()}
    layouts = [tp_layout(cfg, shapes, r, (0, 1)) for r in (0, 1)]
    parts = [tp_parts(sd, lay) for lay in layouts]
    kernel = params["block0"]["attn"]["qkv"]["kernel"]  # [E, 3, H, D]
    for r in (0, 1):
        want = kernel[:, :, 2 * r:2 * r + 2].reshape(32, -1).T
        np.testing.assert_array_equal(parts[r]["blocks.0.attn.qkv.weight"].numpy(), want)
        proj = params["block0"]["attn"]["proj"]["kernel"]  # [H, D, E]
        np.testing.assert_array_equal(parts[r]["blocks.0.attn.proj.weight"].numpy(),
                                      proj[2 * r:2 * r + 2].reshape(-1, 32).T)
        up = params["block0"]["mlp_up"]["kernel"]  # [E, 4E]
        np.testing.assert_array_equal(parts[r]["blocks.0.mlp_up.weight"].numpy(),
                                      up[:, 64 * r:64 * (r + 1)].T)
    joined = tp_join(parts, layouts)
    for k, v in sd.items():
        assert torch.equal(joined[k], v), k


# ---- the train steps ----

@pytest.mark.parametrize("kind", ["mha", "gqa"])
def test_tp2_steps_match_jax_and_one_rank(port_tp2, kind):
    results, _ = port_tp2
    want, want_params = jax_run(1, 1, gqa=kind == "gqa")
    one, one_params = port_one_rank(kind)
    cfg = tiny_config(max_seq_len=SEQ, num_heads=4, **(GQA if kind == "gqa" else {}))
    for r in results:
        got = r["lm"][kind]["metrics"]
        close_metrics(got, want)
        close_metrics(got, one)
        assert r["lm"][kind]["step"] == 3
    got_params = params_to_jax(results[0]["lm"][kind]["params"], cfg)
    assert_params_close(got_params, want_params)
    assert_params_close(got_params, params_to_jax(one_params, cfg))


@pytest.mark.parametrize("grid", ["dp2", "sp2"])
def test_tp_over_data_and_seq_matches_jax(port_tp4, grid):
    """(2, 1, 2) and (1, 2, 2) with the ring: four ranks against JAX on the
    same mesh shape."""
    want, want_params = jax_run(2, 1) if grid == "dp2" else jax_run(1, 2)
    for r in port_tp4:
        close_metrics(r[grid]["mha"]["metrics"], want)
    cfg = tiny_config(max_seq_len=SEQ, num_heads=4)
    assert_params_close(params_to_jax(port_tp4[0][grid]["mha"]["params"], cfg), want_params)


def test_dropout_draws_one_mask_on_both_model_ranks(port_tp2):
    """TP's residual dropout comes after ``tp_reduce`` with the (seed,
    step, shard) generator, which leaves out the model coordinate: both
    ranks report the same losses, and the run is the one-rank run's."""
    results, _ = port_tp2
    one, one_params = port_one_rank("dropout")
    r0, r1 = (r["lm"]["dropout"]["metrics"] for r in results)
    assert r0["loss"] == r1["loss"]
    close_metrics(r0, one, keys=("loss", "tokens"))
    cfg = tiny_config(max_seq_len=SEQ, num_heads=4, dropout=0.1)
    assert_params_close(params_to_jax(results[0]["lm"]["dropout"]["params"], cfg),
                        params_to_jax(one_params, cfg))


def test_a_nan_on_one_model_rank_vetoes_the_update_on_both(port_tp2):
    results, _ = port_tp2
    for r in results:
        m = r["lm"]["nan"]["metrics"]
        assert m["step_good"] == [1.0, 0.0, 1.0]
        assert all(np.isfinite(m["loss"]))
    # both ranks skipped step 1 alike: the same losses after it
    assert results[0]["lm"]["nan"]["metrics"]["loss"] == results[1]["lm"]["nan"]["metrics"]["loss"]
