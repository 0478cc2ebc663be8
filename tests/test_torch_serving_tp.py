"""Serving under Megatron tensor parallelism in the port against the JAX
package's.

Two gloo ranks on the CPU at (dp, sp, tp) = (1, 1, 2), spawned once
(``tools/parallel_check.py``'s ``"serve"`` task, ``tools/serve_tp.py``),
run every case of the module; the JAX side runs on the conftest's virtual
CPU devices, over a 2-device mesh where it runs under TP. The tiny config
at 4 heads in fp32, the JAX initialisation's weights:

- ``generate_tp``, MHA and GQA + RoPE, greedy, token for token against
  JAX ``generate_tp`` (JAX ``tests/test_generate.py:122-190``); sampled at
  temperature 0.8, top-k 20, against the port's replicated ``generate``
  with the same seed (the draws are torch's, not ``jax.random``'s);
- ``generate_ragged_tp`` at ``num_kv_heads`` None and 2 and vocab-parallel
  against JAX ``generate_ragged_tp`` (``tests/test_serving_tp.py``);
- ``ContinuousBatcher(mesh=)`` in both layouts under the JAX test's
  ``_drive`` schedule against the JAX TP batcher
  (``test_batcher_tp_parity_vs_replicated``); the paged TP batcher at
  ``num_kv_heads`` None and 2 against the JAX replicated dense batcher
  (``tests/test_paged_serving.py:378``), also on the kernels' route and
  on int8 (``tests/test_paged_kernel.py:627``); on fp8 against the JAX
  one-device batcher on the same fp8 pool (``:667``; the dense gather,
  which JAX holds equal to its Pallas kernel on one pool dtype), greedy
  tokens equal and every step's logits to 1e-4 (the fp8 exponent caveat:
  XLA's CPU ``exp2`` is a few ulps off);
- ``Scheduler(mesh=)`` with the prefix cache on and off, a block-aligned
  twin taking the copy-on-write path (``tests/test_prefix.py:552``);
  after the same serve a rank's pool is its head slice of the replicated
  engine's; preemption by swap and by recompute streams what the
  replicated serve streams;
- a deadline serve with model rank 1's clock three times as fast as rank
  0's: both ranks retire the same requests with the same outcomes;
- JAX's validation messages, word for word, and the recipe's refusals;
- ``serve_lm --device cpu --tiny --tp 2`` (also ``--kv-dtype fp8
  --prefix-cache``) streams what ``--tp 1`` streams.

One torch thread (the ranks set theirs).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.parallel import make_mesh as jax_make_mesh
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu_torch.models import params_from_jax
from pytorch_distributed_tpu_torch.models.transformer import tiny_config
from pytorch_distributed_tpu_torch.parallel.mesh import AxisGroup, Mesh
from pytorch_distributed_tpu_torch.recipes import serve_lm
from pytorch_distributed_tpu_torch.serving import Scheduler
from pytorch_distributed_tpu_torch.tools import parallel_check

# the modules (each package's ``models`` exports the function ``generate``)
jax_gen = importlib.import_module("pytorch_distributed_tpu.models.generate")
port_gen = importlib.import_module("pytorch_distributed_tpu_torch.models.generate")

TP2 = dict(tp_size=2, model_axis="model")
#: the JAX serving tests' model (``tests/test_serving_tp.py``)
SERVE = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=32, max_seq_len=96,
             attention="dense")
#: ``tests/test_generate.py``'s: the tiny config at 32 positions, and its
#: GQA + RoPE variant
GEN = dict(vocab_size=128, num_layers=2, num_heads=2, embed_dim=32, max_seq_len=32,
           attention="dense")
GEN_GQA = dict(GEN, num_heads=4, num_kv_heads=2, pos_embedding="rope", max_seq_len=64)
#: the batchers' schedule: n_slots 2, chunks of 8
BATCH_KW = dict(n_slots=2, prefill_bucket=8)
SCHED_KW = dict(n_slots=2, block_len=8, prefill_chunk=16)
#: the fp8 pool's logits against the JAX one on the same pool dtype
FP8_LOGITS_ATOL = 1e-4
#: a rank's pool against its head slice of the replicated engine's, fp32:
#: the layers past the first see the tp_reduce's sum order
POOL_ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_weights(**over):
    """The JAX tests' weights: ``TransformerLM(cfg).init(key 0, zeros [1,
    8])``, and the port's state dict of them."""
    jcfg = jax_tiny_config(**over)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params))


def spec(over: dict, **tp) -> dict:
    return dict(over, dtype="float32", **tp)


def mesh2():
    return jax_make_mesh(jax.devices()[:2], data_parallel=1, seq_parallel=1,
                         model_parallel=2)


def prompts_of(seed, lengths, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lengths]


def shared_prompts():
    """Three prompts on one 16-token prefix (two blocks of 8), tails of 8
    and 9 tokens, and a block-aligned twin of the first (copy-on-write)."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, 128, (16,)).astype(np.int32)
    out = [np.concatenate([prefix, rng.integers(1, 128, (n,)).astype(np.int32)])
           for n in (8, 9)]
    return out + [out[0].copy()]


def weights_set():
    """Every model of the module: ``(JAX config, JAX params, port state
    dict)`` by name."""
    return {"serve": jax_weights(**SERVE),
            "serve_gqa": jax_weights(**SERVE, num_kv_heads=2),
            "gen": jax_weights(**GEN),
            "gen_gqa": jax_weights(**GEN_GQA)}


def cases(w) -> dict:
    gen_prompts = list(np.random.default_rng(0).integers(1, 128, (2, 12)).astype(np.int32))
    gqa_prompts = list(np.random.default_rng(4).integers(1, 128, (2, 7)).astype(np.int32))
    ragged = prompts_of(0, [5, 17, 32, 9])
    drive = prompts_of(2, (5, 11, 7, 3))
    paged = prompts_of(2, (5, 11, 7))
    fp8 = prompts_of(3, (5, 11, 7))
    serve = prompts_of(5, (9, 23, 14, 30, 6))
    sched = dict(kw=SCHED_KW, max_new=6)
    out = {
        "gen": dict(kind="generate", model=spec(GEN, **TP2), params=w["gen"][2],
                    prompts=gen_prompts, max_new=8),
        "gen_sampled": dict(kind="generate", model=spec(GEN, **TP2), params=w["gen"][2],
                            prompts=gen_prompts, max_new=8, reference=True,
                            kw=dict(temperature=0.8, top_k=20, seed=5)),
        "gen_gqa": dict(kind="generate", model=spec(GEN_GQA, **TP2), params=w["gen_gqa"][2],
                        prompts=gqa_prompts, max_new=8),
        "ragged": dict(kind="ragged", model=spec(SERVE, **TP2), params=w["serve"][2],
                       prompts=ragged, pad_to=32, max_new=8),
        "ragged_gqa": dict(kind="ragged", model=spec(SERVE, num_kv_heads=2, **TP2),
                           params=w["serve_gqa"][2], prompts=ragged, pad_to=32, max_new=8),
        "ragged_vocab": dict(kind="ragged", model=spec(SERVE, vocab_parallel=True, **TP2),
                             params=w["serve"][2], prompts=ragged[:2], pad_to=32, max_new=8),
        "batcher_dense": dict(kind="batcher", model=spec(SERVE, **TP2), params=w["serve"][2],
                              prompts=drive, max_new=6,
                              kw=dict(BATCH_KW, cache_layout="dense")),
        "batcher_paged": dict(kind="batcher", model=spec(SERVE, **TP2), params=w["serve"][2],
                              prompts=drive, max_new=6, kw=BATCH_KW),
        "paged": dict(kind="batcher", model=spec(SERVE, **TP2), params=w["serve"][2],
                      prompts=paged, max_new=6, kw=dict(BATCH_KW, gather_impl="dense")),
        "fp8": dict(kind="batcher", model=spec(SERVE, num_kv_heads=2, **TP2),
                    params=w["serve_gqa"][2], prompts=fp8, max_new=6, record=True,
                    kw=dict(BATCH_KW, kv_dtype="fp8")),
        "prefix_on": dict(model=spec(SERVE, **TP2), params=w["serve"][2],
                          prompts=shared_prompts(), stagger=3, max_new=5,
                          kw=dict(SCHED_KW, block_len=8, prefix_cache=True)),
        "prefix_off": dict(model=spec(SERVE, **TP2), params=w["serve"][2],
                           prompts=shared_prompts(), stagger=3, max_new=5, kw=SCHED_KW),
        "pool": dict(sched, model=spec(SERVE, num_kv_heads=2, **TP2), params=w["serve_gqa"][2],
                     prompts=serve, pool=True, reference=True),
        "swap": dict(model=spec(SERVE, **TP2), params=w["serve"][2], prompts=serve,
                     max_new=12, reference=True,
                     kw=dict(SCHED_KW, n_blocks=9, offload=True, preempt_on_oom=True,
                             swap_policy="swap")),
        "recompute": dict(model=spec(SERVE, **TP2), params=w["serve"][2], prompts=serve,
                          max_new=12, reference=True,
                          kw=dict(SCHED_KW, n_blocks=9, offload=True, preempt_on_oom=True,
                                  swap_policy="recompute")),
        "deadline": dict(model=spec(SERVE, **TP2), params=w["serve"][2], prompts=serve,
                         max_new=10, kw=SCHED_KW, deadlines=[0.012, None, 0.03, 0.06, 0.02],
                         clock={"dt": [0.001, 0.003]}),
    }
    for kv, kv_dtype in ((None, None), (2, None), (2, "int8")):
        w_ = w["serve"] if kv is None else w["serve_gqa"]
        model = spec(SERVE, num_kv_heads=kv, **TP2) if kv else spec(SERVE, **TP2)
        out[f"kernel_{kv}_{kv_dtype}"] = dict(
            kind="batcher", model=model, params=w_[2], prompts=paged, max_new=6,
            kw=dict(BATCH_KW, gather_impl="kernel", kv_dtype=kv_dtype))
    out["paged_gqa"] = dict(kind="batcher", model=spec(SERVE, num_kv_heads=2, **TP2),
                            params=w["serve_gqa"][2], prompts=paged, max_new=6,
                            kw=dict(BATCH_KW, gather_impl="dense"))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every case on one spawn of two gloo ranks; ``(weights, cases,
    results by rank)``."""
    tmp = tmp_path_factory.mktemp("serve_tp")
    w = weights_set()
    cs = cases(w)
    job = dict(task="serve", backend="gloo", device="cpu", mp=2, timeout_s=120,
               rendezvous=f"file://{tmp}/rendezvous", out=str(tmp / "out"), cases=cs)
    parallel_check.run(job, 2)
    return w, cs, parallel_check.load(job)


def both(run, name):
    """Case ``name``'s result on each rank; the ranks' streams are equal."""
    _, _, res = run
    a, b = res[0][name], res[1][name]
    sa, sb = a["streams"], b["streams"]
    assert (torch.equal(sa, sb) if torch.is_tensor(sa) else sa == sb), name
    return a, b


def jax_drive(batcher, prompts, budget, logits=None):
    """The JAX tests' ``_drive``: submit while a slot is free, then step;
    ``{request: [tokens]}`` (and before each step the logits rows of the
    slots it decodes into ``logits``, as ``(slots, rows)``)."""
    produced, pending, slot_req = {}, list(enumerate(prompts)), {}
    while pending or any(batcher.remaining > 0):
        while pending and batcher.free_slots():
            req, p = pending.pop(0)
            slot_req[batcher.submit(p, budget)] = req
            produced[req] = []
        if logits is not None:
            live = np.nonzero(np.asarray(batcher.remaining) > 0)[0]
            logits.append((live, np.asarray(batcher.logits)[live]))
        for slot, tok in batcher.step():
            produced[slot_req[slot]].append(tok)
    return produced


_dense_refs = {}


def jax_dense(w, name, prompts):
    """The JAX replicated dense batcher's streams of ``prompts`` (budget
    6) on weights ``name``, computed once a module."""
    key = (name, tuple(map(tuple, prompts)))
    if key not in _dense_refs:
        jcfg, jparams, _ = w[name]
        dense = jax_gen.ContinuousBatcher(jcfg, jparams, cache_layout="dense", **BATCH_KW)
        _dense_refs[key] = jax_drive(dense, prompts, 6)
    return _dense_refs[key]


# ---- generate_tp and generate_ragged_tp ----

@pytest.mark.parametrize("name,weights,jax_over", [
    ("gen", "gen", GEN), ("gen_gqa", "gen_gqa", GEN_GQA)])
def test_generate_tp_matches_jax_generate_tp(run, name, weights, jax_over):
    a, _ = both(run, name)
    w, cs, _ = run
    jcfg = dataclasses.replace(w[weights][0], **TP2)
    want = jax_gen.generate_tp(mesh2(), jcfg, w[weights][1], jnp.asarray(np.stack(
        cs[name]["prompts"])), jax.random.key(5), max_new_tokens=8, temperature=0.0)
    np.testing.assert_array_equal(a["streams"].numpy(), np.asarray(want))


def test_sampled_generate_tp_matches_the_replicated_port(run):
    a, _ = both(run, "gen_sampled")
    assert torch.equal(a["streams"], a["reference"]["streams"])


@pytest.mark.parametrize("name", ["ragged", "ragged_gqa", "ragged_vocab"])
def test_generate_ragged_tp_matches_jax(run, name):
    a, _ = both(run, name)
    w, cs, _ = run
    c = cs[name]
    jcfg = dataclasses.replace(w["serve" if name != "ragged_gqa" else "serve_gqa"][0], **TP2,
                               vocab_parallel=name == "ragged_vocab")
    params = w["serve" if name != "ragged_gqa" else "serve_gqa"][1]
    prompts = np.zeros((len(c["prompts"]), 32), np.int32)
    for i, p in enumerate(c["prompts"]):
        prompts[i, :len(p)] = p
    lengths = jnp.asarray([len(p) for p in c["prompts"]], jnp.int32)
    want = jax_gen.generate_ragged_tp(mesh2(), jcfg, params, jnp.asarray(prompts), lengths,
                                      jax.random.key(1), max_new_tokens=8)
    np.testing.assert_array_equal(a["streams"].numpy(), np.asarray(want))


# ---- ContinuousBatcher(mesh=) ----

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_batcher_tp_matches_the_jax_tp_batcher(run, layout):
    """The JAX test's schedule (slot retirement and reuse) in both
    layouts, against the JAX TP batcher; a rank's cache holds half the
    heads."""
    a, b = both(run, f"batcher_{layout}")
    w, cs, _ = run
    jcfg, jparams, _ = w["serve"]
    tp = jax_gen.ContinuousBatcher(dataclasses.replace(jcfg, **TP2), jparams, n_slots=2,
                                   prefill_bucket=8, mesh=mesh2())
    assert a["streams"] == jax_drive(tp, cs[f"batcher_{layout}"]["prompts"], 6)
    full = sum(np.asarray(x).nbytes for x in jax.tree.leaves(tp.cache))
    if layout == "paged":
        assert a["pool_bytes"] == b["pool_bytes"] == full // 2


@pytest.mark.parametrize("name,kv", [("paged", None), ("paged_gqa", 2)])
def test_paged_batcher_tp_matches_dense(run, name, kv):
    """``tests/test_paged_serving.py:378``: the paged TP batcher against
    the JAX replicated dense batcher."""
    a, _ = both(run, name)
    w, cs, _ = run
    assert a["streams"] == jax_dense(w, "serve" if kv is None else "serve_gqa",
                                     cs[name]["prompts"])


@pytest.mark.parametrize("kv,kv_dtype", [(None, None), (2, None), (2, "int8")])
def test_kernel_batcher_tp_matches_dense(run, kv, kv_dtype):
    """``tests/test_paged_kernel.py:627``: the kernels' route (on the CPU
    their plain versions) under TP, the int8 pool's scales head-sharded
    too, against the JAX replicated dense batcher."""
    a, _ = both(run, f"kernel_{kv}_{kv_dtype}")
    w, cs, _ = run
    assert a["streams"] == jax_dense(w, "serve" if kv is None else "serve_gqa",
                                     cs[f"kernel_{kv}_{kv_dtype}"]["prompts"])


def test_fp8_batcher_tp_matches_the_jax_one_device_fp8_batcher(run):
    """``tests/test_paged_kernel.py:667``: the fp8 pool (e4m3 codes, int8
    exponents, both head-sharded) under TP against one JAX device on the
    same pool dtype: the same greedy tokens, every step's logits to
    ``FP8_LOGITS_ATOL``."""
    a, _ = both(run, "fp8")
    w, cs, _ = run
    jcfg, jparams, _ = w["serve_gqa"]
    one = jax_gen.ContinuousBatcher(jcfg, jparams, gather_impl="dense", kv_dtype="fp8",
                                    **BATCH_KW)
    logits = []
    assert a["streams"] == jax_drive(one, cs["fp8"]["prompts"], 6, logits)
    got = a["logits"]
    assert len(got) == len(logits)
    for g, (live, want) in zip(got, logits):
        np.testing.assert_allclose(g.numpy()[live], want, rtol=0, atol=FP8_LOGITS_ATOL)


# ---- Scheduler(mesh=) ----

def test_prefix_tp2_token_identity(run):
    """``tests/test_prefix.py:552``: sharing on and off under TP stream
    the same tokens, with hits and a copy-on-write; the JAX replicated
    scheduler streams them too."""
    on, _ = both(run, "prefix_on")
    off, _ = both(run, "prefix_off")
    assert on["streams"] == off["streams"]
    assert on["metrics"]["prefix_hits"] >= 2
    assert on["metrics"]["prefix_cow_copies"] >= 1
    w, cs, _ = run
    jcfg, jparams, _ = w["serve"]
    js = JaxScheduler(jcfg, jparams, n_slots=2, block_len=8, prefill_chunk=16)
    want = {}
    for p in cs["prefix_off"]["prompts"]:
        want[js.submit(p, 5)] = []
        for _ in range(3):
            for rid, tok in js.step():
                want[rid].append(tok)
    for rid, toks in js.drain().items():
        want[rid].extend(toks)
    assert off["streams"] == want


def test_a_ranks_pool_is_its_head_slice_of_the_replicated_pool(run):
    """After the same serve, each rank's K/V pools (GQA, 2 KV heads) are
    its head of the replicated engine's, and hold half its bytes."""
    a, b = both(run, "pool")
    ref = a["reference"]
    assert a["streams"] == ref["streams"]
    assert a["pool_bytes"] == b["pool_bytes"] == ref["pool_bytes"] // 2
    for r, res in enumerate((a, b)):
        for got, want in zip(res["pool"], ref["pool"]):
            np.testing.assert_allclose(got.numpy(), want[:, :, r:r + 1].numpy(), rtol=0,
                                       atol=POOL_ATOL)


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_a_preempting_serve_streams_the_replicated_serve(run, policy):
    a, b = both(run, policy)
    ref = a["reference"]
    assert a["streams"] == ref["streams"]
    assert a["metrics"]["preempts"] == b["metrics"]["preempts"] >= 1
    assert a["metrics"][f"decision_{policy}"] >= 1
    assert a["in_use"] == b["in_use"] == 0


def test_a_skewed_clock_changes_no_ranks_decisions(run):
    """Rank 1's clock runs three times as fast as rank 0's: the deadline
    sweep is rank 0's, so both ranks expire the same requests at the same
    tick and stream the same tokens."""
    a, b = both(run, "deadline")
    assert a["outcomes"] == b["outcomes"]
    assert set(a["outcomes"].values()) == {"complete", "deadline"}
    assert a["metrics"]["deadline_misses"] == b["metrics"]["deadline_misses"] >= 1


# ---- validations and the recipe ----

def port_mesh(model: int) -> Mesh:
    one = AxisGroup(None, 1, 0)
    return Mesh(one, one, AxisGroup(None, model, 0))


@pytest.mark.parametrize("what", ["mesh without axis", "tp without mesh", "size"])
def test_validation_messages_are_jaxs(what):
    rep, jrep = tiny_config(attention="dense"), jax_tiny_config(attention="dense")
    tp, jtp = (dataclasses.replace(c, **TP2) for c in (rep, jrep))
    args = {"mesh without axis": ((rep, port_mesh(2)), (jrep, mesh2())),
            "tp without mesh": ((tp, None), (jtp, None)),
            "size": ((tp, port_mesh(1)), (jtp, jax_make_mesh(jax.devices()[:1], 1)))}[what]
    with pytest.raises(ValueError) as got:
        port_gen._validate_serving_config(*args[0])
    with pytest.raises(ValueError) as want:
        jax_gen._validate_serving_config(*args[1])
    assert str(got.value) == str(want.value)


def test_entry_points_refuse_as_jaxs():
    rep = tiny_config(attention="dense", max_seq_len=32)
    tp = dataclasses.replace(rep, **TP2)
    prompt = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="replicated"):
        port_gen.generate(tp, {}, prompt, 2, device="cpu")
    with pytest.raises(ValueError, match="TP config"):
        port_gen.generate_tp(port_mesh(2), rep, {}, prompt, 2, device="cpu")
    with pytest.raises(ValueError, match="tp_size"):
        port_gen.generate_tp(port_mesh(1), tp, {}, prompt, 2, device="cpu")
    with pytest.raises(ValueError, match="TP config"):
        port_gen.generate_ragged_tp(port_mesh(2), rep, {}, prompt, [4], 2, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        port_gen.ContinuousBatcher(tp, {}, n_slots=2, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        Scheduler(tp, {}, n_slots=2, device="cpu")


@pytest.mark.parametrize("flags,words", [
    (["--tp", "2", "--dense"], "--tp > 1 needs the paged layout; drop --dense"),
    (["--tp", "2", "--replicas", "2"],
     "fleet replicas are single-device in this round; drop --tp or --replicas"),
    (["--vocab-parallel"], "--vocab-parallel needs --tp > 1"),
    (["--tp", "2", "--device", "cuda"], "needs a card per rank"),
])
def test_the_recipe_refuses(flags, words):
    argv = ["--tiny", *(["--device", "cpu"] if "--device" not in flags else []), *flags]
    if "cuda" in flags and torch.cuda.device_count() >= 2:
        pytest.skip("two cards are visible: --tp 2 is served, not refused")
    with pytest.raises(SystemExit, match=words):
        serve_lm.main(argv)


@pytest.mark.parametrize("extra", [[], ["--kv-dtype", "fp8", "--prefix-cache"]])
def test_the_recipe_streams_at_tp2_what_it_streams_at_tp1(extra):
    base = ["--device", "cpu", "--tiny", "--requests", "4", "--max-new", "6", *extra]
    one = serve_lm.main(base)
    two = serve_lm.main([*base, "--tp", "2"])
    assert two["streams_sha256"] == one["streams_sha256"]
    assert two["ranks_equal"] and two["tp"] == 2
    assert two["pool_bytes"] * 2 == one["pool_bytes"]
