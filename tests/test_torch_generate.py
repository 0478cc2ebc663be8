"""The port's dense decode path against the JAX package's
``models/generate.py``.

The dense cache's one-token decode reproduces the full causal forward
position by position (as JAX ``tests/test_generate.py:24`` holds it);
``generate`` and ``generate_ragged`` give the JAX functions' greedy
tokens; ``ContinuousBatcher`` in both layouts gives the JAX batcher's
events for the same submits, EOS retirement included (JAX
``tests/test_serving.py:44-140``); the validations raise as the JAX ones
do; and ``serve_lm --dense`` serves on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import generate as jax_generate
from pytorch_distributed_tpu.models.generate import ContinuousBatcher as JaxBatcher
from pytorch_distributed_tpu.models.generate import generate_ragged as jax_generate_ragged
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu_torch.models import generate, params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.models.generate import (
    ContinuousBatcher,
    generate_ragged,
    init_cache,
    ragged_decode_step,
    ragged_prefill,
)
from pytorch_distributed_tpu_torch.models.transformer import TransformerLM
from pytorch_distributed_tpu_torch.recipes import serve_lm

MAX_SEQ = 64


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def model(weights):
    m = TransformerLM(tiny_config(max_seq_len=MAX_SEQ))
    m.load_state_dict(weights[2])
    return m.eval().requires_grad_(False)


def cfg():
    return tiny_config(max_seq_len=MAX_SEQ)


def tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(1, 128, shape).astype(np.int32)


@torch.no_grad()
def test_dense_decode_matches_full_forward(weights, model):
    """One token at a time through the cache: the full causal forward's
    logits at every position, the port's and the JAX module's."""
    jcfg, jparams, _ = weights
    toks = tokens((2, 12))
    full = model(torch.as_tensor(toks).long()).numpy()
    jfull = np.asarray(JaxLM(jcfg).apply({"params": jparams}, jnp.asarray(toks), train=False))
    cache = init_cache(cfg(), 2, device="cpu")
    stepped = np.stack([model(torch.as_tensor(toks[:, t:t + 1]).long(), t, cache=cache,
                              decode=True)[:, 0].numpy() for t in range(12)], axis=1)
    np.testing.assert_allclose(stepped, full, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(stepped, jfull, rtol=2e-4, atol=2e-5)


@torch.no_grad()
def test_prefill_then_per_request_decode_matches_full_forward(model):
    """A prefill writes the prompt's rows; a ``[B]`` offset then decodes
    each row from its own position, as ``generate_ragged`` does."""
    toks = tokens((2, 10), seed=1)
    full = model(torch.as_tensor(toks).long()).numpy()
    cache = init_cache(cfg(), 2, device="cpu")
    pre = model(torch.as_tensor(toks[:, :6]).long(), 0, cache=cache).numpy()
    np.testing.assert_allclose(pre, full[:, :6], rtol=2e-4, atol=2e-5)
    # row 0 decodes position 6, row 1 re-writes and decodes position 5
    pos = torch.tensor([6, 5])
    out = model(torch.as_tensor(toks[[0, 1], [6, 5]][:, None]).long(), pos, cache=cache,
                decode=True)[:, 0].numpy()
    np.testing.assert_allclose(out, full[[0, 1], [6, 5]], rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="ragged decode"):
        model(torch.as_tensor(toks[:, :2]).long(), pos, cache=cache)
    with pytest.raises(ValueError, match="one token a step"):
        model(torch.as_tensor(toks[:, :2]).long(), 3, cache=cache, decode=True)


def test_init_cache_layout():
    c = tiny_config(max_seq_len=32, dtype=torch.bfloat16)
    cache = init_cache(c, 3, device="cpu")
    assert len(cache) == c.num_layers
    for k, v in cache:
        assert k.shape == v.shape == (3, 32, c.num_heads, c.head_dim)
        assert k.dtype == torch.bfloat16 and not k.any()


def test_generate_greedy_matches_jax(weights):
    jcfg, jparams, state = weights
    prompt = tokens((2, 9), seed=2)
    want = np.asarray(jax_generate(jcfg, jparams, jnp.asarray(prompt), jax.random.key(1),
                                   max_new_tokens=8))
    got = generate(cfg(), state, prompt, 8, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 17)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_sampling_is_seeded(model):
    prompt = tokens((2, 4), seed=3)
    a = generate(cfg(), model, prompt, 16, temperature=1.0, seed=1)
    b = generate(cfg(), model, prompt, 16, temperature=1.0, seed=1)
    c = generate(cfg(), model, prompt, 16, temperature=1.0, seed=3)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # top_k=1 at any temperature is greedy
    assert torch.equal(generate(cfg(), model, prompt, 8),
                       generate(cfg(), model, prompt, 8, temperature=1.0, top_k=1, seed=5))


def test_generate_ragged_matches_jax_and_per_request_generate(weights, model):
    jcfg, jparams, _ = weights
    rng = np.random.default_rng(0)
    lengths = [5, 17, 32, 9]
    padded = np.zeros((4, 32), np.int32)
    for i, l in enumerate(lengths):
        padded[i, :l] = rng.integers(1, 128, l)
    want = np.asarray(jax_generate_ragged(
        jcfg, jparams, jnp.asarray(padded), jnp.asarray(lengths, jnp.int32),
        jax.random.key(1), max_new_tokens=12))
    got = generate_ragged(cfg(), model, padded, lengths, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    for i, l in enumerate(lengths):
        alone = generate(cfg(), model, padded[i:i + 1, :l], 12)[0, l:]
        np.testing.assert_array_equal(alone.numpy(), got[i].numpy())
    # the parts: prefill's last-token logits, then a per-row decode step
    cache, last = ragged_prefill(cfg(), model, padded, lengths)
    cache, nxt = ragged_decode_step(cfg(), model, cache, last.argmax(-1),
                                    torch.tensor(lengths))
    assert nxt.shape == (4, 128)
    np.testing.assert_array_equal(nxt.argmax(-1).numpy(), want[:, 1])


def batch_events(batcher, prompts, budgets):
    """Submit as slots free (request 2 joins while 0 and 1 decode; slots
    are reused), step to the end: every submit and every token, in
    order."""
    events, pending = [], list(range(len(prompts)))
    while pending or (np.asarray(batcher.remaining) > 0).any():
        while pending and batcher.free_slots():
            i = pending.pop(0)
            events.append(("submit", i, int(batcher.submit(prompts[i], budgets[i]))))
        events += [(int(slot), int(tok)) for slot, tok in batcher.step()]
    return events


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_continuous_batcher_matches_jax(weights, layout):
    jcfg, jparams, state = weights
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 128, (l,)).astype(np.int32) for l in (7, 13, 4, 21)]
    budgets = [6, 10, 8, 5]
    paged = dict(block_len=8, gather_impl="dense") if layout == "paged" else {}
    want = batch_events(JaxBatcher(jcfg, jparams, n_slots=2, prefill_bucket=8,
                                   cache_layout=layout, **paged), prompts, budgets)
    port_kw = dict(block_len=8) if layout == "paged" else {}
    b = ContinuousBatcher(cfg(), state, n_slots=2, prefill_bucket=8, cache_layout=layout,
                          device="cpu", **port_kw)
    assert batch_events(b, prompts, budgets) == want
    if layout == "paged":
        assert b.engine.allocator.in_use == 0
    else:
        assert b.cache[0].key.shape == (2, MAX_SEQ, 2, 16) and b.engine is None


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_batcher_eos_retires_early_as_jax(weights, layout):
    jcfg, jparams, state = weights
    prompt = tokens((9,), seed=3)
    first = int(generate(cfg(), state, prompt[None], 1, device="cpu")[0, -1])
    paged = dict(block_len=8, gather_impl="dense") if layout == "paged" else {}
    runs = []
    for b in (JaxBatcher(jcfg, jparams, n_slots=1, prefill_bucket=8, eos_id=first,
                         cache_layout=layout, **paged),
              ContinuousBatcher(cfg(), state, n_slots=1, prefill_bucket=8, eos_id=first,
                                cache_layout=layout, device="cpu",
                                **({"block_len": 8} if layout == "paged" else {}))):
        slot = int(b.submit(prompt, 10))
        events = [(int(s), int(t)) for s, t in b.step()]
        runs.append((slot, events, int(b.remaining[slot]), list(b.free_slots()),
                     b.step(), int(b.submit(prompt, 2))))
    assert runs[1] == runs[0]
    assert runs[1][1] == [(0, first)] and runs[1][2] == 0


def both_raise(exc, match, jax_call, port_call):
    with pytest.raises(exc, match=match):
        jax_call()
    with pytest.raises(exc, match=match):
        port_call()


def test_validations_raise_as_jax(weights):
    jcfg, jparams, state = weights
    key = jax.random.key(0)
    long = np.ones((2, 60), np.int32)
    both_raise(ValueError, "exceeds max_seq_len",
               lambda: jax_generate(jcfg, jparams, jnp.asarray(long), key, max_new_tokens=8),
               lambda: generate(cfg(), state, long, 8, device="cpu"))
    both_raise(ValueError, "at least one token",
               lambda: jax_generate(jcfg, jparams, jnp.zeros((1, 0), jnp.int32), key),
               lambda: generate(cfg(), state, np.zeros((1, 0), np.int32), device="cpu"))
    both_raise(ValueError, "temperature",
               lambda: jax_generate(jcfg, jparams, jnp.ones((1, 4), jnp.int32), key,
                                    temperature=-1.0),
               lambda: generate(cfg(), state, np.ones((1, 4), np.int32), temperature=-1.0,
                                device="cpu"))
    both_raise(ValueError, "top_k",
               lambda: jax_generate(jcfg, jparams, jnp.ones((1, 4), jnp.int32), key,
                                    temperature=1.0, top_k=1000),
               lambda: generate(cfg(), state, np.ones((1, 4), np.int32), temperature=1.0,
                                top_k=1000, device="cpu"))
    lens = np.asarray([60, 4], np.int32)
    both_raise(ValueError, "static worst case",
               lambda: jax_generate_ragged(jcfg, jparams, jnp.asarray(long),
                                           jnp.asarray(lens), key, max_new_tokens=8),
               lambda: generate_ragged(cfg(), state, long, lens, 8, device="cpu"))
    both_raise(ValueError, "dense-attention only",
               lambda: jax_generate_ragged(jax_tiny_config(attention="ring"), jparams,
                                           jnp.asarray(long), jnp.asarray(lens), key,
                                           max_new_tokens=2),
               lambda: generate_ragged(tiny_config(attention="ring"), state, long, lens, 2,
                                       device="cpu"))
    both_raise(ValueError, "eos_id",
               lambda: JaxBatcher(jcfg, jparams, n_slots=1, eos_id=128),
               lambda: ContinuousBatcher(cfg(), state, n_slots=1, eos_id=128, device="cpu"))
    both_raise(ValueError, "cache_layout",
               lambda: JaxBatcher(jcfg, jparams, n_slots=1, cache_layout="ring"),
               lambda: ContinuousBatcher(cfg(), state, n_slots=1, cache_layout="ring",
                                         device="cpu"))
    both_raise(ValueError, "block-pool knobs",
               lambda: JaxBatcher(jcfg, jparams, n_slots=1, cache_layout="dense",
                                  kv_dtype="int8"),
               lambda: ContinuousBatcher(cfg(), state, n_slots=1, cache_layout="dense",
                                         kv_dtype="int8", device="cpu"))
    jb = JaxBatcher(jcfg, jparams, n_slots=1, prefill_bucket=24, cache_layout="dense")
    pb = ContinuousBatcher(cfg(), state, n_slots=1, prefill_bucket=24, cache_layout="dense",
                           device="cpu")
    both_raise(ValueError, "padded to 72", lambda: jb.submit(np.ones(50, np.int32), 4),
               lambda: pb.submit(np.ones(50, np.int32), 4))
    both_raise(ValueError, "exceeds max_seq_len", lambda: jb.submit(np.ones(40, np.int32), 30),
               lambda: pb.submit(np.ones(40, np.int32), 30))
    jb.submit(np.ones(4, np.int32), 2)
    pb.submit(np.ones(4, np.int32), 2)
    both_raise(RuntimeError, "no free decode slot", lambda: jb.submit(np.ones(4, np.int32), 2),
               lambda: pb.submit(np.ones(4, np.int32), 2))


def test_serve_lm_dense_serves_on_cpu(capsys):
    m = serve_lm.main(["--dense", "--device", "cpu", "--tiny", "--requests", "5",
                       "--max-new", "3", "--slots", "2"])
    assert (m["layout"], m["completed"], m["tokens_out"]) == ("dense", 5, 15)
    out = capsys.readouterr().out
    assert '"layout": "dense"' in out and '"tokens_out": 15' in out


@pytest.mark.parametrize("flag", [["--warmup"], ["--kv-dtype", "fp8"], ["--prefix-cache"],
                                  ["--preempt"], ["--split-s", "2"]])
def test_serve_lm_dense_refuses_the_block_pool_flags(flag, capsys):
    with pytest.raises(SystemExit):
        serve_lm.main(["--dense", "--device", "cpu", "--tiny"] + flag)
    assert "block-pool knobs" in capsys.readouterr().err
