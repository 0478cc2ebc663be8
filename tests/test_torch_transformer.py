"""The port's TransformerLM against the JAX package's, in paged mode.

Same weights (the flax tree carried across by ``params_from_jax``), same
numpy inputs: two chunked-prefill steps and a decode tick through
non-contiguous block chains with trash tails. The logits and the written
pools must agree: to 1e-4 in fp32, and to a few bf16 ulps in bf16 (see
``test_paged_forward_matches_jax_bf16``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.serving.kv_pool import init_paged_cache as jax_init_paged_cache
from pytorch_distributed_tpu_torch.models import (
    TransformerConfig,
    TransformerLM,
    init_params,
    params_from_jax,
    tiny_config,
)
from pytorch_distributed_tpu_torch.models.generate import _validate_serving_config
from pytorch_distributed_tpu_torch.models.transformer import LN_EPS
from pytorch_distributed_tpu_torch.serving.kv_pool import init_paged_cache

BLOCK_LEN, N_BLOCKS, MAX_SEQ = 4, 33, 64
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def jax_params(jcfg):
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return params, jax.tree.map(np.asarray, params)


def run_both(dtype, gather_impl):
    """Per step: (jax logits, port logits, jax pools, port pools)."""
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ,
                           dtype=JAX_DTYPES[dtype])
    params, np_params = jax_params(jcfg)
    tcfg = tiny_config(max_seq_len=MAX_SEQ, dtype=dtype, gather_impl=gather_impl)
    model = TransformerLM(tcfg)
    model.load_state_dict(params_from_jax(np_params))
    jcache = jax_init_paged_cache(jcfg, params, N_BLOCKS, BLOCK_LEN)
    tcache = init_paged_cache(tcfg, N_BLOCKS, BLOCK_LEN)
    rng = np.random.default_rng(0)
    order = rng.permutation(np.arange(1, N_BLOCKS))
    tables = np.zeros((2, MAX_SEQ // BLOCK_LEN), np.int32)
    tables[0, :6] = order[:6]
    tables[1, :5] = order[6:11]
    steps = [
        ("prefill", rng.integers(0, 128, (2, 8)), np.array([0, 0])),
        ("prefill", rng.integers(0, 128, (2, 8)), np.array([8, 8])),
        ("decode", rng.integers(0, 128, (2, 1)), np.array([16, 13])),
    ]
    results = []
    for mode, tokens, starts in steps:
        out, variables = JaxLM(jcfg).apply(
            {"params": params, "cache": jcache}, jnp.asarray(tokens, jnp.int32),
            position_offset=jnp.asarray(starts, jnp.int32),
            prefill=mode == "prefill", decode=mode == "decode",
            block_tables=jnp.asarray(tables), mutable=["cache"])
        jcache = variables["cache"]
        with torch.no_grad():
            got = model(torch.from_numpy(tokens), torch.from_numpy(starts),
                        torch.from_numpy(tables), tcache)
        jpools = [(np.asarray(jcache[f"block{i}"]["attn"]["key"], np.float32),
                   np.asarray(jcache[f"block{i}"]["attn"]["value"], np.float32))
                  for i in range(tcfg.num_layers)]
        tpools = [(k.float().numpy().copy(), v.float().numpy().copy())
                  for k, v, *_ in tcache]
        results.append((np.asarray(out), got.numpy(), jpools, tpools))
    return results


@pytest.mark.parametrize("gather_impl", ["kernel", "dense"])
def test_paged_forward_matches_jax_fp32(gather_impl):
    for want, got, jpools, tpools in run_both(torch.float32, gather_impl):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        for (jk, jv), (tk, tv) in zip(jpools, tpools):
            np.testing.assert_allclose(tk, jk, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-4)


def test_paged_forward_matches_jax_bf16():
    """bf16 rounds at different places in XLA and in torch (torch's bf16
    matmuls add the bias before their one rounding, and its GELU computes
    in fp32), so the two agree to a few bf16 ulps, not bit for bit. The
    logits here stay below 4 in magnitude, where one ulp is 2**-6: allow
    5 ulps on the logits, 2 on the pool entries (|k|, |v| < 2)."""
    for want, got, jpools, tpools in run_both(torch.bfloat16, "kernel"):
        np.testing.assert_allclose(got, want, atol=5 * 2 ** -6)
        for (jk, jv), (tk, tv) in zip(jpools, tpools):
            np.testing.assert_allclose(tk, jk, atol=2 * 2 ** -6)
            np.testing.assert_allclose(tv, jv, atol=2 * 2 ** -6)


def test_logits_index_keeps_the_named_rows():
    cfg = tiny_config(max_seq_len=MAX_SEQ)
    model = TransformerLM(cfg)
    model.load_state_dict(params_from_jax(init_params(cfg, seed=1)))
    tables = torch.arange(1, 5, dtype=torch.int32).reshape(2, 2)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8))
    starts = torch.zeros(2, dtype=torch.long)
    with torch.no_grad():
        full = model(tokens, starts, tables, init_paged_cache(cfg, 5, 4))
        rows = model(tokens, starts, tables, init_paged_cache(cfg, 5, 4),
                     logits_index=torch.tensor([7, 2]))
    assert rows.shape == (2, 1, cfg.vocab_size)
    torch.testing.assert_close(rows[:, 0], full[[0, 1], [7, 2]])


def test_init_params_matches_flax_layout_and_scales():
    """The numpy initialiser builds flax's tree, leaf for leaf, at flax's
    default scales (standard deviations within 15% on the large leaves)."""
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ, embed_dim=64,
                           vocab_size=512)
    _, ref = jax_params(jcfg)
    cfg = tiny_config(max_seq_len=MAX_SEQ, embed_dim=64, vocab_size=512)
    ours = init_params(cfg, seed=0)
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    our_leaves = dict((jax.tree_util.keystr(p), v)
                      for p, v in jax.tree_util.tree_leaves_with_path(ours))
    assert sorted(our_leaves) == sorted(jax.tree_util.keystr(p) for p, _ in ref_leaves)
    for path, want in ref_leaves:
        got = our_leaves[jax.tree_util.keystr(path)]
        assert got.shape == want.shape and got.dtype == np.float32, path
        if want.size > 1000:
            assert abs(got.std() / want.std() - 1) < 0.15, path
    # deterministic from the seed
    again = init_params(cfg, seed=0)
    assert np.array_equal(again["block0"]["attn"]["qkv"]["kernel"],
                          ours["block0"]["attn"]["qkv"]["kernel"])


def test_params_from_jax_layout():
    cfg = tiny_config(max_seq_len=MAX_SEQ)
    flax = init_params(cfg, seed=2)
    sd = params_from_jax(flax)
    model = TransformerLM(cfg)
    assert set(sd) == set(model.state_dict())
    e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    qkv = flax["block1"]["attn"]["qkv"]["kernel"]  # [E, 3, H, D]
    # output feature (which, head, dim) of the fused projection
    w = sd["blocks.1.attn.qkv.weight"].numpy().reshape(3, h, d, e)
    np.testing.assert_array_equal(w[1, 0, 3], qkv[:, 1, 0, 3])
    proj = flax["block1"]["attn"]["proj"]["kernel"]  # [H, D, E]
    np.testing.assert_array_equal(
        sd["blocks.1.attn.proj.weight"].numpy().reshape(e, h, d)[5], proj[..., 5])
    with pytest.raises(ValueError, match="unexpected flax tree"):
        params_from_jax({**flax, "extra": {}})


def test_layernorm_and_gelu_follow_flax():
    cfg = tiny_config(dtype=torch.bfloat16)
    blk = TransformerLM(cfg).blocks[0]
    assert blk.ln1.eps == LN_EPS == 1e-6
    assert blk.ln1.weight.dtype == torch.float32
    assert blk.mlp_up.weight.dtype == torch.bfloat16
    assert blk.attn.proj.bias is None and blk.mlp_down.bias is None
    x = torch.randn(2, 3, cfg.embed_dim).bfloat16()
    assert blk.ln1(x).dtype == torch.float32


@pytest.mark.parametrize("field,value,error", [
    ("gather_impl", "pallas", ValueError),
    ("split_s", 0, ValueError),
    ("dtype", torch.float16, ValueError),
    ("embed_dim", 33, ValueError),
])
def test_config_validation(field, value, error):
    with pytest.raises(error):
        dataclasses.replace(TransformerConfig(), **{field: value})


def test_serving_takes_dense_attention_configs_only():
    _validate_serving_config(tiny_config())
    with pytest.raises(ValueError, match="dense-attention only"):
        _validate_serving_config(tiny_config(attention="ring"))
