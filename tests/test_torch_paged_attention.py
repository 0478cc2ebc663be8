"""The port's paged attention against the JAX package's.

The port's plain version (``paged_attention_reference``) is held against
JAX ``paged_attention(gather_impl="dense")`` and against the Pallas
kernels (``paged_flash_attention``, single sweep and flash-decoding
split) in interpret mode, on the same numpy inputs: trash-block tails,
ragged frontiers, padding rows (position -1) and a fully masked row, MHA
and GQA, decode (C=1) and chunk (C=5) rows. Tolerance 1e-5 in fp32: the
same math, summed in another order.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds them against the plain version there). Here: the split policy, the
wrapper's checks, and the rules that the wrapper runs the plain version
only for CPU tensors and that a missing compiler raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.attention import paged_attention as jax_paged_attention
from pytorch_distributed_tpu.ops.paged_flash import auto_split_s as jax_auto_split_s
from pytorch_distributed_tpu.ops.paged_flash import (
    paged_flash_attention as jax_paged_flash_attention,
)
from pytorch_distributed_tpu_torch.ops import _build, paged_flash
from pytorch_distributed_tpu_torch.ops.attention import (
    paged_attention,
    paged_attention_reference,
)
from pytorch_distributed_tpu_torch.ops.paged_flash import (
    auto_split_s,
    paged_flash_attention,
)

B, H, D, BL, W = 2, 4, 8, 4, 6


def make_inputs(c, h_kv, seed=0):
    """Pools whose chains are shorter than the table (trash tails), a
    garbage-filled trash block, and positions with a ragged frontier in
    row 0 and padding (-1) in row 1 — all of row 1 when C == 1."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * W
    k_pool = rng.normal(size=(n_blocks, BL, h_kv, D)).astype(np.float32)
    v_pool = rng.normal(size=(n_blocks, BL, h_kv, D)).astype(np.float32)
    tables = np.zeros((B, W), np.int32)
    order = rng.permutation(np.arange(1, n_blocks))
    tables[0, :5] = order[:5]  # 20 positions, one trash entry
    tables[1, :2] = order[5:7]  # 8 positions, four trash entries
    q = rng.normal(size=(B, c, H, D)).astype(np.float32)
    pos = np.zeros((B, c), np.int32)
    pos[0] = np.arange(19 - c + 1, 20)
    pos[1] = -1
    if c > 1:
        pos[1, :2] = [3, 7]
    return q, k_pool, v_pool, tables, pos


def to_torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = [(1, 4), (1, 2), (5, 4), (5, 2)]


@pytest.mark.parametrize("c,h_kv", CASES)
def test_reference_matches_jax_dense_gather(c, h_kv):
    q, kp, vp, tables, pos = make_inputs(c, h_kv)
    want = jax_paged_attention(*map(jnp.asarray, (q, kp, vp, tables, pos)),
                               gather_impl="dense")
    got = paged_attention_reference(*to_torch(q, kp, vp, tables, pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # padding rows come out exactly 0
    assert not got[1, 2:].any() if c > 1 else not got[1].any()


@pytest.mark.parametrize("split_s", [1, 2])
@pytest.mark.parametrize("c,h_kv", CASES)
def test_reference_matches_jax_pallas_interpret(c, h_kv, split_s):
    """Both Pallas kernels, sweep (split_s=1) and flash-decoding split."""
    q, kp, vp, tables, pos = make_inputs(c, h_kv, seed=1)
    want = jax_paged_flash_attention(
        *map(jnp.asarray, (q, kp, vp, tables, pos)), split_s=split_s,
        interpret=True)
    got = paged_attention_reference(*to_torch(q, kp, vp, tables, pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bf16_reference_matches_jax_dense_gather():
    """bf16 inputs, fp32 statistics, output rounded once to bf16 on both
    sides: equal to within one bf16 ulp of |out| < 2 (2**-7)."""
    q, kp, vp, tables, pos = make_inputs(5, 2, seed=2)
    want = jax_paged_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(pos), gather_impl="dense")
    got = paged_attention_reference(
        *(torch.from_numpy(a).bfloat16() for a in (q, kp, vp)),
        *to_torch(tables, pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2 ** -7)


def test_auto_split_s_matches_jax():
    for w in (1, 2, 7, 8, 9, 16, 63, 64, 128, 129, 512):
        for b in (1, 2, 3, 4, 8, 16):
            assert auto_split_s(w, b) == jax_auto_split_s(w, b), (w, b)
    # the full-width decode tick: W = 2048 / 16, B = 8 slots
    assert auto_split_s(128, 8) == 8


@pytest.mark.parametrize("c,h_kv", CASES)
def test_wrapper_on_cpu_runs_the_plain_version(c, h_kv, monkeypatch):
    """CPU tensors go to paged_attention_reference, whatever split_s, and
    launch nothing."""
    args = to_torch(*make_inputs(c, h_kv))
    calls = []
    real = paged_flash.paged_attention_reference

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(paged_flash, "paged_attention_reference", spy)
    paged_flash.reset_launch_counts()
    want = paged_attention_reference(*args)
    for split_s in (None, 1, 3):
        got = paged_flash_attention(*args, split_s=split_s)
        assert torch.equal(got, want)
        assert torch.equal(paged_attention(*args, gather_impl="kernel"), want)
    assert len(calls) == 6
    assert paged_flash.launch_counts == {paged_flash.SWEEP: 0, paged_flash.SPLIT: 0}


def test_wrapper_rejects_bad_operands():
    q, kp, vp, tables, pos = to_torch(*make_inputs(1, 4))
    with pytest.raises(ValueError, match="multiple of pool KV heads"):
        paged_flash_attention(q, kp[:, :, :3], vp[:, :, :3], tables, pos)
    with pytest.raises(ValueError, match="q_positions"):
        paged_flash_attention(q, kp, vp, tables, pos[:, :0])
    with pytest.raises(ValueError, match="block_tables"):
        paged_flash_attention(q, kp, vp, tables[:1], pos)
    with pytest.raises(ValueError, match="split_s"):
        paged_flash_attention(q, kp, vp, tables, pos, split_s=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        paged_flash_attention(*(t.to("meta") for t in (q, kp, vp, tables, pos)))
    with pytest.raises(ValueError, match="gather_impl"):
        paged_attention(q, kp, vp, tables, pos, gather_impl="pallas")


def test_missing_nvcc_raises_and_loads_nothing(monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises, it never falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("paged_attention")
    assert _build._libs == {}
    assert _build.kernel_sources() == ["bottleneck_tail", "flash_attention", "paged_attention"]


def test_build_command_targets_hopper(tmp_path):
    cmd = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-O3", "-shared", "-Xcompiler", "-fPIC"} <= set(cmd)
    lib = _build.library_path("paged_attention")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"


def test_library_name_follows_the_source_and_the_shared_headers(monkeypatch, tmp_path):
    """An edit to a kernel's source or to a header the sources share
    (``csrc/*.cuh``) names a new library, so a stale build never loads."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", csrc / "build")
    (csrc / "k.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// v1\n")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (csrc / "shared.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    (csrc / "k.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert len({first, second, _build.library_path("k")}) == 3
    assert _build.kernel_sources() == ["k"]

