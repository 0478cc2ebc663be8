"""The single sweep's two kernels: which one runs, and what the tensor-core
kernel's TMA boxes read.

bf16 q on bf16, int8 and fp8 pools runs ``paged_sweep_tc_kernel`` (tensor
cores, pool blocks landed by TMA in stages of 64 chain keys, up to 64 query
rows a thread block); fp32 q and pools, and the other head dims and block
lengths, run the CUDA-core walk. Both run only on the card (``chip_smoke.py`` holds them
against the plain version there). Here: the routing, the row-tile count,
the pool's tensor-map geometry (each box it names is the pool block the
table points at), the wrapper's call into the library, and the plain
version against the Pallas sweep at R = G·C > 64 rows per KV head.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops.paged_flash import (
    paged_flash_attention as jax_paged_flash_attention,
)
from pytorch_distributed_tpu_torch.ops import paged_flash
from pytorch_distributed_tpu_torch.ops.attention import paged_attention_reference
from pytorch_distributed_tpu_torch.ops.paged_flash import (
    CUDA_CORES,
    TENSOR_CORES,
    pool_tensor_map_geometry,
    sweep_kernel,
    tc_row_tiles,
)

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("q_dtype,pool_dtype,d,block_len,want", [
    (BF16, BF16, 64, 16, TENSOR_CORES),   # the serve's decode and prefill sweeps
    (BF16, BF16, 128, 16, TENSOR_CORES),
    (BF16, BF16, 64, 8, TENSOR_CORES),
    (BF16, BF16, 64, 32, TENSOR_CORES),
    (BF16, BF16, 64, 64, TENSOR_CORES),
    (BF16, BF16, 128, 256, TENSOR_CORES),
    (BF16, BF16, 32, 16, CUDA_CORES),     # head dims off the 64-column box
    (BF16, BF16, 96, 16, CUDA_CORES),
    (BF16, BF16, 64, 4, CUDA_CORES),      # boxes under 8 rows
    (BF16, BF16, 64, 24, CUDA_CORES),     # a stage would split a box
    (BF16, BF16, 64, 96, CUDA_CORES),
    (F32, F32, 64, 16, CUDA_CORES),       # fp32 pools
    (BF16, torch.int8, 64, 16, TENSOR_CORES),  # quantized pools: codes exact in bf16
    (BF16, torch.float8_e4m3fn, 64, 16, TENSOR_CORES),
    (F32, torch.float8_e5m2, 128, 16, CUDA_CORES),  # fp32 q: the walk
    (BF16, torch.float8_e5m2, 128, 16, TENSOR_CORES),
    (BF16, torch.int8, 64, 256, TENSOR_CORES),
    (F32, torch.int8, 64, 16, CUDA_CORES),
    (F32, torch.float8_e4m3fn, 64, 16, CUDA_CORES),
    (BF16, torch.int8, 32, 16, CUDA_CORES),    # head dims off the tensor-core instances
    (BF16, torch.float8_e4m3fn, 96, 16, CUDA_CORES),
    (BF16, torch.float8_e5m2, 64, 24, CUDA_CORES),  # a stage would split a box
])
def test_sweep_kernel_routes_by_dtypes_head_dim_and_block_len(q_dtype, pool_dtype, d,
                                                              block_len, want):
    assert sweep_kernel(q_dtype, pool_dtype, d, block_len) == want


@pytest.mark.parametrize("rows,tiles", [(1, 1), (12, 1), (32, 1), (64, 1), (65, 2), (80, 2),
                                        (128, 2), (129, 3)])
def test_tc_row_tiles_hold_up_to_64_rows(rows, tiles):
    """A KV head's R = G·C rows share one thread block up to 64 (the
    serve's prefill chunk: R = 32), so its chain is read once."""
    assert tc_row_tiles(rows) == tiles


def box(pool: torch.Tensor, geometry, col: int, head: int, row: int) -> torch.Tensor:
    """What a TMA box of ``geometry`` at coordinates (col, head, row) reads
    from ``pool``'s storage, zeros where it lies out of bounds."""
    d, h_kv, n_rows, s_head, s_row, b_col, b_head, b_rows = geometry
    e = pool.element_size()
    assert (b_col, b_head) == (64, 1) and s_head % e == 0 and s_row % e == 0
    out = torch.zeros((b_rows, b_col), dtype=pool.dtype)
    flat = pool.reshape(-1)
    for r in range(b_rows):
        if row + r < n_rows:
            start = (row + r) * (s_row // e) + head * (s_head // e) + col
            out[r] = flat[start:start + b_col]
    return out


@pytest.mark.parametrize("block_len", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("d", [64, 128])
def test_pool_geometry_boxes_walk_the_chain_in_64_key_stages(block_len, d):
    """The pool as ``[n_blocks·bl, H_kv, D]``: walking a table in stages of
    64 keys, box ``c`` of stage ``i`` starting at key ``64 i + c·rows``,
    read at row ``table[key // bl]·bl + key % bl`` (one box per pool block,
    or per 64 rows of one), lands every key of the chain once, column box
    by column box; a box past the frontier, asked for at row ``n_blocks·bl``,
    reads zeros."""
    rng = np.random.default_rng(block_len + d)
    n_blocks, h_kv, head, w = 9, 3, 2, 4
    pool = torch.from_numpy(rng.standard_normal((n_blocks, block_len, h_kv, d),
                                                np.float32)).to(BF16)
    table = rng.permutation(np.arange(1, n_blocks))[:w]
    geometry = pool_tensor_map_geometry(pool)
    assert geometry[:5] == (d, h_kv, n_blocks * block_len, d * 2, h_kv * d * 2)
    rows = geometry[7]
    assert rows == min(block_len, 64) and 64 % rows == 0 and rows * 128 % 1024 == 0
    n_keys = w * block_len
    stages = []
    for i in range(-(-n_keys // 64)):
        stage = torch.cat([
            torch.cat([box(pool, geometry, x * 64, head,
                           int(table[key // block_len]) * block_len + key % block_len)
                       for x in range(d // 64)], dim=1)
            for key in range(64 * i, 64 * i + 64, rows) if key < n_keys])
        stages.append(stage)
    chain = pool[torch.from_numpy(table)][:, :, head].reshape(n_keys, d)
    assert torch.equal(torch.cat(stages)[:n_keys], chain)
    assert not box(pool, geometry, 0, head, n_blocks * block_len).any()


class FakeLibrary:
    """The kernels' library as the wrapper calls it: each entry point
    records its arguments and reports a launch."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("dtype,d,want", [(BF16, 64, "pdt_paged_attention_sweep_tc"),
                                          (BF16, 128, "pdt_paged_attention_sweep_tc"),
                                          (BF16, 32, "pdt_paged_attention_sweep"),
                                          (F32, 64, "pdt_paged_attention_sweep")])
def test_launch_sweep_calls_the_routed_entry_point(dtype, d, want, monkeypatch):
    """``launch_sweep`` hands the tensor-core entry point the pools'
    geometry and the GQA split of the heads, and counts one sweep launch
    either way."""
    lib = FakeLibrary()
    monkeypatch.setattr(paged_flash, "_library", lambda: lib)
    monkeypatch.setattr(paged_flash, "_stream", lambda t: ctypes.c_void_p(None))
    b, c, h, h_kv, bl, w, n_blocks = 2, 3, 8, 2, 16, 5, 11
    q = torch.zeros((b, c, h, d), dtype=dtype)
    k_pool = torch.zeros((n_blocks, bl, h_kv, d), dtype=dtype)
    tables = torch.zeros((b, w), dtype=torch.int32)
    qpos = torch.zeros((b, c), dtype=torch.int32)
    paged_flash.reset_launch_counts()
    out = paged_flash.launch_sweep(q, k_pool, k_pool.clone(), tables, qpos, 0.125)
    assert out.shape == q.shape and out.dtype == dtype
    assert [name for name, _ in lib.calls] == [want]
    assert paged_flash.launch_counts[paged_flash.SWEEP] == 1
    if want.endswith("_tc"):  # after q, its strides, the pools and their (null) scales
        args = lib.calls[0][1]
        assert [a.value for a in args[6:8]] == [None, None]
        assert tuple(args[8]) == pool_tensor_map_geometry(k_pool)
        assert args[12:19] == (0, b, c, h_kv, h // h_kv, bl, w)


def test_reference_matches_jax_pallas_sweep_at_many_rows_per_kv_head():
    """R = G·C = 80 rows per KV head (two tensor-core row tiles): the plain
    version against the Pallas single sweep in interpret mode, fp32, with a
    long chain, padding rows and a fully masked batch row."""
    rng = np.random.default_rng(7)
    b, c, h, h_kv, d, bl, w = 3, 20, 8, 2, 8, 4, 8
    n_blocks = 1 + b * w
    k_pool, v_pool = (rng.standard_normal((n_blocks, bl, h_kv, d)).astype(np.float32)
                      for _ in range(2))
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(b, w).astype(np.int32)
    q = rng.standard_normal((b, c, h, d)).astype(np.float32)
    pos = np.full((b, c), -1, np.int32)
    pos[0] = np.arange(10, 30)
    pos[1, :6] = np.arange(2, 8)
    want = jax_paged_flash_attention(*map(jnp.asarray, (q, k_pool, v_pool, tables, pos)),
                                     split_s=1, interpret=True)
    got = paged_attention_reference(*map(torch.from_numpy, (q, k_pool, v_pool, tables, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not got[1, 6:].any() and not got[2].any()
