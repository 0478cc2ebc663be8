"""Kernel 8, the flash-decoding split: which kernel runs, what it is handed,
and its scratch.

bf16 q on bf16, int8 and fp8 pools (D 64 or 128, the block lengths the
sweep's TMA boxes take) runs ``paged_split_tc_kernel``, the tensor-core
sweep's body over one worker's span of the chain in blocks of two consumer
warps, at every row count R = G·C (rows past 32 take further row tiles);
fp32 q and pools, and other head dims and block lengths, run the CUDA-core
walk. Both run only on the card
(``chip_smoke.py`` holds them against the plain version there, and two
launches bit for bit). Here: the routing, the row tiles, the scratch's
sizing and its reuse from call to call (the tickets zeroed once), the
wrapper's call into the library, and the plain version against the Pallas
split in interpret mode at GQA row counts.
"""

import ctypes
import math

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
    split_buffers,
    split_row_tiles,
)

BF16, F32 = torch.bfloat16, torch.float32
WALK_ROWS = 8  # the CUDA-core walk's row tile (kRows in csrc/paged_attention.cu)
TC, WALK = "pdt_paged_attention_split_tc", "pdt_paged_attention_split"


class FakeLibrary:
    """The kernels' library as the wrapper calls it: each entry point
    records its arguments and reports a launch."""

    def __init__(self):
        self.calls = []

    def pdt_paged_attention_rows_per_tile(self):
        return WALK_ROWS

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def lib(monkeypatch):
    fake = FakeLibrary()
    monkeypatch.setattr(paged_flash, "_library", lambda: fake)
    monkeypatch.setattr(paged_flash, "_stream", lambda t: ctypes.c_void_p(None))
    monkeypatch.setattr(paged_flash, "_split_scratch", {})
    paged_flash.reset_launch_counts()
    return fake


@pytest.mark.parametrize("q_dtype,pool_dtype,d,bl,g,c,want", [
    (BF16, BF16, 64, 16, 1, 1, TC),      # the LM's MHA decode: R = 1
    (BF16, BF16, 64, 16, 4, 5, TC),      # GQA, H 8, H_kv 2, C 5: R = 20
    (BF16, BF16, 64, 16, 4, 20, TC),     # R = 80: three row tiles
    (BF16, BF16, 128, 16, 1, 2, TC),     # D = 128
    (BF16, BF16, 64, 8, 1, 1, TC),
    (BF16, BF16, 64, 256, 1, 1, TC),
    (BF16, BF16, 32, 16, 1, 1, WALK),    # head dims off the 64-column box
    (BF16, BF16, 64, 24, 1, 1, WALK),    # a 64-key stage would split a box
    (F32, F32, 64, 16, 1, 1, WALK),      # fp32 pools
    (F32, F32, 64, 16, 4, 20, WALK),
    (BF16, torch.int8, 64, 16, 1, 1, TC),  # quantized pools: codes exact in bf16
    (BF16, torch.float8_e4m3fn, 64, 16, 4, 5, TC),
    (F32, torch.float8_e5m2, 128, 16, 1, 1, WALK),  # fp32 q: the walk
    (BF16, torch.float8_e5m2, 128, 16, 4, 20, TC),
    (F32, torch.int8, 64, 16, 4, 5, WALK),
    (BF16, torch.int8, 32, 16, 1, 1, WALK),   # head dims off the tensor-core instances
    (BF16, torch.float8_e5m2, 96, 16, 1, 1, WALK),
])
def test_launch_split_routes_by_dtypes_head_dim_block_len_and_rows(
        lib, q_dtype, pool_dtype, d, bl, g, c, want):
    """One launch of the routed entry point a call, counted once; its
    scratch sized from that kernel's row tile (32 rows on tensor cores, 8
    on the walk): one ticket per (batch row, KV head, row tile), zero, and
    the partials ``[B, H_kv, S, R, D + 2]``."""
    b, h_kv, w, s_workers, n_blocks = 3, 2, 9, 3, 28
    h, rows = h_kv * g, g * c
    q = torch.zeros((b, c, h, d), dtype=q_dtype)
    k_pool = torch.zeros((n_blocks, bl, h_kv, d), dtype=pool_dtype)
    scales = {}
    if pool_dtype != q_dtype:
        sdt = F32 if pool_dtype == torch.int8 else torch.int8
        scales = dict(k_scale=torch.zeros((n_blocks, bl, h_kv), dtype=sdt),
                      v_scale=torch.zeros((n_blocks, bl, h_kv), dtype=sdt))
    tables = torch.zeros((b, w), dtype=torch.int32)
    qpos = torch.zeros((b, c), dtype=torch.int32)
    out = paged_flash.launch_split(q, k_pool, k_pool.clone(), tables, qpos, s_workers, 0.125,
                                   **scales)
    assert out.shape == q.shape and out.dtype == q_dtype
    assert [name for name, _ in lib.calls] == [want]
    if scales:
        assert paged_flash.quant_launch_counts[
            paged_flash.variant(paged_flash.SPLIT, pool_dtype)] == 1
    else:
        assert paged_flash.launch_counts == {paged_flash.SWEEP: 0, paged_flash.SPLIT: 1}
    kernel = paged_flash.sweep_kernel(q_dtype, pool_dtype, d, bl)
    assert kernel == (TENSOR_CORES if want == TC else CUDA_CORES)
    assert {k: v for k, v in paged_flash.route_launch_counts.items() if v} == {
        paged_flash.route_key(paged_flash.SPLIT, kernel): 1}
    tiles = math.ceil(rows / (32 if want == TC else WALK_ROWS))
    assert split_row_tiles(kernel, rows, WALK_ROWS) == tiles
    (bufs,) = paged_flash._split_scratch.values()
    assert bufs["tickets"].numel() == b * h_kv * tiles and not bufs["tickets"].any()
    assert bufs["partials"].numel() == b * h_kv * s_workers * rows * (d + 2)
    args = lib.calls[0][1]
    part, n = bufs["partials"].data_ptr(), b * h_kv * s_workers * rows
    scratch = [part, part + 4 * n * d, part + 4 * n * (d + 1), bufs["tickets"].data_ptr()]
    if want == TC:  # after q, its strides, the pools, scales, geometry, tables, qpos, out
        assert [a.value for a in args[6:8]] == [
            scales[k].data_ptr() if scales else None for k in ("k_scale", "v_scale")]
        assert tuple(args[8]) == pool_tensor_map_geometry(k_pool)
        assert [a.value for a in args[12:16]] == scratch
        pool = {BF16: 0, torch.int8: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}[pool_dtype]
        assert args[16:24] == (pool, b, c, h_kv, g, bl, w, s_workers)
    else:  # after q, its strides, the pools, the scales, tables, qpos, out
        assert [a.value for a in args[11:15]] == scratch
        assert args[17:24] == (b, c, h_kv, g, d, bl, w) and args[24] == s_workers


def test_split_scratch_is_kept_per_card_and_stream(monkeypatch):
    """A call reuses the scratch of the last one on its stream: the same
    storage, the tickets not cleared again (every launch leaves them zero),
    so a call is one launch; a larger call allocates anew, zeroed; another
    stream has its own. The partials' three views do not overlap."""
    monkeypatch.setattr(paged_flash, "_split_scratch", {})
    acc, m, l, tickets = split_buffers(("cpu", 1), 2, 3, 4, 5, 64, 1, "cpu")
    assert acc.shape == (2, 3, 4, 5, 64) and m.shape == l.shape == (2, 3, 4, 5)
    assert tickets.shape == (6,) and tickets.dtype == torch.int32 and not tickets.any()
    ends = sorted((t.data_ptr(), t.data_ptr() + t.numel() * 4) for t in (acc, m, l))
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    tickets[0] = 7  # what the kernel never leaves behind: shows that no call clears it
    again = split_buffers(("cpu", 1), 2, 3, 4, 5, 64, 1, "cpu")
    assert again[0].data_ptr() == acc.data_ptr() and again[3][0] == 7
    smaller = split_buffers(("cpu", 1), 1, 3, 2, 5, 64, 1, "cpu")
    assert smaller[0].data_ptr() == acc.data_ptr() and smaller[3].numel() == 3
    grown = split_buffers(("cpu", 1), 2, 3, 4, 80, 64, 2, "cpu")
    assert grown[3].numel() == 12 and not grown[3].any()
    assert grown[0].data_ptr() != acc.data_ptr()
    other = split_buffers(("cpu", 2), 2, 3, 4, 5, 64, 1, "cpu")
    assert other[0].data_ptr() != grown[0].data_ptr() and not other[3].any()
    assert len(paged_flash._split_scratch) == 2


@pytest.mark.parametrize("rows,kernel,tiles", [(1, TENSOR_CORES, 1), (20, TENSOR_CORES, 1),
                                               (64, TENSOR_CORES, 2), (80, TENSOR_CORES, 3),
                                               (1, CUDA_CORES, 1), (20, CUDA_CORES, 3),
                                               (80, CUDA_CORES, 10)])
def test_split_row_tiles_follow_the_kernel(rows, kernel, tiles):
    assert split_row_tiles(kernel, rows, WALK_ROWS) == tiles


@pytest.mark.parametrize("c", [5, 20])
def test_reference_matches_jax_pallas_split_at_gqa_rows(c):
    """GQA, H 8 over H_kv 2: R = 20 and R = 80 rows a KV head, split_s 3 as
    chip_smoke.py checks the tensor-core split, with a long chain, padding
    rows and a fully masked batch row: the plain version against the Pallas
    split kernel and its jnp merge in interpret mode, fp32."""
    rng = np.random.default_rng(c)
    b, h, h_kv, d, bl, w = 3, 8, 2, 8, 4, 8
    n_blocks = 1 + b * w
    k_pool, v_pool = (rng.standard_normal((n_blocks, bl, h_kv, d)).astype(np.float32)
                      for _ in range(2))
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(b, w).astype(np.int32)
    q = rng.standard_normal((b, c, h, d)).astype(np.float32)
    pos = np.full((b, c), -1, np.int32)
    pos[0] = np.arange(31 - c + 1, 32)
    pos[1, :3] = np.arange(5, 8)
    want = jax_paged_flash_attention(*map(jnp.asarray, (q, k_pool, v_pool, tables, pos)),
                                     split_s=3, interpret=True)
    got = paged_attention_reference(*map(torch.from_numpy, (q, k_pool, v_pool, tables, pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not got[1, 3:].any() and not got[2].any()


def test_split_designs_tool_times_every_variant_of_its_source():
    """``tools/split_designs.py`` times the shipped split against the
    whole-pool-block design of ``tools/split_whole_blocks.cu``, every
    variant that the source's entry point takes."""
    from pytorch_distributed_tpu_torch.tools import split_designs

    source = split_designs.SOURCE.read_text()
    assert split_designs.SOURCE.is_file() and "pdt_split_wb" in source
    for variant in split_designs.VARIANTS:
        assert f"case {variant}: return launch<" in source
    assert f"case {len(split_designs.VARIANTS)}:" not in source
