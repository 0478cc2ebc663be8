"""Kernels 1 and 2, ``moments`` and ``tail_bwd_reduce``: the tensor maps and
tile plans of their bf16 kernel, which kernel a dtype runs, and the
kernel's split of the work emulated on the CPU.

bf16 rows run ``tail_reduce_wgmma_kernel`` (a TMA ring and wgmma): z, g and
out arrive as boxes of 64 channels x ``rows`` rows through 2-D tensor maps
laid over their row strides, boxes past an edge landing as zeros; gp is
gated in shared memory and stored by TMA; each block sums one chunk of rows
for one tile, and a merge kernel adds the chunks in a fixed order. fp32
rows run the CUDA-core kernel. Both run only on the card (``chip_smoke.py``
holds them against the plain version there, at ResNet-50's shapes, and two
launches bit for bit). Here: the maps' geometry, the plans, the routing, an
emulation of the kernel's tiles, chunks, boxes, gate, triangle and merge
that must reproduce the plain versions, and the plain versions against the
Pallas kernels (interpret mode) at channel counts that are no multiples of
64.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops import bottleneck_tail as jbt
from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt

STAGES = [(128, 56, 64), (128, 28, 128), (128, 14, 256), (128, 7, 512)]
DOWNSAMPLE = [(128, 56, 64), (128, 28, 256), (128, 14, 512), (128, 7, 1024)]
BOX = 64
H100_SMS = 132
SMEM_PER_BLOCK = 227 * 1024  # Hopper's most dynamic shared memory a block


def channels_last_rows(b, hw, c, dtype=torch.bfloat16, device="meta", pad=0):
    """The ``[N, C]`` rows of a channels_last NCHW activation, as the fused
    tail hands them over (``rows`` of its NHWC permute); ``pad`` channels
    more in memory than in the view."""
    x = torch.empty((b, c + pad, hw, hw), dtype=dtype, device=device)
    x = x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)
    return bt.rows(x[..., :c]) if pad else bt.rows(x)


def want_tiles(f, gated):
    """(kM, kN, rows a stage) that the plan tables give for F channels."""
    if gated:
        return (1, 4, 64) if f <= 64 else (2, 2, 64) if f <= 256 else (8, 1, 32)
    return (1, 1, 64) if f <= 64 else (2, 2, 64)


@pytest.mark.parametrize("b,hw,f", STAGES + DOWNSAMPLE[1:] + [(3, 7, 40)])
@pytest.mark.parametrize("gated", [False, True])
def test_plan_tiles_and_chunks(b, hw, f, gated):
    """The plan's tile comes from the table by F; its chunks are whole
    stages of whole 64-row boxes covering the N rows once; tiles x chunks
    is at most one block an SM of an H100 and close to it where N allows;
    the partial buffer holds one ``[F + 1, n_b]`` slice a chunk."""
    n = b * hw * hw
    n_b = 4 * f if gated else f
    plan = bt.reduce_plan(n, f, n_b, gated, H100_SMS)
    km, kn, rows = want_tiles(f, gated)
    assert (plan.km, plan.kn, plan.rows) == (km, kn, rows)
    t = bt.TILE_PLANS[plan.index]
    assert t.gated == gated and (t.km, t.kn, t.rows) == (km, kn, rows)
    n_i = -(-f // (BOX * km))
    want = n_i * -(-n_b // (BOX * kn)) if gated else n_i * (n_i + 1) // 2
    assert plan.n_tiles == want
    chunks = plan.part_shape[0]
    assert plan.chunk % BOX == 0 and plan.chunk % plan.rows == 0
    assert (chunks - 1) * plan.chunk < n <= chunks * plan.chunk
    assert plan.part_shape[1:] == (f + 1, n_b)
    blocks = plan.n_tiles * chunks
    assert blocks <= H100_SMS
    if n >= H100_SMS * BOX * 4:
        assert blocks >= 0.75 * H100_SMS


@pytest.mark.parametrize("sms", [78, 114, 132])
def test_plan_chunks_follow_the_cards_sms(sms):
    """The chunks are sized for the card the rows lie on: at stage 1 (one
    tile) about one block an SM of an H100 PCIe (114), an H100 SXM (132) or
    a smaller part (78), never more blocks than SMs."""
    n = 128 * 56 * 56
    for gated, n_b in ((False, 64), (True, 256)):
        plan = bt.reduce_plan(n, 64, n_b, gated, sms)
        assert plan.n_tiles == 1
        assert 0.9 * sms <= plan.part_shape[0] <= sms


def test_tile_plan_table_is_the_kernels():
    """``TILE_PLANS`` is read from ``csrc/tail_plans.cuh``, the table the
    kernel source instantiates (every bf16 reduction launch goes through
    it, by row index): each function has rows ordered by F with a last row
    for any F, every plan's chunk of rows is whole boxes, and each plan's
    ring fits a block's shared memory."""
    src = (bt.TILE_PLAN_SOURCE.parent / "bottleneck_tail.cu").read_text()
    assert src.count('#include "tail_plans.cuh"') == 2
    assert "tail_reduce_wgmma_kernel<" not in src.split("kPlanLaunch[] = {")[1].split("};")[0]
    assert [(t.gated, t.km, t.kn, t.rows) for t in bt.TILE_PLANS] == [
        (True, 1, 4, 64), (True, 2, 2, 64), (True, 8, 1, 32),
        (False, 1, 1, 64), (False, 2, 2, 64)]
    for gated in (True, False):
        rows = [t for t in bt.TILE_PLANS if t.gated == gated]
        assert [t.f_max for t in rows][-1] == 0
        limits = [t.f_max for t in rows][:-1]
        assert limits == sorted(limits) and all(limit % BOX == 0 for limit in limits)
        for t in rows:
            assert BOX % t.rows == 0 and t.rows % 32 == 0
            assert gated or t.km == t.kn
            boxes = t.km + (2 if gated else 1) * t.kn
            assert 1024 + t.stages * (boxes * t.rows * 128 + 16) <= SMEM_PER_BLOCK
            assert t.stages >= 3


@pytest.mark.parametrize("b,hw,f", STAGES)
def test_reduce_tiles_read_g_and_out_once_at_the_stages(b, hw, f):
    """At ResNet-50's four stages g and out, three quarters of
    tail_bwd_reduce's bytes, go to one block a row range: the tile spans F,
    or (F = 256) the F tiles of a row range are neighbours in block order."""
    plan = bt.reduce_plan(b * hw * hw, f, 4 * f, gated=True, sms=H100_SMS)
    n_i = -(-f // (BOX * plan.km))
    assert n_i == (2 if f == 256 else 1)


@pytest.mark.parametrize("b,hw,f,pad", [(b, hw, f, 0) for b, hw, f in STAGES + DOWNSAMPLE]
                         + [(3, 7, 40, 0), (8, 14, 256, 8)])
def test_geometry_of_z_g_out_and_gp(b, hw, f, pad):
    """Each map is (columns, rows, row stride in bytes, box 64 x rows): z, g
    and out as the stage's channels_last activations (z also as rows 16
    bytes wider than its channels), gp contiguous; strides meet TMA's
    16-byte rule."""
    e, n = 4 * f, b * hw * hw
    z = channels_last_rows(b, hw, f, pad=pad)
    g, out = channels_last_rows(b, hw, e), channels_last_rows(b, hw, e, pad=pad)
    gp = torch.empty((n, e), dtype=torch.bfloat16, device="meta")
    for gated in (False, True):
        rows = bt.reduce_plan(n, f, e if gated else f, gated, H100_SMS).rows
        maps = bt.reduce_tensor_map_geometry(rows, z, g, out, gp) if gated else (
            bt.reduce_tensor_map_geometry(rows, z))
        want = [(f, n, 2 * (f + pad), BOX, rows)]
        if gated:
            want += [(e, n, 2 * e, BOX, rows), (e, n, 2 * (e + pad), BOX, rows),
                     (e, n, 2 * e, BOX, rows)]
        assert list(maps) == want
        assert all(m[2] % 16 == 0 for m in maps)


def box(t, geo, c0, r0):
    """The box of tensor map ``geo`` over ``t`` at (column c0, row r0), as
    TMA lands it: fp32 values, zeros past the tensor's edges."""
    cols, rows, stride, bc, br = geo
    e = t.element_size()
    out = torch.zeros((br, bc))
    nr, nc = max(0, min(br, rows - r0)), max(0, min(bc, cols - c0))
    if nr and nc:
        flat = t.as_strided((t.untyped_storage().nbytes() // e,), (1,), 0)
        start = t.storage_offset() + r0 * (stride // e) + c0
        out[:nr, :nc] = flat.as_strided((nr, nc), (stride // e, 1), start).float()
    return out


def emulate(z2, g2=None, o2=None, plan=None):
    """The bf16 kernel's split of the work on the CPU: for each (chunk,
    tile) block, its stages of boxes from the maps, the gate and gp's stores
    (first F tile only), the units' fp32 products and the column sums (the
    owner only), written to the partial buffer; then the merge: the chunks
    in ``merge_runs`` runs, each added in ascending order, the runs in
    ascending order; moments' lower triangle mirrored. Returns (gp, out,
    column sums)."""
    gated = g2 is not None
    n, f = z2.shape
    n_b = g2.shape[1] if gated else f
    plan = plan or bt.reduce_plan(n, f, n_b, gated, H100_SMS)
    km, kn, rows = plan.km, plan.kn, plan.rows
    gp = torch.zeros((n, n_b), dtype=torch.bfloat16) if gated else None
    maps = (bt.reduce_tensor_map_geometry(rows, z2, g2, o2, gp) if gated
            else bt.reduce_tensor_map_geometry(rows, z2))
    n_ti = -(-f // (BOX * km))
    if gated:
        tiles = [(t % n_ti, t // n_ti) for t in range(plan.n_tiles)]
    else:
        tiles = [(i, j) for i in range(n_ti) for j in range(i, n_ti)]
    assert len(tiles) == plan.n_tiles
    partial = torch.full(plan.part_shape, float("nan"))
    for chunk in range(plan.part_shape[0]):
        r_begin = chunk * plan.chunk
        r_end = min(r_begin + plan.chunk, n)
        for ti, tj in tiles:
            i0, j0 = ti * km * BOX, tj * kn * BOX
            diag, owner = (not gated and ti == tj), (ti == 0 if gated else ti == tj)
            acc = torch.zeros((km, kn, BOX, BOX))
            csum = torch.zeros(kn * BOX)
            for r0 in range(r_begin, r_end, rows):
                a = [box(z2, maps[0], i0 + m * BOX, r0) for m in range(km)]
                if diag:
                    b = a
                elif not gated:
                    b = [box(z2, maps[0], j0 + m * BOX, r0) for m in range(kn)]
                else:
                    b = []
                    for m in range(kn):
                        gv = box(g2, maps[1], j0 + m * BOX, r0)
                        ov = box(o2, maps[2], j0 + m * BOX, r0)
                        gv = torch.where(ov > 0, gv, torch.zeros(()))
                        b.append(gv)
                        if owner:  # the TMA store, clipped at gp's edges
                            nr, nc = min(rows, n - r0), min(BOX, n_b - j0 - m * BOX)
                            if nc > 0:
                                gp[r0:r0 + nr, j0 + m * BOX:j0 + m * BOX + nc] = (
                                    gv[:nr, :nc].to(torch.bfloat16))
                if owner:
                    csum += torch.cat(b, 1).sum(0)
                for mi in range(km):
                    for ni in range(kn):
                        acc[mi, ni] += a[mi].T @ b[ni]
            part = partial[chunk]
            for mi in range(km):
                for ni in range(kn):
                    if not gated and ti * km + mi > tj * kn + ni:
                        continue  # below moments' diagonal: not written
                    r, c = i0 + mi * BOX, j0 + ni * BOX
                    nr, nc = min(BOX, f - r), min(BOX, n_b - c)
                    if nr > 0 and nc > 0:
                        part[r:r + nr, c:c + nc] = acc[mi, ni, :nr, :nc]
            if owner:
                nc = min(kn * BOX, n_b - j0)
                part[f, j0:j0 + nc] = csum[:nc]
    chunks = plan.part_shape[0]
    n_runs = 8 if chunks >= 8 else 4 if chunks >= 4 else 2 if chunks >= 2 else 1
    per_run = -(-chunks // n_runs)
    total = None
    for run in range(n_runs):
        s = torch.zeros(plan.part_shape[1:])
        for c in range(run * per_run, min(chunks, (run + 1) * per_run)):
            s = s + partial[c]
        total = s if total is None else total + s
    out, colsum = total[:f].clone(), total[f].clone()
    if not gated:
        for i in range(-(-f // BOX)):
            for j in range(i):  # the lower tiles: the upper ones' sums, mirrored
                out[i * BOX:(i + 1) * BOX, j * BOX:(j + 1) * BOX] = (
                    out[j * BOX:(j + 1) * BOX, i * BOX:(i + 1) * BOX].T)
    return gp, out, colsum


EMULATED = [(147, 40, 0), (392, 128, 8), (98, 256, 0), (98, 512, 8)]


def _operands(n, f, pad, seed):
    rng = np.random.default_rng(seed)
    e = 4 * f

    def bf(shape, relu=False):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(np.maximum(x, 0) if relu else x).to(torch.bfloat16)

    z = bf((n, f + pad), relu=True)[:, :f]  # rows wider than their channels where pad
    g, out = bf((n, e)), bf((n, e + pad))[:, :e]
    out[0, :3] = torch.tensor([float("nan"), -0.0, 0.0])  # the gate gives 0 at all three
    return z, g, out


@pytest.mark.parametrize("n,f,pad", EMULATED)
def test_emulated_moments_reproduce_the_plain_version(n, f, pad):
    """The kernel's tiles (the upper triangle of its super-tiles, diagonal
    ones reading one set of boxes), chunks, clipped boxes and merge give
    the plain version's Σz and zᵀz, the lower half equal bit for bit to the
    upper, and the same bits twice."""
    z, _, _ = _operands(n, f, pad, seed=n + f)
    _, m2, s = emulate(z)
    want_s, want_m2 = bt.moments_reference(z)
    for got, want in ((s, want_s), (m2, want_m2)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(m2, m2.T)
    _, m2_again, s_again = emulate(z)
    assert torch.equal(m2.view(torch.int32), m2_again.view(torch.int32))
    assert torch.equal(s.view(torch.int32), s_again.view(torch.int32))


@pytest.mark.parametrize("n,f,pad", EMULATED)
def test_emulated_tail_bwd_reduce_reproduces_the_plain_version(n, f, pad):
    """The kernel's tiles (spanning F, or F tiles side by side whose first
    one owns gp and the sums), chunks, clipped boxes, gate in the box and
    merge give the plain version's gp bit for bit (NaN, -0 and 0 in out
    give 0), and its P and Σgp; the same bits twice."""
    z, g, out = _operands(n, f, pad, seed=n + f + 1)
    gp, p, sb = emulate(z, g, out)
    want_gp, want_p, want_sb = bt.tail_bwd_reduce_reference(z, g, out)
    assert torch.equal(gp.view(torch.int16), want_gp.view(torch.int16))
    assert (gp[0, :3] == 0).all()
    for got, want in ((p, want_p), (sb, want_sb)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    gp2, p2, sb2 = emulate(z, g, out)
    assert torch.equal(gp.view(torch.int16), gp2.view(torch.int16))
    assert torch.equal(p.view(torch.int32), p2.view(torch.int32))
    assert torch.equal(sb.view(torch.int32), sb2.view(torch.int32))


class FakeLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "pdt_moments_tc"),
                                        (torch.float32, "pdt_moments")])
def test_moments_routes_bf16_to_the_wgmma_kernel_and_fp32_to_cuda_cores(dtype, want,
                                                                       monkeypatch):
    """bf16 rows: the TMA + wgmma entry point with z's map and the plan's
    row and chunk; fp32 rows: the CUDA-core entry point with z's row stride
    and the fp32 grid's chunk; both sized for the card's SM count. One
    launch counted either way."""
    lib = FakeLibrary()
    monkeypatch.setattr(bt, "_library", lambda: lib)
    monkeypatch.setattr(bt, "_on", lambda x, name: False)  # as a CUDA tensor is routed
    monkeypatch.setattr(bt, "_stream", lambda t: ctypes.c_void_p(None))
    monkeypatch.setattr(bt, "card_sms", lambda device: 1)
    b, hw, f = 2, 7, 64
    n = b * hw * hw
    z = channels_last_rows(b, hw, f, dtype, "cpu", pad=8).view(b, hw, hw, f)
    bt.reset_launch_counts()
    s, m2 = bt.moments(z)
    assert s.shape == (f,) and m2.shape == (f, f) and m2.dtype == torch.float32
    assert [name for name, _ in lib.calls] == [want]
    assert bt.launch_counts == {bt.MOMENTS: 1, bt.BWD_REDUCE: 0, bt.BWD_DZ: 0}
    args = lib.calls[0][1]
    if dtype == torch.bfloat16:
        plan = bt.reduce_plan(n, f, f, gated=False, sms=1)
        assert plan.chunk != bt.reduce_plan(n, f, f, gated=False, sms=H100_SMS).chunk
        assert list(args[1]) == [f, n, 2 * (f + 8), BOX, plan.rows]
        assert args[2:6] == (n, f, plan.index, plan.chunk)
        assert not bt.TILE_PLANS[plan.index].gated
    else:
        chunk = bt.reduce_grid(n, f, f, False, sms=1)[1]
        assert args[1] == f + 8 and args[2:5] == (n, f, chunk)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "pdt_tail_bwd_reduce_tc"),
                                        (torch.float32, "pdt_tail_bwd_reduce")])
def test_tail_bwd_reduce_routes_bf16_to_the_wgmma_kernel_and_fp32_to_cuda_cores(
        dtype, want, monkeypatch):
    """bf16 rows: the TMA + wgmma entry point with the maps of z, g, out and
    gp and the plan's row and chunk; fp32 rows: the CUDA-core entry point
    with the row strides; both sized for the card's SM count. One launch
    counted either way; gp shaped as g."""
    lib = FakeLibrary()
    monkeypatch.setattr(bt, "_library", lambda: lib)
    monkeypatch.setattr(bt, "_on", lambda x, name: False)
    monkeypatch.setattr(bt, "_stream", lambda t: ctypes.c_void_p(None))
    monkeypatch.setattr(bt, "card_sms", lambda device: 1)
    b, hw, f = 2, 7, 128
    e, n = 4 * f, b * hw * hw
    z = channels_last_rows(b, hw, f, dtype, "cpu").view(b, hw, hw, f)
    g = channels_last_rows(b, hw, e, dtype, "cpu").view(b, hw, hw, e)
    out = channels_last_rows(b, hw, e, dtype, "cpu", pad=8).view(b, hw, hw, e)
    bt.reset_launch_counts()
    gp, p, sb = bt.tail_bwd_reduce(z, g, out)
    assert gp.shape == g.shape and gp.dtype == dtype
    assert p.shape == (f, e) and sb.shape == (e,)
    assert [name for name, _ in lib.calls] == [want]
    assert bt.launch_counts == {bt.MOMENTS: 0, bt.BWD_REDUCE: 1, bt.BWD_DZ: 0}
    args = lib.calls[0][1]
    if dtype == torch.bfloat16:
        plan = bt.reduce_plan(n, f, e, gated=True, sms=1)
        r = plan.rows
        assert list(args[4]) == [f, n, 2 * f, BOX, r, e, n, 2 * e, BOX, r,
                                 e, n, 2 * (e + 8), BOX, r, e, n, 2 * e, BOX, r]
        assert args[5:10] == (n, f, e, plan.index, plan.chunk)
        assert bt.TILE_PLANS[plan.index].gated
    else:
        assert (args[1], args[3], args[5]) == (f, e, e + 8)
        assert args[7] == bt.reduce_grid(n, f, e, True, sms=1)[1]
        assert args[11:14] == (n, f, e)


@pytest.mark.parametrize("f,e", [(40, 160), (64, 256)])
def test_plain_reductions_match_pallas(f, e):
    """moments and tail_bwd_reduce's plain versions (what the wrappers run
    on the CPU) against the JAX package's Pallas kernels in interpret mode,
    fp32, at a channel count that is no multiple of 64 (the kernel's
    zero-filled boxes) and at stage 1's: sums to 1e-5 of their largest
    value, gp equal."""
    rng = np.random.default_rng(f)
    z, g, out = (rng.standard_normal(s).astype(np.float32)
                 for s in ((2, 3, 3, f), (2, 3, 3, e), (2, 3, 3, e)))
    js, jm2 = jbt.moments(jnp.asarray(z))
    s, m2 = bt.moments(torch.from_numpy(z))
    jgp, jp, jsb = jbt.tail_bwd_reduce(*map(jnp.asarray, (z, g, out)))
    gp, p, sb = bt.tail_bwd_reduce(*map(torch.from_numpy, (z, g, out)))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(jgp))
    for got, want in ((s, js), (m2, jm2), (p, jp), (sb, jsb)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
