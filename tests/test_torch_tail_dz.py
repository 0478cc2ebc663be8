"""Kernel 3, ``tail_bwd_dz``: the tensor maps its bf16 kernel reads, and
which kernel a dtype runs.

bf16 rows run ``tail_dz_wgmma_kernel`` (TMA and wgmma): A is read through
two 2-D tensor maps, gp ``[N, E]`` and z ``[N, F]`` each by its own row
stride, B through wa ``[E, F]`` and c ``[F, F]``, all in 64 x 64 boxes that
land as zeros past an operand's edge; fp32 rows run the CUDA-core kernel.
Both run only on the card (``chip_smoke.py`` holds them against the plain
version there, at ResNet-50's four stages, and two launches bit for bit).
Here: the maps' geometry at the four stages and for rows wider than their
channels, the product that the kernel's boxes compute (its tile and k-step
walk emulated on the CPU through that geometry), the routing, and the plain
version against the Pallas kernel (interpret mode) at channel counts that
are no multiples of 64.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops import bottleneck_tail as jbt
from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt
from pytorch_distributed_tpu_torch.ops.bottleneck_tail import dz_tensor_map_geometry

STAGES = [(128, 56, 64), (128, 28, 128), (128, 14, 256), (128, 7, 512)]
BOX = 64


def channels_last_rows(b, hw, c, dtype=torch.bfloat16, device="meta"):
    """The ``[N, C]`` rows of a channels_last NCHW activation, as the fused
    tail hands them over (``rows`` of its NHWC permute)."""
    x = torch.empty((b, c, hw, hw), dtype=dtype, device=device)
    return bt.rows(x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1))


@pytest.mark.parametrize("b,hw,f", STAGES)
def test_dz_geometry_at_resnet50_stages(b, hw, f):
    """Each map is (columns, rows, row stride in bytes, box 64 x 64): gp and
    z of the stage's channels_last activations, wa and c contiguous; the K
    loop's ceil(E / 64) + ceil(F / 64) steps cover K = E + F exactly."""
    e, n = 4 * f, b * hw * hw
    gp, z = channels_last_rows(b, hw, e), channels_last_rows(b, hw, f)
    wa, c = (torch.empty(s, dtype=torch.bfloat16, device="meta") for s in ((e, f), (f, f)))
    geometry = dz_tensor_map_geometry(gp, z, wa, c)
    assert geometry == ((e, n, 2 * e, BOX, BOX), (f, n, 2 * f, BOX, BOX),
                        (f, e, 2 * f, BOX, BOX), (f, f, 2 * f, BOX, BOX))
    assert all(g[2] % 16 == 0 for g in geometry)  # TMA's stride rule
    assert (-(-e // BOX) + -(-f // BOX)) * BOX == e + f


def test_dz_geometry_of_rows_wider_than_their_channels():
    """gp and z as column slices of wider rows: the maps take the rows'
    own stride, so no copy is made."""
    e, f = 256, 64
    wide = torch.empty((2, 7, 7, e + 8), dtype=torch.bfloat16, device="meta")
    gp = bt.rows(wide[..., :e])
    z = bt.rows(torch.empty((2, 7, 7, f + 16), dtype=torch.bfloat16, device="meta")[..., :f])
    wa, c = (torch.empty(s, dtype=torch.bfloat16, device="meta") for s in ((e, f), (f, f)))
    geometry = dz_tensor_map_geometry(gp, z, wa, c)
    assert geometry[0] == (e, 98, 2 * (e + 8), BOX, BOX)
    assert geometry[1] == (f, 98, 2 * (f + 16), BOX, BOX)


def box(t: torch.Tensor, geo, c0: int, r0: int) -> torch.Tensor:
    """The 64 x 64 box of tensor map ``geo`` over ``t``'s storage at
    (column c0, row r0), zeros past its edges, as TMA lands it."""
    cols, rows, stride, bc, br = geo
    e = t.element_size()
    flat = t.as_strided((t.untyped_storage().nbytes() // e,), (1,), 0)
    out = torch.zeros((br, bc), dtype=torch.float32)
    for r in range(br):
        if r0 + r < rows:
            n = max(0, min(bc, cols - c0))
            start = (r0 + r) * (stride // e) + c0
            out[r, :n] = flat[start:start + n].float()
    return out


@pytest.mark.parametrize("n,e,f,pad", [(147, 160, 40, 0), (200, 256, 128, 8), (64, 64, 64, 0)])
def test_dz_boxes_compute_the_product(n, e, f, pad):
    """The kernel's walk, emulated: output tiles of 128 rows x 64 kNB
    columns (kNB = 2 past F = 64), k steps of 64 over gp and wa, then z and
    c, each box from its map; the sums equal [gp | z] @ [wa ; c] + dmn,
    including where E, F and N are no multiples of 64 (zero-filled boxes)
    and gp's rows are wider than its channels."""
    rng = np.random.default_rng(n + e)
    gp = torch.from_numpy(rng.standard_normal((n, e + pad), np.float32)).to(torch.bfloat16)
    gp = gp[:, :e]
    z = torch.from_numpy(rng.standard_normal((n, f), np.float32)).to(torch.bfloat16)
    wa, c = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(torch.bfloat16)
             for s in ((e, f), (f, f)))
    dmn = torch.from_numpy(rng.standard_normal(f, np.float32))
    g_gp, g_z, g_wa, g_c = dz_tensor_map_geometry(gp, z, wa, c)
    knb = 2 if f > BOX else 1
    out = torch.zeros((n, f))
    for m0 in range(0, n, 128):
        for n0 in range(0, f, knb * BOX):
            acc = torch.zeros((128, knb * BOX))
            for ks in range(-(-e // BOX) + -(-f // BOX)):
                lo = ks < -(-e // BOX)
                k0 = (ks if lo else ks - -(-e // BOX)) * BOX
                a_t, a_g, b_t, b_g = (gp, g_gp, wa, g_wa) if lo else (z, g_z, c, g_c)
                a = torch.cat([box(a_t, a_g, k0, m0), box(a_t, a_g, k0, m0 + BOX)])
                bm = torch.cat([box(b_t, b_g, n0 + i * BOX, k0) for i in range(knb)], dim=1)
                acc += a @ bm
            rows, cols = min(128, n - m0), min(knb * BOX, f - n0)
            out[m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols] + dmn[n0:n0 + cols]
    want = gp.float() @ wa.float() + z.float() @ c.float() + dmn
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)


class FakeLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "pdt_tail_bwd_dz_tc"),
                                        (torch.float32, "pdt_tail_bwd_dz")])
def test_dz_routes_bf16_to_the_wgmma_kernel_and_fp32_to_cuda_cores(dtype, want, monkeypatch):
    """bf16 rows: the TMA + wgmma entry point with the four maps' geometry
    and wa, c rounded to bf16 once (contiguous); fp32 rows: the CUDA-core
    entry point with w = [wa ; c]. One launch counted either way."""
    lib = FakeLibrary()
    monkeypatch.setattr(bt, "_library", lambda: lib)
    monkeypatch.setattr(bt, "_on", lambda x, name: False)  # as a CUDA tensor is routed
    monkeypatch.setattr(bt, "_stream", lambda t: ctypes.c_void_p(None))
    b, hw, f = 2, 7, 64
    e = 4 * f
    gp = channels_last_rows(b, hw, e, dtype, "cpu").view(b, hw, hw, e)
    z = channels_last_rows(b, hw, f, dtype, "cpu").view(b, hw, hw, f)
    wa, c, dmn = torch.randn(e, f), torch.randn(f, f), torch.randn(f)
    bt.reset_launch_counts()
    dz = bt.tail_bwd_dz(gp, z, wa, c, dmn)
    assert dz.shape == z.shape and dz.dtype == dtype
    assert [name for name, _ in lib.calls] == [want]
    assert bt.launch_counts[bt.BWD_DZ] == 1
    args = lib.calls[0][1]
    if dtype == torch.bfloat16:
        n = b * hw * hw
        assert list(args[4]) == [v for g in ((e, n, 2 * e, BOX, BOX), (f, n, 2 * f, BOX, BOX),
                                             (f, e, 2 * f, BOX, BOX), (f, f, 2 * f, BOX, BOX))
                                 for v in g]
        assert args[7:10] == (n, f, e)
    else:
        assert args[1] == e and args[3] == f and args[7:10] == (b * hw * hw, f, e)


def test_plain_dz_matches_pallas_at_ragged_channels():
    """E = 160, F = 40 (the kernel's zero-filled boxes): the plain version
    against the JAX package's Pallas kernel in interpret mode, fp32, to
    1e-5 of the largest value."""
    rng = np.random.default_rng(5)
    gp, z, wa, c, dmn = (rng.standard_normal(s).astype(np.float32)
                         for s in ((2, 3, 3, 160), (2, 3, 3, 40), (160, 40), (40, 40), (1, 40)))
    want = np.asarray(jbt.tail_bwd_dz(*map(jnp.asarray, (gp, z, wa, c, dmn))))
    got = bt.tail_bwd_dz(*map(torch.from_numpy, (gp, z, wa, c, dmn))).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
