"""The port's bottleneck-tail reductions against the JAX package's Pallas
kernels (``ops/bottleneck_tail.py``), which run in the Pallas interpreter
here, as ``tests/test_bottleneck_tail_kernels.py`` runs them.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against those on the card by ``chip_smoke.py``. Tolerances: fp32
sums in another order, 1e-5 relative to the largest value; in bf16 the
inputs are the same bf16 values and the sums fp32 on both sides, except
``tail_bwd_dz``, whose port rounds wa and c to bf16 for the product and
whose output is bf16: 2e-2 relative to the largest value (a few bf16 ulps).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.ops import bottleneck_tail as jbt
from pytorch_distributed_tpu_torch.ops import bottleneck_tail as bt

B, H, W, F, E = 3, 6, 6, 8, 32
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(x, dtypes):
    """The same values in both frameworks (rounded once to bf16 in numpy's
    float32 carrier, so both sides see equal bf16 numbers)."""
    jdt, tdt, _ = dtypes
    t = torch.from_numpy(x).to(tdt)
    return jnp.asarray(t.float().numpy(), jdt), t


def _close(got, want, rel):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rel * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_moments_matches_pallas(dtype):
    (z,) = _inputs(0, (B, H, W, F))
    jz, tz = _pair(z, DTYPES[dtype])
    js, jm2 = jbt.moments(jz)
    s, m2 = bt.moments(tz)
    assert s.dtype == m2.dtype == torch.float32
    rel = 1e-5
    _close(s, js, rel)
    _close(m2, jm2, rel)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tail_bwd_reduce_matches_pallas(dtype):
    z, g, out = _inputs(1, (B, H, W, F), (B, H, W, E), (B, H, W, E))
    (jz, tz), (jg, tg), (jo, to) = (_pair(x, DTYPES[dtype]) for x in (z, g, out))
    jgp, jp, jsb = jbt.tail_bwd_reduce(jz, jg, jo)
    gp, p, sb = bt.tail_bwd_reduce(tz, tg, to)
    assert gp.dtype == tg.dtype and gp.shape == tg.shape
    np.testing.assert_array_equal(gp.float().numpy(), np.asarray(jgp, np.float32))
    _close(p, jp, 1e-5)
    _close(sb, jsb, 1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tail_bwd_dz_matches_pallas(dtype):
    gp, z, wa, c, dmn = _inputs(2, (B, H, W, E), (B, H, W, F), (E, F), (F, F), (1, F))
    (jgp, tgp), (jz, tz) = (_pair(x, DTYPES[dtype]) for x in (gp, z))
    jdz = jbt.tail_bwd_dz(jgp, jz, jnp.asarray(wa), jnp.asarray(c), jnp.asarray(dmn))
    dz = bt.tail_bwd_dz(tgp, tz, *(torch.from_numpy(x) for x in (wa, c, dmn)))
    assert dz.dtype == tz.dtype and dz.shape == tz.shape
    _close(dz, jdz, DTYPES[dtype][2])


def test_wrappers_take_rows_and_channels_last_views():
    """A channels_last NCHW activation passes as its NHWC permute, a view;
    [N, C] rows give the same results."""
    z, g, out = _inputs(3, (B, F, H, W), (B, E, H, W), (B, E, H, W))
    tz, tg, to = (torch.from_numpy(x).contiguous(memory_format=torch.channels_last)
                  for x in (z, g, out))
    nz, ng, no = (x.permute(0, 2, 3, 1) for x in (tz, tg, to))
    assert bt.rows(nz).data_ptr() == tz.data_ptr()
    s, m2 = bt.moments(nz)
    s_r, m2_r = bt.moments(bt.rows(nz))
    torch.testing.assert_close(s, s_r)
    torch.testing.assert_close(m2, m2_r)
    gp, p, sb = bt.tail_bwd_reduce(nz, ng, no)
    assert gp.shape == ng.shape
    with pytest.raises(ValueError, match="view"):
        bt.rows(torch.from_numpy(z).permute(0, 2, 3, 1))  # NCHW memory: no [N, C] view


def test_wrappers_route_only_cpu_tensors_to_the_plain_version(monkeypatch):
    """CPU tensors run the plain version and count no launch; a CUDA tensor
    goes to the kernel, never to the plain version; other devices raise."""
    z, g, out = _inputs(4, (B, H, W, F), (B, H, W, E), (B, H, W, E))
    tz, tg, to = (torch.from_numpy(x) for x in (z, g, out))
    bt.reset_launch_counts()
    bt.moments(tz)
    gp, _, _ = bt.tail_bwd_reduce(tz, tg, to)
    bt.tail_bwd_dz(gp, tz, torch.zeros(E, F), torch.zeros(F, F), torch.zeros(F))
    assert bt.launch_counts == {bt.MOMENTS: 0, bt.BWD_REDUCE: 0, bt.BWD_DZ: 0}
    assert bt._on(types.SimpleNamespace(device=torch.device("cuda")), "x") is False
    with pytest.raises(ValueError, match="cuda or cpu"):
        bt.moments(torch.empty((4, F), device="meta"))

    class NoCard(Exception):
        pass

    def no_card():
        raise NoCard

    plain = []
    for name in ("moments_reference", "tail_bwd_reduce_reference", "tail_bwd_dz_reference"):
        monkeypatch.setattr(bt, name, lambda *a, name=name: plain.append(name))
    monkeypatch.setattr(bt, "_on", lambda x, name: False)  # as a CUDA tensor is routed
    monkeypatch.setattr(bt, "_library", no_card)
    with pytest.raises(NoCard):
        bt.moments(tz)
    with pytest.raises(NoCard):
        bt.tail_bwd_reduce(tz, tg, to)
    with pytest.raises(NoCard):
        bt.tail_bwd_dz(gp, tz, torch.zeros(E, F), torch.zeros(F, F), torch.zeros(F))
    assert plain == []
    assert bt.launch_counts == {bt.MOMENTS: 0, bt.BWD_REDUCE: 0, bt.BWD_DZ: 0}


@pytest.mark.parametrize("b, hw, f", [(128, 56, 64), (128, 28, 128), (128, 14, 256),
                                      (128, 7, 512), (3, 7, 40)])
def test_reduce_grid_sizes_the_partial_buffer(b, hw, f):
    """The deterministic reductions' chunks and fp32 partial buffer at
    ResNet-50's four expand-tail shapes (B 128, E = 4F) and a ragged one:
    chunks of a multiple of 32 rows, at least 128, covering the N rows
    exactly once; about four blocks per SM of an H100 (132 SMs) where N
    allows; one ``[F + 1, n_b]`` slice per chunk (row F the column sums),
    8.7 to 14.7 MB at the stage shapes."""
    n, e = b * hw * hw, 4 * f
    target_blocks = 4 * 132
    assert bt.BLOCKS_PER_SM == 4
    for gated, n_b in ((False, f), (True, e)):
        n_tiles, chunk, shape = bt.reduce_grid(n, f, n_b, gated, sms=132)
        n_i = -(-f // bt.TILE)
        assert n_tiles == (n_i * -(-e // bt.TILE) if gated else n_i * (n_i + 1) // 2)
        chunks = shape[0]
        assert chunk % bt.STEP == 0 and chunk >= bt.MIN_CHUNK
        assert (chunks - 1) * chunk < n <= chunks * chunk
        assert shape[1:] == (f + 1, n_b)
        if n >= target_blocks * bt.MIN_CHUNK:
            assert target_blocks * 0.9 <= n_tiles * chunks <= target_blocks * 1.1
        if b == 128:
            assert 8.7e6 <= 4 * np.prod(shape) <= 14.8e6
