"""The port's rings against the JAX package's.

``ops.ring_flash.ring_flash_attention`` (the flash kernels per visit, here
their plain versions) and ``parallel.sequence.ring_attention`` (plain
PyTorch) run in ranks spawned over gloo, with a ``file://`` rendezvous
under the test's temporary directory, at sp 2 (on a 2 x 2 data x seq grid)
and sp 4, in both layouts, with both backwards, causal and full. Their
values and all three gradients, gathered from the ranks, are held against
JAX ``parallel.sequence.ring_attention`` under ``shard_map`` on the virtual
CPU devices and against JAX ``dense_attention`` on the whole sequence. Each
grid is one spawn, which runs every case; inputs are numpy from a seed.

Tolerances: fp32, the JAX ring tests' own (``tests/test_ring_flash.py``):
values 2e-5, gradients 5e-4 relative and 5e-5 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from pytorch_distributed_tpu.ops.attention import dense_attention as jax_dense
from pytorch_distributed_tpu.parallel import make_mesh as jax_make_mesh
from pytorch_distributed_tpu.parallel.mesh import DATA_AXIS, SEQ_AXIS, shard_map
from pytorch_distributed_tpu.parallel.sequence import ring_attention as jax_ring
from pytorch_distributed_tpu.parallel.sequence import zigzag_shard as jax_zigzag_shard
from pytorch_distributed_tpu.parallel.sequence import zigzag_unshard as jax_zigzag_unshard
from pytorch_distributed_tpu_torch.parallel.sequence import (
    zigzag_positions,
    zigzag_shard,
    zigzag_unshard,
)
from pytorch_distributed_tpu_torch.tools import ring_check

VALUE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
GRIDS = {"dp2xsp2": (2, 2), "dp1xsp4": (1, 4)}
CASES = [dict(impl=impl, layout=layout, bwd_impl=bwd, causal=causal)
         for impl in ("ring_flash", "ring") for layout in ("contiguous", "zigzag")
         for bwd in (("fused", "split") if impl == "ring_flash" else ("fused",))
         for causal in (True, False) if causal or layout == "contiguous"]
SHAPE = (2, 64, 2, 16)  # B, L, H, D: the JAX ring tests' shape


@pytest.mark.parametrize("s", [1, 2, 4])
def test_zigzag_layout_is_jaxs(s):
    x = np.arange(2 * 16 * 3).reshape(2, 16, 3)
    want = jax_zigzag_shard(x, s)
    np.testing.assert_array_equal(zigzag_shard(x, s), want)
    np.testing.assert_array_equal(zigzag_shard(torch.from_numpy(x), s).numpy(), want)
    np.testing.assert_array_equal(zigzag_unshard(want, s), jax_zigzag_unshard(want, s))
    np.testing.assert_array_equal(zigzag_unshard(torch.from_numpy(want), s).numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        zigzag_shard(np.zeros((1, 6)), 2)
    # each shard's wpe positions are its chunks' absolute positions
    pos = np.arange(16)[None]
    lay = zigzag_shard(pos, s)[0]
    for r in range(s):
        n = 16 // s
        np.testing.assert_array_equal(zigzag_positions(n, s, r).numpy(),
                                      lay[r * n:(r + 1) * n])


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """One spawn per grid over every case; results by grid and case."""
    out = {}
    for grid, (dp, sp) in GRIDS.items():
        tmp = tmp_path_factory.mktemp(grid)
        job = dict(task="attention", backend="gloo", rendezvous=f"file://{tmp}/rendezvous",
                   out=str(tmp / "out"), dp=dp, sp=sp, device="cpu", dtype="float32",
                   seed=0, shape=SHAPE, cases=CASES, timeout_s=120)
        ring_check.run(job, dp * sp)
        out[grid] = (job, ring_check.load(job))
    return out


@functools.lru_cache(maxsize=None)
def jax_reference(dp: int, sp: int, layout: str, causal: bool, impl: str):
    """Values and (dq, dk, dv) of the JAX XLA ring under shard_map, or of
    dense attention, in the global contiguous order."""
    q, k, v, do = (jnp.asarray(x) for x in ring_check.attention_inputs(
        dict(seed=0, shape=SHAPE)))
    if impl == "dense":
        out, vjp = jax.vjp(lambda a, b, c: jax_dense(a, b, c, causal=causal), q, k, v)
        return [np.asarray(x) for x in (out, *vjp(do))]
    mesh = jax_make_mesh(jax.devices()[:dp * sp], data_parallel=dp, seq_parallel=sp)
    spec = P(DATA_AXIS, SEQ_AXIS)
    # remat only trades memory for recomputation: off, the compile is shorter
    fn = shard_map(functools.partial(jax_ring, causal=causal, layout=layout, remat=False),
                   mesh=mesh, in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    sh = NamedSharding(mesh, spec)
    lay = (lambda x: jax_zigzag_shard(x, sp)) if layout == "zigzag" else (lambda x: x)
    unlay = (lambda x: jax_zigzag_unshard(np.asarray(x), sp)) if layout == "zigzag" \
        else np.asarray

    @jax.jit
    def value_and_grads(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out, *vjp(do))

    return [unlay(x) for x in value_and_grads(*(jax.device_put(lay(x), sh)
                                                for x in (q, k, v, do)))]


@pytest.mark.parametrize("case", CASES, ids=ring_check.case_name)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_ring_matches_jax_ring_and_dense(ring_runs, grid, case):
    job, results = ring_runs[grid]
    dp, sp = GRIDS[grid]
    name = ring_check.case_name(case)
    got = [ring_check.gather([r[name][key] for r in results], dp, sp, case["layout"]).numpy()
           for key in ("o", "dq", "dk", "dv")]
    for ref in ("ring", "dense"):
        want = jax_reference(dp, sp, case["layout"], case["causal"], ref)
        np.testing.assert_allclose(got[0], want[0], **VALUE_TOL)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, **GRAD_TOL)


def test_ring_checks_refuse_what_jax_refuses():
    from pytorch_distributed_tpu_torch.ops.ring_flash import check_ring_args

    with pytest.raises(ValueError, match="equal Q/KV shard lengths"):
        check_ring_args(8, 6, True, "contiguous", "fused")
    with pytest.raises(ValueError, match="unknown layout"):
        check_ring_args(8, 8, True, "spiral", "fused")
    with pytest.raises(ValueError, match="only changes causal scheduling"):
        check_ring_args(8, 8, False, "zigzag", "fused")
    with pytest.raises(ValueError, match="even shard length"):
        check_ring_args(7, 7, True, "zigzag", "fused")
    check_ring_args(8, 8, True, "zigzag", "split")


def test_ring_without_a_mesh_raises():
    from pytorch_distributed_tpu_torch.ops.ring_flash import ring_flash_attention
    from pytorch_distributed_tpu_torch.parallel import mesh

    saved = dict(mesh._groups)
    mesh._groups.clear()
    try:
        x = torch.zeros(1, 4, 1, 16)
        with pytest.raises(RuntimeError, match="make_mesh"):
            ring_flash_attention(x, x, x, causal=True)
    finally:
        mesh._groups.update(saved)
