"""The fp16 loss scaler and its data-parallel step against the JAX
package's.

- ``DynamicLossScaler`` against JAX's over a seeded sequence of finite
  flags, growth and backoff included, from a state carried across by
  ``scaler_from_jax``; scaling and unscaling bit for bit in fp32;
- an fp16 DP step (fp32 compute plus the scaler, the recipes' mapping) on
  two gloo ranks with an inf planted in rank 1's rows at step 1, against
  JAX ``make_train_step`` over a 2-device mesh (``tests/test_train.py``'s
  ``test_fp16_dynamic_scaler_skips_nonfinite`` pattern): every rank skips
  the update, parameters and momenta stay, the scale halves, the BatchNorm
  statistics take the step's update as JAX's do, and the next step's lr
  comes from the applied updates (a ``step_lr`` boundary right after the
  skip). Tolerances as ``test_torch_resnet_dp.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resnet_dp import (
    PLANT,
    SCHEDULE,
    assert_tree_close,
    batches,
    jax_state,
    planted,
    spawn,
    spec,
    variables,
)

from pytorch_distributed_tpu.ops.precision import DynamicLossScaler as JaxScaler
from pytorch_distributed_tpu.ops.precision import all_finite as jax_all_finite
from pytorch_distributed_tpu.parallel import replicated_sharding, shard_batch
from pytorch_distributed_tpu.train.step import make_train_step as jax_make_train_step
from pytorch_distributed_tpu_torch.models.convert import (
    resnet_params_from_jax,
    resnet_params_to_jax,
    scaler_from_jax,
)
from pytorch_distributed_tpu_torch.ops.precision import (
    DynamicLossScaler,
    NoOpLossScaler,
    all_finite,
)

SCALER = dict(init_scale=2.0 ** 10, growth_interval=1)  # grows every finite step


def test_scaler_follows_jax_over_a_seeded_flag_sequence():
    flags = np.random.default_rng(4).random(40) < 0.8
    jax_s = JaxScaler.create(init_scale=2.0 ** 15, growth_interval=3)
    for f in flags[:5]:  # both start from this state
        jax_s = jax_s.update(jnp.asarray(f))
    ours = scaler_from_jax(jax_s)
    assert ours.growth_interval == 3 and ours.growth_factor == 2.0
    grew = backed_off = 0
    for f in flags[5:]:
        before = float(ours.scale)
        jax_s = jax_s.update(jnp.asarray(f))
        ours = ours.update(torch.tensor(bool(f)))
        assert float(ours.scale) == float(jax_s.scale)
        assert int(ours.growth_tracker) == int(jax_s.growth_tracker)
        assert ours.scale.dtype == torch.float32 and ours.growth_tracker.dtype == torch.int32
        grew += float(ours.scale) > before
        backed_off += float(ours.scale) < before
    assert grew and backed_off
    rng = np.random.default_rng(5)
    loss = rng.standard_normal((), np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2)]
    np.testing.assert_array_equal(ours.scale_loss(torch.tensor(loss)).numpy(),
                                  np.asarray(jax_s.scale_loss(jnp.asarray(loss))))
    got = ours.unscale_grads([torch.from_numpy(g.copy()) for g in grads])
    for g, want in zip(got, jax_s.unscale_grads([jnp.asarray(g) for g in grads])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_all_finite_and_the_no_op_scaler():
    a = [torch.ones(3), torch.zeros(2, dtype=torch.int32)]
    for bad in (float("inf"), float("nan")):
        b = [torch.ones(3), torch.tensor([1.0, bad])]
        assert not bool(all_finite(b)) and not bool(jax_all_finite([x.numpy() for x in b]))
    assert bool(all_finite(a)) and bool(all_finite([]))
    s = NoOpLossScaler()
    assert s.scale == 1.0 and s.update(torch.tensor(False)) is s and s.to("cpu") is s
    d = DynamicLossScaler.create()
    assert float(d.scale) == 2.0 ** 16 and int(d.growth_tracker) == 0


def jax_fp16_run(kind: str):
    state, mesh = jax_state(kind == "fused", False, scaler=JaxScaler.create(**SCALER))
    state = jax.device_put(state, replicated_sharding(mesh))
    step = jax_make_train_step(mesh)
    metrics, scales = [], []
    for i, b in enumerate(batches()):
        state, m = step(state, shard_batch(mesh, planted(b) if i == PLANT[0] else b))
        metrics.append({k: float(v) for k, v in m.items()})
        scales.append(float(state.scaler.scale))
    return metrics, scales, variables(jax.device_get(state))


@pytest.fixture(scope="module")
def port_fp16(tmp_path_factory):
    cases = {kind: dict(model=spec(kind == "fused"), schedule=SCHEDULE, scaler=SCALER,
                        plant=PLANT, params=resnet_params_from_jax(
                            variables(jax_state(kind == "fused", False)[0]),
                            fused=kind == "fused"))
             for kind in ("plain", "fused")}
    return spawn(tmp_path_factory.mktemp("fp16"),
                 dict(task="steps", cases=cases, batches=batches()))


@pytest.mark.parametrize("kind", ["plain", "fused"])
def test_fp16_dp_step_with_an_inf_on_one_rank_matches_jax(port_fp16, kind):
    want_metrics, want_scales, want = jax_fp16_run(kind)
    assert [m["grads_finite"] for m in want_metrics] == [1.0, 0.0, 1.0]
    assert want_scales == [2.0 ** 11, 2.0 ** 10, 2.0 ** 11]
    for r in port_fp16:
        got = r[kind]["metrics"]
        assert r[kind]["step"] == 3 and r[kind]["updates"] == 2
        assert got["scale"] == want_scales
        # every rank skipped: no parameter or momentum moved at step 1
        assert got["param_change"][PLANT[0]] == 0.0 == got["momentum_change"][PLANT[0]]
        assert got["param_change"][2] > 0.0
        for i, jm in enumerate(want_metrics):
            for k, v in jm.items():
                np.testing.assert_allclose(got[k][i], v, rtol=1e-5, err_msg=f"{k}@{i}")
    tree = resnet_params_to_jax(port_fp16[0][kind]["params"])
    assert_tree_close(tree["params"], want["params"], 2e-5, "params")
    # the inf step's statistics are NaN on both sides: JAX's skip keeps them
    assert np.isnan(tree["batch_stats"]["bn_init"]["mean"]).all()
    assert_tree_close(tree["batch_stats"], want["batch_stats"], 2e-5, "batch_stats")
