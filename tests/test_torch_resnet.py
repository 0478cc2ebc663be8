"""The port's ResNet against the flax model of the JAX package.

Same weights (a flax tree carried across by ``resnet_params_from_jax``),
same numpy inputs, fp32: the fused expand tail's ``autograd.Function``
against ``_fused_expand_tail`` (outputs and the five gradients), the fused
block at strides 1 and 2, and tiny ResNets of each block kind (eval and
train logits, updated BatchNorm statistics, gradients). The JAX fused tail
reduces in XLA, the port's through its kernels' plain versions.

Tolerances are fp32 summation-order ones, relative to the largest value
compared: 1e-5 for outputs, logits and statistics, 1e-4 for gradients,
which pass back through the batch statistics (E[y²] − E[y]² loses a few
digits to cancellation on both sides).
"""

from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models import resnet as jresnet
from pytorch_distributed_tpu_torch.models import resnet
from pytorch_distributed_tpu_torch.models.convert import (
    init_resnet_params,
    resnet_params_from_jax,
    resnet_params_to_jax,
)

OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def close(got, want, rel, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= rel, f"{what}: relative error {err:.2e} > {rel:g}"


def tree_close(got, want, rel, what=""):
    fg, tg = jax.tree_util.tree_flatten_with_path(got)
    fw, tw = jax.tree_util.tree_flatten_with_path(want)
    assert tg == tw, (what, tg, tw)
    for (path, a), (_, b) in zip(fg, fw):
        close(a, b, rel, f"{what}{jax.tree_util.keystr(path)}")


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("cotangent_stats", [False, True])
def test_fused_tail_function_matches_jax(cotangent_stats):
    """out, batch mean and var, and the grads of z2, residual, w, gamma and
    beta, with and without cotangents on the statistics."""
    rng = np.random.default_rng(0)
    b, h, w, f, e = 2, 5, 5, 8, 32
    z2 = np.maximum(rand(rng, b, h, w, f), 0)  # a relu output, as in the block
    res, g = rand(rng, b, h, w, e), rand(rng, b, h, w, e)
    wt, gamma, beta = rand(rng, f, e, scale=0.5), 1 + rand(rng, e, scale=0.1), rand(rng, e)
    gm, gv = (rand(rng, e), rand(rng, e)) if cotangent_stats else (np.zeros(e, np.float32),) * 2

    def jfn(*args):
        return jresnet._fused_expand_tail(*args, 1e-5, None)

    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (z2, res, wt, gamma, beta)))
    jgrads = vjp(tuple(map(jnp.asarray, (g, gm, gv))))

    n = b * h * w
    tz, tr, tw, tg, tb = (torch.from_numpy(x.reshape(n, -1) if x.ndim == 4 else x)
                          .requires_grad_() for x in (z2, res, wt, gamma, beta))
    out, mean, var = resnet._FusedExpandTail.apply(tz, tr, tw, tg, tb, 1e-5)
    torch.autograd.backward((out, mean, var), tuple(torch.from_numpy(x.reshape(-1, e)
                                                                     if x.ndim == 4 else x)
                                                    for x in (g, gm, gv)))
    close(out.reshape(b, h, w, e), jout[0], OUT_TOL, "out")
    close(mean, jout[1], OUT_TOL, "mean")
    close(var, jout[2], OUT_TOL, "var")
    for name, t, jg in zip(("z2", "residual", "w", "gamma", "beta"), (tz, tr, tw, tg, tb),
                           jgrads):
        close(t.grad.reshape(jg.shape), jg, GRAD_TOL, f"d{name}")


def flax_partials(train):
    conv = partial(fnn.Conv, use_bias=False, padding="SAME", dtype=jnp.float32,
                   kernel_init=jresnet.conv_kernel_init)
    norm = partial(fnn.BatchNorm, use_running_average=not train, momentum=0.9, epsilon=1e-5,
                   dtype=jnp.float32)
    return conv, norm


def to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)  # channels_last memory


def torch_grads(module, prefix=""):
    return {prefix + k: p.grad for k, p in module.named_parameters()}


def jax_grads_as_state(grads_tree, fused):
    """A flax gradient tree in the port's state-dict layout."""
    return resnet_params_from_jax({"params": jax.tree.map(np.asarray, grads_tree)}, fused=fused)


@pytest.mark.parametrize("strides", [1, 2])
def test_fused_block_matches_jax(strides):
    """FusedBottleneckBlock with a downsample (its statistics from the
    moments of the strided input): output, updated statistics and grads."""
    rng = np.random.default_rng(strides)
    cin, filters = 16, 8
    x = rand(rng, 2, 6, 6, cin)
    conv, norm = flax_partials(True)
    jblock = jresnet.FusedBottleneckBlock(filters=filters, conv=conv, norm=norm,
                                          strides=strides)
    variables = jblock.init(jax.random.key(0), jnp.asarray(x), train=False)
    variables = jax.tree.map(np.asarray, variables)
    # non-trivial BatchNorm parameters and statistics
    variables = jax.tree.map(lambda a: a + rand(rng, *a.shape, scale=0.1), variables)
    h = -(-6 // strides)
    cot = jnp.asarray(rand(rng, 2, h, h, 4 * filters))

    def jloss(params, xx):
        out, mut = jblock.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                xx, train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut)

    (_, (jout, jmut)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))

    block = resnet.FusedBottleneckBlock(cin, filters, strides)
    block.load_state_dict(resnet_params_from_jax(variables, fused=True))
    block.train()
    tx = to_nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_()
    out = block(tx)
    (out.permute(0, 2, 3, 1) * torch.from_numpy(np.asarray(cot))).sum().backward()
    close(out.permute(0, 2, 3, 1), jout, OUT_TOL, "out")
    want_stats = resnet_params_from_jax({"params": {}, "batch_stats": jmut["batch_stats"]})
    for k, v in want_stats.items():
        close(block.state_dict()[k], v, OUT_TOL, k)
    want = jax_grads_as_state(jgp, fused=True)
    got = torch_grads(block)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], GRAD_TOL, f"grad {k}")
    close(tx.grad.permute(0, 2, 3, 1), jgx, GRAD_TOL, "grad x")


BLOCKS = {"basic": (jresnet.BasicBlock, resnet.BasicBlock, False),
          "bottleneck": (jresnet.BottleneckBlock, resnet.BottleneckBlock, False),
          "fused": (jresnet.BottleneckBlock, resnet.BottleneckBlock, True)}


@pytest.mark.parametrize("kind,stages", [("basic", (1, 1)), ("bottleneck", (1, 1)),
                                         ("fused", (1, 1)), ("fused", (2, 1))])
def test_tiny_resnet_matches_flax(kind, stages):
    """Eval logits, train logits, the updated batch_stats and the grads of
    ``ResNet(stage_sizes, num_filters=8)`` against flax, fp32."""
    jblock, tblock, fused = BLOCKS[kind]
    rng = np.random.default_rng(7)
    x = rand(rng, 4, 32, 32, 3)
    labels_cot = rand(rng, 4, 10)
    jmodel = jresnet.ResNet(stage_sizes=stages, block_cls=jblock, num_classes=10,
                            num_filters=8, fused_bottleneck=fused)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.key(1), jnp.asarray(x),
                                                     train=False))
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree.map(lambda a: a + rand(rng, *a.shape, scale=0.1) ** 2,
                                             variables["batch_stats"])}
    model = resnet.ResNet(stage_sizes=stages, block_cls=tblock, num_classes=10, num_filters=8,
                          fused_bottleneck=fused)
    model.load_state_dict(resnet_params_from_jax(variables, fused=fused))

    model.eval()
    with torch.no_grad():
        close(model(torch.from_numpy(x)), jmodel.apply(variables, jnp.asarray(x), train=False),
              OUT_TOL, "eval logits")

    def jloss(params):
        logits, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                   jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(logits * labels_cot), (logits, mut)

    (_, (jlogits, jmut)), jg = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    model.train()
    logits = model(torch.from_numpy(x))
    (logits * torch.from_numpy(labels_cot)).sum().backward()
    close(logits, jlogits, OUT_TOL, "train logits")
    want_stats = resnet_params_from_jax({"params": {}, "batch_stats": jmut["batch_stats"]})
    for k, v in want_stats.items():
        close(model.state_dict()[k], v, OUT_TOL, k)
    want = jax_grads_as_state(jg, fused)
    got = torch_grads(model)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], GRAD_TOL, f"grad {k}")


@pytest.mark.parametrize("fused", [False, True])
def test_converter_round_trip_and_init_layout(fused):
    """flax tree → state dict → flax tree is the identity; the numpy
    initialiser makes flax's tree (names and shapes) at flax's scales."""
    jmodel = jresnet.resnet18(num_classes=10, num_filters=8) if not fused else \
        jresnet.ResNet(stage_sizes=(1, 1), block_cls=jresnet.BottleneckBlock, num_classes=10,
                       num_filters=8, fused_bottleneck=True)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0),
                                                     jnp.zeros((1, 32, 32, 3)), train=False))
    back = resnet_params_to_jax(resnet_params_from_jax(variables, fused=fused))
    tree_close(back, variables, 0.0)
    model = (resnet.resnet18(num_classes=10, num_filters=8) if not fused else
             resnet.ResNet(stage_sizes=(1, 1), block_cls=resnet.BottleneckBlock, num_classes=10,
                           num_filters=8, fused_bottleneck=True))
    init = init_resnet_params(model, seed=0)
    assert jax.tree.map(np.shape, init) == jax.tree.map(np.shape, variables)
    model.load_state_dict(resnet_params_from_jax(init, fused=fused))
    np.testing.assert_array_equal(init["batch_stats"]["bn_init"]["var"], 1.0)
    k = init["params"]["conv_init"]["kernel"]  # [7, 7, 3, 8]: fan_out 7*7*8
    assert abs(k.std() / np.sqrt(2.0 / (7 * 7 * 8)) - 1) < 0.1
    fc = init["params"]["fc"]["kernel"]
    assert np.abs(fc).max() <= 2 * fc.shape[0] ** -0.5 / 0.8796 + 1e-6  # truncated at 2 std
    # a different seed, different weights; the same seed, the same
    assert not np.array_equal(init_resnet_params(model, seed=1)["params"]["fc"]["kernel"], fc)
    np.testing.assert_array_equal(init_resnet_params(model, seed=0)["params"]["fc"]["kernel"], fc)


@pytest.mark.parametrize("fused", [False, True])
def test_resnet50_parameter_count_and_tree(fused):
    model = resnet.resnet50(fused_bottleneck=fused)
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    shapes = jax.eval_shape(lambda: jresnet.resnet50(fused_bottleneck=fused).init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    want = jax.tree.map(lambda s: s.shape, shapes)
    got = jax.tree.map(np.shape, resnet_params_to_jax(model.state_dict()))
    assert got == want


def test_unported_options_raise():
    for option in ("space_to_depth_stem", "use_dot_1x1", "remat_blocks", "int8_trunk"):
        with pytest.raises(NotImplementedError, match=option):
            resnet.resnet50(**{option: True})


def test_batch_norm_has_flax_semantics():
    """Biased variance in the running update, ra = 0.9 ra + 0.1 batch, and
    bf16 input normalized in fp32 with one rounding."""
    rng = np.random.default_rng(3)
    x = rand(rng, 8, 3, 4, 4) * 3 + 1
    bn = resnet.BatchNorm(3)
    bn.train()
    y = bn(torch.from_numpy(x))
    xf = x.transpose(1, 0, 2, 3).reshape(3, -1).astype(np.float64)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * xf.mean(1), rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * xf.var(1), rtol=1e-5)
    assert y.dtype == torch.float32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = resnet.BatchNorm(3).train()(xb)
    want = resnet.batch_norm(xb.float(), torch.ones(3), torch.zeros(3), torch.zeros(3),
                             torch.ones(3), True)
    assert yb.dtype == torch.bfloat16
    torch.testing.assert_close(yb, want.to(torch.bfloat16), rtol=0, atol=0)
