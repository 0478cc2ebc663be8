"""ResNet v1.5 (``pytorch_distributed_tpu/models/resnet.py``) in PyTorch.

The same architecture and parameter tree as the flax model: the 7x7 stem,
Basic or Bottleneck stages with the stride on the 3x3 conv and torchvision's
explicit (1, 1) padding, ``resnet50`` at 25,557,032 parameters. Modules carry
the flax names (``conv_init``, ``stage1_block1.Conv_0``, ``BatchNorm_2``,
``downsample_bn``, ``fc``), so ``models.convert`` maps one tree to the other
name for name.

- Layout: the forward takes NHWC images ``[B, H, W, 3]``, as the JAX model
  does, and runs NCHW tensors in ``channels_last`` memory, so every
  activation's ``permute(0, 2, 3, 1)`` is the NHWC array of the JAX package
  without a copy.
- ``dtype`` is the compute dtype: parameters stay fp32 and are cast for
  each conv and the classifier; the logits are fp32.
- ``BatchNorm`` has flax's semantics (``nn.BatchNorm(momentum=0.9,
  epsilon=1e-5)``), not ``torch.nn.BatchNorm2d``'s: fp32 statistics with
  var = E[x²] − E[x]² (clamped at 0), the running variance updated with the
  biased batch variance as ``ra = 0.9·ra + 0.1·batch``, and the
  normalization in fp32 rounded to the compute dtype once. Training mode is
  the module's ``training`` flag (flax's ``train`` argument).
- ``fused_bottleneck=True`` runs ``FusedBottleneckBlock``: the same math
  with the expand tail's batch statistics taken from the moments of its
  narrow input. Its tail is ``_FusedExpandTail``, an ``autograd.Function``
  whose forward and backward reduce through the CUDA kernels of
  ``ops.bottleneck_tail`` (their plain versions on the CPU); the downsample
  branch takes its statistics from the same ``moments`` kernel.

- ``bn_cross_replica_axis``: sync-BN over the data group that
  ``parallel.mesh.make_mesh`` registered under that name (resolved at each
  training forward, as the ring resolves ``seq_axis``; a group of one
  rank is local BatchNorm). A plain BatchNorm sums its per-channel
  ``[mean, mean of squares]`` over the group and divides by its size
  before var = E[x²] − E[x]² (flax's ``axis_name``); the fused block's
  moment statistics sum Σz, zᵀz and n over the group
  (``_moments_nhwc``:292). The differentiable sum is
  ``parallel.collectives.psum``, whose backward sums the cotangents as
  JAX's transpose of ``psum`` does; the fused tail's own backward keeps
  local cotangents for its parameters and sums (dmean, dvar) over the
  group before kernel 3's ``dm``, ``dm2``. Every sum sits outside the
  kernels. Without the option each replica normalizes with its own
  batch's statistics (DDP's unsynced BatchNorm).

``space_to_depth_stem``, ``use_dot_1x1``, ``remat_blocks`` and
``int8_trunk`` are not ported and raise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_distributed_tpu_torch.ops import bottleneck_tail
from pytorch_distributed_tpu_torch.parallel.collectives import all_reduce_, psum
from pytorch_distributed_tpu_torch.parallel.mesh import AxisGroup, axis_group

CL = torch.channels_last
MOMENTUM = 0.9
EPSILON = 1e-5


def nhwc_rows(x: torch.Tensor) -> torch.Tensor:
    """The ``[B·H·W, C]`` rows of a ``channels_last`` NCHW tensor (a view)."""
    return bottleneck_tail.rows(x.contiguous(memory_format=CL).permute(0, 2, 3, 1))


def from_rows(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``[B·H·W, C]`` rows back to a ``channels_last`` NCHW view shaped as
    ``like`` (batch and spatial dims) with ``r``'s channels."""
    b, _, h, w = like.shape
    return r.view(b, h, w, r.shape[1]).permute(0, 3, 1, 2)


def sync_axis(name: Optional[str]) -> Optional[AxisGroup]:
    """The sync-BN group registered under ``name``, or None for local
    statistics (no name, or a group of one rank)."""
    if name is None:
        return None
    axis = axis_group(name)
    return axis if axis.size > 1 else None


def update_running(running: torch.Tensor, batch: torch.Tensor) -> None:
    """``ra = 0.9·ra + 0.1·batch`` in flax's order of operations."""
    with torch.no_grad():
        running.copy_(MOMENTUM * running + (1 - MOMENTUM) * batch.detach())


def batch_norm(x: torch.Tensor, weight, bias, running_mean, running_var,
               training: bool, eps: float = EPSILON,
               axis: Optional[AxisGroup] = None) -> torch.Tensor:
    """flax ``nn.BatchNorm`` over (N, H, W) of NCHW ``x``, output in x's
    dtype; in training the batch statistics (over ``axis``'s group when
    given) update the running ones."""
    xf = x.float()
    if training:
        mean, mean2 = xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))
        if axis is not None:
            mean, mean2 = psum(torch.stack([mean, mean2]), axis.group) / axis.size
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        update_running(running_mean, mean)
        update_running(running_var, var)
    else:
        mean, var = running_mean, running_var
    mul = torch.rsqrt(var + eps) * weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
    return y.to(x.dtype)


class _BNParams(nn.Module):
    """scale and bias (``weight``, ``bias``) and the running statistics
    (``running_mean``, ``running_var``) of one flax BatchNorm."""

    def __init__(self, features: int, axis_name: Optional[str] = None):
        super().__init__()
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))


class BatchNorm(_BNParams):
    def forward(self, x):
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          self.training,
                          axis=sync_axis(self.axis_name) if self.training else None)


class Conv(nn.Module):
    """``nn.Conv(use_bias=False)`` with an OIHW fp32 kernel (stored
    channels_last), run in the input's dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k).contiguous(memory_format=CL))
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), stride=self.stride, padding=self.padding)


class Dense(nn.Module):
    """``nn.Dense`` in ``dtype``: the product, then the bias, each rounded."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype)) + self.bias.to(self.dtype)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 bn_axis: Optional[str] = None):
        super().__init__()
        out = filters * self.expansion
        self.Conv_0 = Conv(cin, filters, 3, strides, 1)
        self.BatchNorm_0 = BatchNorm(filters, bn_axis)
        self.Conv_1 = Conv(filters, filters, 3, 1, 1)
        self.BatchNorm_1 = BatchNorm(filters, bn_axis)
        self.has_downsample = cin != out or strides != 1
        if self.has_downsample:
            self.downsample_conv = Conv(cin, out, 1, strides)
            self.downsample_bn = BatchNorm(out, bn_axis)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 → 3x3(stride) → 1x1(4x) residual block (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 bn_axis: Optional[str] = None):
        super().__init__()
        out = filters * self.expansion
        self.Conv_0 = Conv(cin, filters, 1)
        self.BatchNorm_0 = BatchNorm(filters, bn_axis)
        self.Conv_1 = Conv(filters, filters, 3, strides, 1)
        self.BatchNorm_1 = BatchNorm(filters, bn_axis)
        self.Conv_2 = Conv(filters, out, 1)
        self.BatchNorm_2 = BatchNorm(out, bn_axis)
        self.has_downsample = cin != out or strides != 1
        if self.has_downsample:
            self.downsample_conv = Conv(cin, out, 1, strides)
            self.downsample_bn = BatchNorm(out, bn_axis)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return F.relu(residual + y)


class _Kernel1x1(nn.Module):
    """A 1x1 conv kernel held as the ``[in, out]`` fp32 matrix the fused
    block multiplies by (flax keeps it ``[1, 1, in, out]``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout))


class _Moments(torch.autograd.Function):
    """``(Σz, zᵀz)`` of ``[N, F]`` rows through the moments kernel, with
    autodiff's backward ``dz = dΣ + z·(dM + dMᵀ)`` in torch ops."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return bottleneck_tail.moments(z)

    @staticmethod
    def backward(ctx, ds, dm2):
        (z,) = ctx.saved_tensors
        acc = torch.zeros((1, z.shape[1]), dtype=torch.float32, device=z.device)
        if ds is not None:
            acc = acc + ds[None, :]
        if dm2 is not None:
            acc = acc + z.float() @ (dm2 + dm2.T)
        return acc.expand(z.shape).to(z.dtype)


def expand_bn_stats(zr: torch.Tensor, w: torch.Tensor,
                    axis: Optional[AxisGroup] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact batch mean and variance of ``zr @ w`` from the moments of the
    rows ``zr`` (``_expand_bn_stats``): E[y] = m·w, E[y²] = wᵀ·M2·w per
    column, var = E[y²] − E[y]². Differentiable in zr and w. With ``axis``
    the moments and the row count are summed over its group (one
    differentiable sum of ``[Σz, zᵀz]``)."""
    s, m2 = _Moments.apply(zr)
    n = zr.shape[0]
    if axis is not None:
        f = s.shape[0]
        flat = psum(torch.cat([s, m2.reshape(-1)]), axis.group)
        s, m2, n = flat[:f], flat[f:].view(f, f), n * axis.size
    mean = (s / n) @ w
    ey2 = torch.sum((m2 / n) @ w * w, dim=0)
    return mean, ey2 - mean * mean


class _FusedExpandTail(torch.autograd.Function):
    """``relu(bn(z2 @ w) + residual)`` with the batch statistics from the
    moments of z2, and the hand-written backward of ``_fused_expand_tail``
    (``models/resnet.py:253-385`` of the JAX package). Operands are rows:
    z2 ``[N, F]`` and residual ``[N, E]`` in the compute dtype, w ``[F, E]``,
    gamma, beta ``[E]`` fp32. Returns ``(out [N, E], batch_mean,
    batch_var)``.

    Forward: kernel 1 (``moments``) gives Σz2 and z2ᵀz2; the statistics
    follow in F x E algebra; y3 = z2 @ w is one cuBLAS product, and
    ``relu(y3·a + b + residual)`` rounds in the compute dtype after each
    operation, in the JAX order. Backward: kernel 2 (``tail_bwd_reduce``)
    gives gp = g·[out > 0] (the residual's gradient), P = z2ᵀgp and Σgp;
    the parameter gradients and the moment corrections are F x F torch
    algebra; kernel 3 (``tail_bwd_dz``) gives dz2 = gp·(diag(a)wᵀ) +
    z2·(2 dM) + dm/n."""

    @staticmethod
    def forward(ctx, z2, residual, w, gamma, beta, eps, axis=None):
        dt = z2.dtype
        n = z2.shape[0]
        s, m2 = bottleneck_tail.moments(z2)
        if axis is not None:  # sync-BN: the moments and n over the group
            f = s.shape[0]
            flat = all_reduce_(torch.cat([s, m2.reshape(-1)]), group=axis.group)
            s, m2, n = flat[:f], flat[f:].view(f, f), n * axis.size
        m = s / n
        m2n = m2 / n
        mean = m @ w
        ey2 = torch.sum(m2n @ w * w, dim=0)
        var = ey2 - mean * mean
        sigma_inv = torch.rsqrt(var + eps)
        a = gamma * sigma_inv
        b = beta - mean * a
        y3 = z2 @ w.to(dt)
        out = F.relu(y3 * a.to(dt) + b.to(dt) + residual.to(dt))
        ctx.save_for_backward(z2, w, gamma, m, m2n, mean, sigma_inv, a, out)
        ctx.residual_dtype, ctx.n, ctx.axis = residual.dtype, n, axis
        return out, mean, var

    @staticmethod
    def backward(ctx, g, g_mean, g_var):
        z2, w, gamma, m, m2n, mean, sigma_inv, a, out = ctx.saved_tensors
        n = ctx.n
        gp, p, sb = bottleneck_tail.tail_bwd_reduce(z2, g.to(out.dtype).contiguous(), out)
        sa = torch.sum(p * w, dim=0)  # Σ g·y
        a_grad = sa - mean * sb
        dgamma = a_grad * sigma_inv
        dbeta = sb
        dvar = -0.5 * a_grad * gamma * sigma_inv ** 3
        if g_var is not None:
            dvar = dvar + g_var
        dmean = -a * sb - 2.0 * mean * dvar
        if g_mean is not None:
            dmean = dmean + g_mean
        dw = p * a + torch.outer(m, dmean) + 2.0 * m2n @ w * dvar
        if ctx.axis is not None:
            # the parameters keep local cotangents (the step's gradient
            # mean completes them); z2's gradient takes every replica's
            # (dmean, dvar), as autodiff transposes the moments' psum
            e = dmean.shape[0]
            both = all_reduce_(torch.cat([dmean, dvar]), group=ctx.axis.group)
            dmean, dvar = both[:e], both[e:]
        dm = w @ dmean
        dm2 = (w * dvar) @ w.T / n
        dz = bottleneck_tail.tail_bwd_dz(gp, z2, a[:, None] * w.T, 2.0 * dm2, dm / n)
        return dz, gp.to(ctx.residual_dtype), dw, dgamma, dbeta, None, None


class _TailBatchNorm(_BNParams):
    """BN3's parameters and running statistics around the fused tail: in
    training the tail produces the batch statistics, which update the
    running ones; in evaluation the tail is plain torch on the running
    statistics (no kernel)."""

    def forward(self, z2r, residual_r, w):
        if self.training:
            out, mean, var = _FusedExpandTail.apply(z2r, residual_r, w, self.weight,
                                                    self.bias, EPSILON,
                                                    sync_axis(self.axis_name))
            update_running(self.running_mean, mean)
            update_running(self.running_var, var)
            return out
        dt = z2r.dtype
        scale = self.weight * torch.rsqrt(self.running_var + EPSILON)
        bias = self.bias - self.running_mean * scale
        return F.relu(z2r @ w.to(dt) * scale.to(dt) + bias.to(dt) + residual_r)


class _MomentBatchNorm(_BNParams):
    """A BatchNorm whose batch statistics the caller supplies; returns fp32
    ``(scale, bias)`` with ``bn(y) = y·scale + bias``."""

    def forward(self, batch_mean, batch_var):
        if self.training:
            mean, var = batch_mean, batch_var
            update_running(self.running_mean, mean)
            update_running(self.running_var, var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + EPSILON)
        return scale, self.bias - mean * scale


class FusedBottleneckBlock(nn.Module):
    """``BottleneckBlock`` with the expand tail fused: the same parameters
    (``Conv_2`` and ``downsample_conv`` as ``[in, out]`` matrices), the same
    batch-statistics semantics; the statistics of BN3 and of the downsample
    BN come from the moments of the narrow inputs."""

    expansion = 4

    def __init__(self, cin: int, filters: int, strides: int = 1,
                 bn_axis: Optional[str] = None):
        super().__init__()
        out = filters * self.expansion
        self.strides = strides
        self.Conv_0 = Conv(cin, filters, 1)
        self.BatchNorm_0 = BatchNorm(filters, bn_axis)
        self.Conv_1 = Conv(filters, filters, 3, strides, 1)
        self.BatchNorm_1 = BatchNorm(filters, bn_axis)
        self.Conv_2 = _Kernel1x1(filters, out)
        self.BatchNorm_2 = _TailBatchNorm(out, bn_axis)
        self.has_downsample = cin != out or strides != 1
        if self.has_downsample:
            self.downsample_conv = _Kernel1x1(cin, out)
            self.downsample_bn = _MomentBatchNorm(out, bn_axis)

    def forward(self, x):
        dt = x.dtype
        x = x.contiguous(memory_format=CL)
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        z2 = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        z2r = nhwc_rows(z2)
        if self.has_downsample:
            s = self.strides
            # one strided copy, shared by the statistics and the 1x1 conv
            xs = x if s == 1 else x[:, :, ::s, ::s].contiguous(memory_format=CL)
            xr = nhwc_rows(xs)
            wd = self.downsample_conv.weight
            mean = var = None
            if self.training:
                mean, var = expand_bn_stats(xr, wd, sync_axis(self.downsample_bn.axis_name))
            scale, bias = self.downsample_bn(mean, var)
            residual = xr @ wd.to(dt) * scale.to(dt) + bias.to(dt)
        else:
            residual = nhwc_rows(x)
        return from_rows(self.BatchNorm_2(z2r, residual, self.Conv_2.weight), z2)


_UNPORTED = ("space_to_depth_stem", "use_dot_1x1", "remat_blocks", "int8_trunk")


class ResNet(nn.Module):
    """ResNet v1.5 with an ImageNet stem. ``forward`` takes NHWC images and
    returns fp32 logits ``[B, num_classes]``.

    Parameters are allocated, not initialised: load a state dict
    (``models.convert.resnet_params_from_jax`` of ``init_resnet_params``
    or of a flax tree), as ``train.create_resnet_state`` does."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.float32,
                 fused_bottleneck: bool = False, space_to_depth_stem: bool = False,
                 use_dot_1x1: bool = False, remat_blocks: bool = False,
                 int8_trunk: bool = False, bn_cross_replica_axis: Optional[str] = None):
        super().__init__()
        options = dict(space_to_depth_stem=space_to_depth_stem, use_dot_1x1=use_dot_1x1,
                       remat_blocks=remat_blocks, int8_trunk=int8_trunk)
        for name in _UNPORTED:
            if options[name]:
                raise NotImplementedError(
                    f"ResNet({name}=...) is not ported yet (ROADMAP.md queue 1)")
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        self.fused = bool(fused_bottleneck) and block_cls is BottleneckBlock
        block = FusedBottleneckBlock if self.fused else block_cls
        self.conv_init = Conv(3, num_filters, 7, 2, 3)
        self.bn_init = BatchNorm(num_filters, bn_cross_replica_axis)
        self.block_names = []
        cin = num_filters
        for i, size in enumerate(self.stage_sizes):
            for j in range(size):
                filters = num_filters * 2 ** i
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, block(cin, filters, 2 if i > 0 and j == 0 else 1,
                                            bn_cross_replica_axis))
                self.block_names.append(name)
                cin = filters * block.expansion
        self.fc = Dense(cin, num_classes, dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.to(self.dtype).permute(0, 3, 1, 2)  # NHWC memory, NCHW dims
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.float().mean((2, 3)).to(self.dtype)
        return self.fc(x).float()


def _resnet(stage_sizes, block_cls):
    def build(num_classes: int = 1000, **kwargs) -> ResNet:
        return ResNet(stage_sizes=stage_sizes, block_cls=block_cls,
                      num_classes=num_classes, **kwargs)

    return build


resnet18 = _resnet((2, 2, 2, 2), BasicBlock)
resnet34 = _resnet((3, 4, 6, 3), BasicBlock)
resnet50 = _resnet((3, 4, 6, 3), BottleneckBlock)
resnet101 = _resnet((3, 4, 23, 3), BottleneckBlock)
