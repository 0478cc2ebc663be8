"""Weights and paged caches across frameworks: flax parameter trees to
the port's ``TransformerLM`` and ``ResNet`` state dicts and back, numpy
initialisers in the flax layout, and the flax paged cache to the port's
list of ``LayerCache`` and back.

The flax layout (``pytorch_distributed_tpu/models/transformer.py``):

- ``wte``/``wpe``: ``Embed.embedding`` ``[V, E]`` / ``[max_seq_len, E]``;
- ``block{i}/attn/qkv``: ``DenseGeneral`` kernel ``[E, 3, H, D]`` and bias
  ``[3, H, D]``; ``block{i}/attn/proj``: kernel ``[H, D, E]``, no bias;
- ``block{i}/mlp_up`` (kernel ``[E, 4E]``, bias) and ``mlp_down`` (kernel
  ``[4E, E]``, no bias): ``Dense`` kernels are ``[in, out]``, the transpose
  of ``nn.Linear.weight``;
- ``ln1``/``ln2``/``ln_f``: ``scale`` and ``bias``;
- ``lm_head``: kernel ``[E, V]``, no bias;
- the paged cache: ``block{i}/attn/{key,value}`` pools and, for quantized
  pools, ``key_scale``/``value_scale``.

and of ``pytorch_distributed_tpu/models/resnet.py`` (``{"params",
"batch_stats"}``, module names as the port's): ``nn.Conv`` kernels
``[kh, kw, in, out]`` (the port's OIHW ``weight``; the fused block's
``Conv_2`` and ``downsample_conv`` as ``[in, out]``), ``fc`` a ``Dense``
kernel ``[in, out]`` and bias, BatchNorm ``scale``/``bias`` with
``batch_stats`` ``mean``/``var`` (the port's ``weight``, ``bias``,
``running_mean``, ``running_var``).

The fp16 loss scaler's state (``ops/precision.py`` ``DynamicLossScaler``:
``scale`` fp32, ``growth_tracker`` int32 and its three constants) crosses
with ``scaler_from_jax``.

A whole JAX checkpoint crosses with ``resnet_payload_from_jax`` /
``lm_payload_from_jax``: its leaves (``utils.checkpoint.ManifestReader``
reads them from a directory the JAX ``Trainer`` / ``LMTrainer`` wrote:
``state/params``, ``state/batch_stats``, ``state/opt_state``,
``state/step``, ``state/scaler``, ``epoch``, ``step``, ``best_*``) become
the port's (``train.state.state_payload``'s paths). The parameters and
statistics go through ``resnet_params_from_jax`` / ``params_from_jax``;
optax's ``trace`` (SGD) and ``mu``/``nu`` (AdamW) through the same name
map onto torch's ``momentum_buffer`` and ``exp_avg``/``exp_avg_sq``, the
Adam count onto AdamW's ``step``; the schedule's count
(``scale_by_learning_rate``'s) becomes ``updates``; the scaler's leaves
keep their paths.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from pytorch_distributed_tpu_torch.models.resnet import Conv, Dense, ResNet, _Kernel1x1
from pytorch_distributed_tpu_torch.models.transformer import LayerCache, TransformerConfig
from pytorch_distributed_tpu_torch.ops.precision import DynamicLossScaler

#: fp8 dtypes by their numpy (ml_dtypes) name
_FP8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _np(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)  # a writable copy


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``TransformerLM`` from a flax parameter
    tree whose leaves are numpy arrays (``jax.tree.map(np.asarray, p)``)
    or the tree ``init_params`` makes. Tensors are fp32 on the CPU;
    ``load_state_dict`` casts them to the module's dtypes."""
    n_layers = sum(1 for k in params if k.startswith("block"))
    expected = {"wte", "wpe", "ln_f", "lm_head"} | {
        f"block{i}" for i in range(n_layers)}
    if set(params) != expected:
        raise ValueError(
            f"unexpected flax tree: keys {sorted(params)}; a learned-position "
            f"MHA TransformerLM has {sorted(expected)}")

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(_np(x)))

    def ln(prefix, p, out):
        out[f"{prefix}.weight"] = t(p["scale"])
        out[f"{prefix}.bias"] = t(p["bias"])

    sd: Dict[str, torch.Tensor] = {
        "wte.weight": t(params["wte"]["embedding"]),
        "wpe.weight": t(params["wpe"]["embedding"]),
        "lm_head.weight": t(_np(params["lm_head"]["kernel"]).T),
    }
    ln("ln_f", params["ln_f"], sd)
    for i in range(n_layers):
        p, pre = params[f"block{i}"], f"blocks.{i}"
        qkv_k = _np(p["attn"]["qkv"]["kernel"])  # [E, 3, H, D]
        e = qkv_k.shape[0]
        sd[f"{pre}.attn.qkv.weight"] = t(qkv_k.reshape(e, -1).T)
        sd[f"{pre}.attn.qkv.bias"] = t(_np(p["attn"]["qkv"]["bias"]).reshape(-1))
        proj_k = _np(p["attn"]["proj"]["kernel"])  # [H, D, E]
        sd[f"{pre}.attn.proj.weight"] = t(proj_k.reshape(-1, proj_k.shape[-1]).T)
        sd[f"{pre}.mlp_up.weight"] = t(_np(p["mlp_up"]["kernel"]).T)
        sd[f"{pre}.mlp_up.bias"] = t(p["mlp_up"]["bias"])
        sd[f"{pre}.mlp_down.weight"] = t(_np(p["mlp_down"]["kernel"]).T)
        ln(f"{pre}.ln1", p["ln1"], sd)
        ln(f"{pre}.ln2", p["ln2"], sd)
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor],
                  cfg: TransformerConfig) -> Dict:
    """The inverse of ``params_from_jax``: the flax parameter tree, numpy
    fp32 leaves, of a ``TransformerLM`` state dict (any device and
    dtype), so a trained state compares with the JAX package's."""

    def a(name) -> np.ndarray:  # a copy: never a view of a live parameter
        return state_dict[name].detach().float().cpu().numpy().copy()

    def kernel(name, *shape) -> np.ndarray:  # nn.Linear weight -> Dense kernel
        w = a(f"{name}.weight").T
        return w.reshape(shape) if shape else w

    def ln(prefix):
        return {"scale": a(f"{prefix}.weight"), "bias": a(f"{prefix}.bias")}

    e, h, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    params = {
        "wte": {"embedding": a("wte.weight")},
        "wpe": {"embedding": a("wpe.weight")},
        "ln_f": ln("ln_f"),
        "lm_head": {"kernel": kernel("lm_head")},
    }
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}"
        params[f"block{i}"] = {
            "ln1": ln(f"{pre}.ln1"),
            "attn": {
                "qkv": {"kernel": kernel(f"{pre}.attn.qkv", e, 3, h, d),
                        "bias": a(f"{pre}.attn.qkv.bias").reshape(3, h, d)},
                "proj": {"kernel": kernel(f"{pre}.attn.proj", h, d, e)},
            },
            "ln2": ln(f"{pre}.ln2"),
            "mlp_up": {"kernel": kernel(f"{pre}.mlp_up"), "bias": a(f"{pre}.mlp_up.bias")},
            "mlp_down": {"kernel": kernel(f"{pre}.mlp_down")},
        }
    return params


def _truncated_normal(rng: np.random.Generator, shape, std: float) -> np.ndarray:
    """Normal cut at ±2 standard deviations, rescaled to ``std`` (flax's
    ``truncated_normal`` variance scaling)."""
    x = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) > 2.0
    # std of a unit normal truncated to [-2, 2]
    return x * np.float32(std / 0.87962566103423978)


def init_params(cfg: TransformerConfig, seed: int = 0) -> Dict:
    """Random weights in the flax layout at flax's default scales, from a
    numpy seed: ``lecun_normal`` Dense kernels (truncated normal, variance
    1/fan_in), zero biases, unit LayerNorm scales, ``Embed`` tables
    normal with variance 1/E. Feed the result to ``params_from_jax``."""
    rng = np.random.default_rng(seed)
    e, h, d, v = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.vocab_size
    m = e * cfg.mlp_ratio

    def dense(fan_in, shape):
        return _truncated_normal(rng, shape, fan_in ** -0.5)

    def ln():
        return {"scale": np.ones(e, np.float32), "bias": np.zeros(e, np.float32)}

    params = {
        "wte": {"embedding": rng.standard_normal((v, e), dtype=np.float32)
                * np.float32(e ** -0.5)},
        "wpe": {"embedding": rng.standard_normal((cfg.max_seq_len, e),
                                                 dtype=np.float32)
                * np.float32(e ** -0.5)},
    }
    for i in range(cfg.num_layers):
        params[f"block{i}"] = {
            "ln1": ln(),
            "attn": {
                "qkv": {"kernel": dense(e, (e, 3, h, d)),
                        "bias": np.zeros((3, h, d), np.float32)},
                "proj": {"kernel": dense(h * d, (h, d, e))},
            },
            "ln2": ln(),
            "mlp_up": {"kernel": dense(e, (e, m)), "bias": np.zeros(m, np.float32)},
            "mlp_down": {"kernel": dense(m, (m, e))},
        }
    params["ln_f"] = ln()
    params["lm_head"] = {"kernel": dense(e, (e, v))}
    return params


def paged_cache_from_jax(cache_tree: Mapping) -> List[LayerCache]:
    """The port's paged cache (CPU tensors, copies) from a flax paged cache
    tree ``{"block{i}": {"attn": {"key", "value"[, "key_scale",
    "value_scale"]}}}`` with numpy or jax leaves: float or quantized pools
    with their scales. fp8 leaves travel as their bytes."""

    def t(x) -> torch.Tensor:
        a = np.asarray(x)
        if a.dtype.name in _FP8:
            return torch.from_numpy(a.view(np.uint8).copy()).view(_FP8[a.dtype.name])
        return torch.from_numpy(a.copy())

    n_layers = sum(1 for k in cache_tree if k.startswith("block"))
    out = []
    for i in range(n_layers):
        attn = cache_tree[f"block{i}"]["attn"]
        out.append(LayerCache(t(attn["key"]), t(attn["value"]),
                              *(t(attn[n]) if n in attn else None
                                for n in ("key_scale", "value_scale"))))
    return out


def paged_cache_to_jax(cache: List[LayerCache]) -> Dict:
    """The inverse of ``paged_cache_from_jax``: the flax paged cache tree of
    numpy arrays (fp8 as ``ml_dtypes`` arrays, which only this function
    needs)."""

    def a(x: torch.Tensor) -> np.ndarray:
        x = x.detach().cpu()
        for name, dt in _FP8.items():
            if x.dtype == dt:
                import ml_dtypes

                return x.view(torch.uint8).numpy().copy().view(getattr(ml_dtypes, name))
        return x.numpy().copy()

    tree = {}
    for i, layer in enumerate(cache):
        attn = {"key": a(layer.key), "value": a(layer.value)}
        if layer.key_scale is not None:
            attn["key_scale"] = a(layer.key_scale)
            attn["value_scale"] = a(layer.value_scale)
        tree[f"block{i}"] = {"attn": attn}
    return tree


_BN_LEAVES = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, path=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def resnet_params_from_jax(variables: Mapping, fused: bool = False) -> Dict[str, torch.Tensor]:
    """State dict for the port's ``ResNet`` from flax ``{"params",
    "batch_stats"}`` with numpy leaves. ``fused``: the target runs
    ``FusedBottleneckBlock``s (``model.fused``), whose ``Conv_2`` and
    ``downsample_conv`` are ``[in, out]`` matrices; one flax tree serves
    both block kinds, as in the JAX package."""
    sd: Dict[str, torch.Tensor] = {}

    def t(x) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x))

    for path, leaf in _leaves(variables["params"]):
        mod, name, x = ".".join(path[:-1]), path[-1], _np(leaf)
        if name == "kernel" and path[-2] == "fc":
            sd[f"{mod}.weight"] = t(x.T)
        elif name == "kernel" and fused and path[-2] in ("Conv_2", "downsample_conv"):
            sd[f"{mod}.weight"] = t(x[0, 0])
        elif name == "kernel":
            sd[f"{mod}.weight"] = t(x.transpose(3, 2, 0, 1))
        elif path[-2] == "fc":
            sd[f"{mod}.bias"] = t(x)
        else:
            sd[f"{mod}.{_BN_LEAVES[name]}"] = t(x)
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        sd[f"{'.'.join(path[:-1])}.{_BN_STATS[path[-1]]}"] = t(_np(leaf))
    return sd


def resnet_params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``resnet_params_from_jax``: flax ``{"params",
    "batch_stats"}`` with numpy fp32 leaves (copies)."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree, dotted, leaf, value):
        node = tree
        for k in dotted.split("."):
            node = node.setdefault(k, {})
        node[leaf] = value

    for key, v in state_dict.items():
        mod, name = key.rsplit(".", 1)
        x = v.detach().float().cpu().numpy().copy()
        if name in ("running_mean", "running_var"):
            put(stats, mod, name[len("running_"):], x)
        elif mod.split(".")[-1] == "fc":
            put(params, mod, "kernel" if name == "weight" else "bias", x.T.copy()
                if name == "weight" else x)
        elif name == "weight" and x.ndim == 4:
            put(params, mod, "kernel", x.transpose(2, 3, 1, 0).copy())
        elif name == "weight" and mod.split(".")[-1] in ("Conv_2", "downsample_conv"):
            put(params, mod, "kernel", x[None, None].copy())
        else:
            put(params, mod, {"weight": "scale", "bias": "bias"}[name], x)
    return {"params": params, "batch_stats": stats}


def init_resnet_params(model: ResNet, seed: int = 0) -> Dict:
    """Random weights for ``model`` in the flax layout at the JAX model's
    scales, from a numpy seed: conv kernels normal with variance
    2/fan_out (torchvision's kaiming fan-out, ``resnet.py:34-35``), the
    ``fc`` kernel flax's ``lecun_normal`` with a zero bias, BatchNorm
    scales 1, biases 0, running means 0 and variances 1. Feed the result
    to ``resnet_params_from_jax(..., fused=model.fused)``."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, Conv):
            o, _, kh, kw = mod.weight.shape
            std = np.sqrt(2.0 / (kh * kw * o))
            sd[pre + "weight"] = torch.from_numpy(
                rng.standard_normal(tuple(mod.weight.shape), dtype=np.float32) * np.float32(std))
        elif isinstance(mod, _Kernel1x1):
            std = np.sqrt(2.0 / mod.weight.shape[1])
            sd[pre + "weight"] = torch.from_numpy(
                rng.standard_normal(tuple(mod.weight.shape), dtype=np.float32) * np.float32(std))
        elif isinstance(mod, Dense):
            out, cin = mod.weight.shape
            sd[pre + "weight"] = torch.from_numpy(
                np.ascontiguousarray(_truncated_normal(rng, (cin, out), cin ** -0.5).T))
            sd[pre + "bias"] = torch.zeros(out)
    for key, v in model.state_dict().items():
        if key not in sd:  # the BatchNorms' parameters and statistics
            one = key.endswith(".weight") or key.endswith("running_var")
            sd[key] = torch.ones(v.shape) if one else torch.zeros(v.shape)
    return resnet_params_to_jax(sd)


def scaler_from_jax(scaler, device=None) -> DynamicLossScaler:
    """The port's ``DynamicLossScaler`` with a JAX one's state: ``scale``
    and ``growth_tracker`` (read as numpy, on ``device``) and its growth
    and backoff constants."""
    return DynamicLossScaler(
        scale=torch.tensor(np.asarray(scaler.scale), dtype=torch.float32, device=device),
        growth_tracker=torch.tensor(np.asarray(scaler.growth_tracker), dtype=torch.int32,
                                    device=device),
        growth_factor=float(scaler.growth_factor), backoff_factor=float(scaler.backoff_factor),
        growth_interval=int(scaler.growth_interval))


def _numpy(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _subtree(flat: Mapping, prefix: str) -> Dict:
    """The nested dict of the ``/``-joined leaves under ``prefix``."""
    tree: Dict = {}
    for path, leaf in flat.items():
        if path.startswith(prefix):
            *parents, name = path[len(prefix):].split("/")
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[name] = _numpy(leaf)
    return tree


def _optax_parts(flat: Mapping) -> Dict:
    """The parts of a JAX ``state/opt_state``: ``trace`` (SGD's
    momentum), ``mu``, ``nu`` and ``adam_count`` (AdamW's moments and
    count), and ``updates``, the count of ``scale_by_learning_rate``'s
    schedule state (the entry holding a count and nothing else)."""
    fields: Dict[str, set] = {}
    for path in flat:
        if path.startswith("state/opt_state/"):
            i, field = path.split("/")[2:4]
            fields.setdefault(i, set()).add(field)
    parts: Dict = {}
    for i, names in fields.items():
        pre = f"state/opt_state/{i}/"
        if "trace" in names:
            parts["trace"] = _subtree(flat, pre + "trace/")
        if "mu" in names:
            parts["mu"] = _subtree(flat, pre + "mu/")
            parts["nu"] = _subtree(flat, pre + "nu/")
            parts["adam_count"] = _numpy(flat[pre + "count"])
        if names == {"count"}:
            parts["updates"] = _numpy(flat[pre + "count"])
    if "updates" not in parts:
        raise KeyError("the JAX opt_state has no schedule count")
    return parts


def _model_leaves(state_dict: Mapping[str, torch.Tensor], key: str = "") -> Dict:
    """``state/model/...`` (or, with ``key``, ``state/optimizer/.../key``)
    paths of a state dict."""
    if key:
        return {f"state/optimizer/{k.replace('.', '/')}/{key}": v
                for k, v in state_dict.items()}
    return {"state/model/" + k.replace(".", "/"): v for k, v in state_dict.items()}


def _common_leaves(flat: Mapping, parts: Dict) -> Dict:
    """The leaves both trainers carry: ``state/step``, ``updates``, the
    scaler's, and the top level (``epoch``, ``step``, ``best_*``)."""
    out = {p: flat[p] for p in flat if "/" not in p or p.startswith("state/scaler/")}
    out["state/step"] = torch.as_tensor(_numpy(flat["state/step"]).astype(np.int64))
    out["state/updates"] = torch.as_tensor(parts["updates"].astype(np.int64))
    return out


def resnet_payload_from_jax(flat: Mapping, fused: bool = False) -> Dict:
    """The port's checkpoint leaves of a JAX image ``Trainer``'s (module
    docstring); ``fused`` as ``resnet_params_from_jax`` takes it."""
    parts = _optax_parts(flat)
    out = _common_leaves(flat, parts)
    out.update(_model_leaves(resnet_params_from_jax(
        {"params": _subtree(flat, "state/params/"),
         "batch_stats": _subtree(flat, "state/batch_stats/")}, fused=fused)))
    if "trace" in parts:
        out.update(_model_leaves(resnet_params_from_jax({"params": parts["trace"]},
                                                        fused=fused), "momentum_buffer"))
    return out


def lm_payload_from_jax(flat: Mapping) -> Dict:
    """The port's checkpoint leaves of a JAX ``LMTrainer``'s (AdamW)."""
    parts = _optax_parts(flat)
    out = _common_leaves(flat, parts)
    out.update(_model_leaves(params_from_jax(_subtree(flat, "state/params/"))))
    if "mu" in parts:
        mu = params_from_jax(parts["mu"])
        step = torch.tensor(float(parts["adam_count"]), dtype=torch.float32)
        out.update(_model_leaves({k: step for k in mu}, "step"))
        out.update(_model_leaves(mu, "exp_avg"))
        out.update(_model_leaves(params_from_jax(parts["nu"]), "exp_avg_sq"))
    return out
