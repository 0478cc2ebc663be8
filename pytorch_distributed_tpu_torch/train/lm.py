"""LM train and eval steps (``pytorch_distributed_tpu/train/lm.py``).

The JAX steps run under ``shard_map`` over a (data, seq, model) mesh.
Here each process is one rank of a ``parallel.mesh.Mesh`` (or, with
``mesh=None``, the one device) and runs the JAX ``_local_step`` on its
shard of the batch: its data replica's rows, its sequence shard's
columns, the same on every model rank. Expert parallelism is not ported;
the pipeline's steps are ``train.pp``'s. What carries over exactly:

- tensor parallelism (``config.tp_size`` = the mesh's model axis, on a
  state from ``shard_lm_state(..., config=)``): the leaves the Megatron
  rules claim (``LM_PLACEMENT_RULES``, the JAX ``TRANSFORMER_TP_RULES``
  :99 in torch names, and with ``vocab_parallel`` ``wte`` and
  ``lm_head``: ``lm_placement_rules``) live as this rank's parts over the
  model axis (``tp_layout``: a ``utils.checkpoint.Shard`` each, the fused
  projections' in sections), the model's ``tp_copy`` / ``tp_reduce``
  make every other leaf's gradient whole on each model rank, and every
  gradient is summed over (data, seq) only (``Mesh.data_seq``, the JAX
  ``psum`` over ``(data, seq)``: ``:438-440``, ``:471``, ``:489``);
  the vocab-parallel loss tail is the fused CE's ``vocab_axis``;

- FSDP (``fsdp=True`` on a state from ``shard_lm_state(..., fsdp=True)``,
  ``shard_lm_state``:214): the leaves ``lm_fsdp_membership`` names live as
  this rank's parts over the data axis (``parallel.fsdp``); the step
  all-gathers them before the forward, and their gradients come back
  reduce-scattered over data (sums: each rank's loss is its share of the
  global mean), then summed over seq, while the replicated leaves' sum
  over data × seq (``make_lm_train_step``:472-565); clipping takes the
  sharded global norm (ZeRO parts' squares summed over data, TP parts'
  over model, whole leaves' once); AdamW runs on the parts; the eval
  step gathers the same way; FSDP leaves alone what a TP rule claims;
- the loss is Σ(w·ce)/max(Σw, 1) (``_lm_loss_sum``:391), by default
  through the fused linear cross-entropy on the post-ln_f hidden states,
  with Σw the token count all-reduced over data × seq, so each rank's
  local loss is its share of the global mean;
- gradients are summed over data × seq, then clipped, then passed to
  AdamW; the ``loss`` metric is the sum of the local losses over data ×
  seq (every model rank computes the same);
- the update: optional global-norm clipping (the pre-clip norm is the
  ``grad_norm`` metric), the lr from the schedule at ``state.updates``,
  the updates applied so far (optax's count inside ``opt_state``), AdamW,
  and with ``nan_guard`` a non-finite loss or gradient skips the update
  while ``step`` still advances and ``updates`` does not (``step_good``
  metric), every rank's verdict combined by a min over the whole job, as
  the JAX ``pmin`` over every mesh axis (``:597-606``: a TP part's NaN on
  one model rank vetoes the update everywhere);
- a seq-sharded mesh needs ring attention (``check_seq_parallel_attention``),
  and a zigzag shard's wpe positions follow the chunk map
  (``shard_positions``);
- MoE: each MoE layer's pre-weighted aux loss enters each rank's loss
  divided by the number of ranks, so the summed loss carries their mean
  across shards (``:533-540``); ``moe_dropped_frac`` is the mean over the
  layers, then over the ranks (``:612-617``); evaluation runs the experts
  at ``models.moe.eval_capacity_factor`` (``:640-674``);
- dropout: each step's masks come from a generator seeded by
  (``dropout_seed``, ``state.step``, shard = data index · S + seq index)
  alone (``dropout_generator``; JAX folds the same three into its key,
  ``:493-504``), so a resumed run draws the uninterrupted run's masks and
  every model rank the same masks. The bits are torch's, not
  ``jax.random``'s.

Parameters train in fp32 with ``config.dtype`` compute, as flax does:
``create_lm_state`` sets the config's ``param_dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax
from pytorch_distributed_tpu_torch.models.moe import (
    eval_capacity_factor,
    moe_layers,
    relaxed_capacity,
)
from pytorch_distributed_tpu_torch.models.transformer import (
    RING_ATTENTIONS,
    TransformerConfig,
    TransformerLM,
)
from pytorch_distributed_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_tpu_torch.ops.optim import adamw, clip_grads_by_global_norm
from pytorch_distributed_tpu_torch.parallel.collectives import all_reduce_, all_reduce_grads
from pytorch_distributed_tpu_torch.parallel.fsdp import (
    call_with,
    fsdp_dim,
    gather_params,
    shard_state,
    zero_parts,
)
from pytorch_distributed_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh
from pytorch_distributed_tpu_torch.parallel.sequence import zigzag_positions
from pytorch_distributed_tpu_torch.resilience.stepguard import finite_ok, guarded_step
from pytorch_distributed_tpu_torch.parallel.tensor import match_partition_rules
from pytorch_distributed_tpu_torch.train.state import TrainState
from pytorch_distributed_tpu_torch.utils.checkpoint import Shard

Batch = Dict[str, torch.Tensor]


def shift_labels(tokens: np.ndarray, pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Next-token targets on the host: ``labels[t] = tokens[t + 1]``; the
    last position predicts ``pad_id`` and has weight 0."""
    labels = np.concatenate(
        [tokens[:, 1:], np.full((tokens.shape[0], 1), pad_id, tokens.dtype)], axis=1)
    weights = np.ones_like(tokens, np.float32)
    weights[:, -1] = 0.0
    return labels, weights


def unsharded(config: TransformerConfig) -> TransformerConfig:
    """``config`` without tensor parallelism: the global model's."""
    return dataclasses.replace(config, tp_size=1, model_axis=None, vocab_parallel=False)


def create_lm_state(config: TransformerConfig, *, lr_schedule: Callable[[int], float],
                    weight_decay: float = 1e-4, seed: int = 0,
                    params: Optional[Dict[str, torch.Tensor]] = None,
                    device=None) -> TrainState:
    """A ``TransformerLM`` with fp32 parameters on ``device`` (CUDA unless
    asked for the CPU): ``params`` (a state dict, e.g. from
    ``params_from_jax``) or the flax-layout initialisation of ``seed``
    (``models.convert.init_params``), and its AdamW. The model is the
    global one also for a tensor-parallel ``config``, as the JAX state
    holds global leaves: ``shard_lm_state(..., config=)`` places it."""
    cfg = dataclasses.replace(unsharded(config), param_dtype=torch.float32)
    dev = resolve_device(device)
    with torch.device(dev):
        model = TransformerLM(cfg)
    model.load_state_dict(params if params is not None
                          else params_from_jax(init_params(cfg, seed)))
    return TrainState(model=model, optimizer=adamw(model.parameters(), weight_decay),
                      lr_schedule=lr_schedule)


def lm_loss_sum(out: torch.Tensor, model: TransformerLM, batch: Batch,
                use_fused: bool, head_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ(w·ce) of one forward's output: hidden states through the fused
    CE with ``head_weight`` (``model.lm_head.weight`` by default; the
    JAX steps' 512-row blocks; a vocab-parallel head's rows over the model
    axis), or full logits (gathered, under vocab parallelism) through the
    plain CE."""
    if use_fused:
        cfg = model.cfg
        return fused_linear_cross_entropy(
            out, model.lm_head.weight if head_weight is None else head_weight,
            batch["labels"], batch["weights"], compute_dtype=cfg.dtype,
            vocab_axis=cfg.model_group() if cfg.uses_vocab_parallel() else None)
    per_tok = cross_entropy_loss(out.reshape(-1, out.shape[-1]),
                                 batch["labels"].reshape(-1), reduction="none")
    return (per_tok * batch["weights"].reshape(-1)).sum()


def check_seq_parallel_attention(mesh: Optional[Mesh], config) -> None:
    """Refuse silently wrong sequence parallelism: on a seq-sharded mesh,
    dense or flash attention would attend within each shard only
    (``check_seq_parallel_attention``:368 of the JAX package)."""
    if mesh is not None and mesh.seq.size > 1 and config.attention not in RING_ATTENTIONS:
        raise ValueError(
            f"mesh shards the sequence axis 'seq' (size {mesh.seq.size}) but "
            f"config.attention={config.attention!r}: non-ring attention is "
            "shard-local under sequence parallelism and computes the wrong "
            "function. Use attention='ring'/'ring_flash' (or a seq-axis size of 1).")


#: Megatron placements of the ``TransformerLM``'s parameters (JAX
#: ``TRANSFORMER_TP_RULES``:99 in torch names): ``(name pattern, mesh
#: axes, dim, sections)``, the leaf split over the axes along ``dim`` of
#: its ``nn.Linear`` layout, in each of ``sections`` equal sections (the
#: fused ``qkv``'s q, k and v). Column-parallel layers split their output
#: features (a weight's dim 0), row-parallel ones their input features
#: (dim 1); LayerNorms, ``wpe``, ``wte`` and ``lm_head`` stay whole, unless
#: vocab parallelism adds ``VOCAB_RULES``. FSDP stores only what no rule
#: claims (``lm_fsdp_membership``).
LM_PLACEMENT_RULES: Tuple[Tuple[str, Tuple[str, ...], int, int], ...] = (
    (r"attn\.qkv\.weight$", (MODEL_AXIS,), 0, 3),  # [3·H·D, E] → H
    (r"attn\.qkv\.bias$", (MODEL_AXIS,), 0, 3),  # [3·H·D]
    (r"attn\.q\.weight$", (MODEL_AXIS,), 0, 1),  # [H·D, E] (GQA)
    (r"attn\.q\.bias$", (MODEL_AXIS,), 0, 1),
    (r"attn\.kv\.weight$", (MODEL_AXIS,), 0, 2),  # [2·H_kv·D, E]
    (r"attn\.kv\.bias$", (MODEL_AXIS,), 0, 2),
    (r"attn\.proj\.weight$", (MODEL_AXIS,), 1, 1),  # [E, H·D] → H
    (r"mlp_up\.weight$", (MODEL_AXIS,), 0, 1),  # [4E, E] → 4E
    (r"mlp_up\.bias$", (MODEL_AXIS,), 0, 1),
    (r"mlp_down\.weight$", (MODEL_AXIS,), 1, 1),  # [E, 4E] → 4E
)
#: vocab parallelism's (JAX ``_vocab_rules``:130): both tables' rows
VOCAB_RULES = (
    (r"^wte\.weight$", (MODEL_AXIS,), 0, 1),  # [V, E] → V
    (r"^lm_head\.weight$", (MODEL_AXIS,), 0, 1),  # [V, E] → V
)


def lm_placement_rules(config=None):
    """The rule set of ``config`` (JAX ``_lm_placement_rules``:253): the
    Megatron rules, and the vocabulary's when it runs vocab-parallel."""
    if config is not None and config.uses_vocab_parallel():
        return LM_PLACEMENT_RULES + VOCAB_RULES
    return LM_PLACEMENT_RULES


def _rule_claimed(name: str, rules, mesh: Mesh) -> bool:
    """Whether a rule claims ``name`` with an axis of size > 1
    (``_rule_claimed``:272): a matched rule over axes of size 1 shards
    nothing, and the leaf falls through to ZeRO."""
    sizes = {DATA_AXIS: mesh.data.size, SEQ_AXIS: mesh.seq.size, MODEL_AXIS: mesh.model.size}
    rule = match_partition_rules(rules, [name])[name]
    return rule is not None and any(sizes.get(a, 1) > 1 for a in rule[1])


def tp_layout(config, shapes: Dict[str, Tuple[int, ...]], index: int,
              owners: Tuple[int, ...]) -> Dict[str, Shard]:
    """Model rank ``index``'s ``Shard`` of every leaf a rule of
    ``config`` claims, from the leaves' global ``shapes``; ``owners[i]``
    writes part i (the rank at data 0, seq 0, model i)."""
    if config.tp_size == 1:
        return {}
    out = {}
    for name, rule in match_partition_rules(lm_placement_rules(config), shapes).items():
        if rule is not None:
            _, _, dim, sections = rule
            out[name] = Shard(tuple(shapes[name]), dim, index, owners, axis=MODEL_AXIS,
                              sections=sections)
    return out


def lm_fsdp_membership(model: torch.nn.Module, mesh: Mesh, rules=None) -> Dict[str, bool]:
    """Which parameters FSDP shards (``lm_fsdp_membership``:285): big
    enough for ``fsdp_dim`` over the data axis and not claimed by a rule
    (``rules``: ``lm_placement_rules`` of the model's config). A claimed
    leaf may be held at its local shape; the others are global."""
    if rules is None:
        rules = lm_placement_rules(getattr(model, "cfg", None))
    return {name: (not _rule_claimed(name, rules, mesh)
                   and fsdp_dim(tuple(p.shape), mesh.data.size) is not None)
            for name, p in model.named_parameters()}


def place_tp(state: TrainState, mesh: Mesh, config: TransformerConfig) -> TrainState:
    """The state's global model (``create_lm_state``'s) replaced by this
    rank's tensor-parallel one: a ``TransformerLM(config)`` at its local
    shapes holding its parts of the global leaves (``tp_layout``), the
    optimizer's groups moved onto its parameters by name, ``state.layout``
    extended. Call it before the first step, on every rank, with the
    weights the same everywhere."""
    if mesh.model.size != config.tp_size:
        raise ValueError(f"config.tp_size {config.tp_size} != the mesh's model axis "
                         f"{mesh.model.size}")
    opt, glob = state.optimizer, state.model
    if any(opt.state.values()):
        raise ValueError("place the state before its first step: the optimizer has state")
    cfg = dataclasses.replace(config, param_dtype=glob.cfg.param_dtype)
    shapes = {n: tuple(p.shape) for n, p in glob.named_parameters()}
    layout = tp_layout(cfg, shapes, mesh.model.index,
                       tuple(mesh.rank_of(model=i) for i in range(mesh.model.size)))
    with torch.device(next(glob.parameters()).device):
        model = TransformerLM(cfg)
    model.load_state_dict({k: layout[k].take(v) if k in layout else v
                           for k, v in glob.state_dict().items()})
    names = {id(p): n for n, p in glob.named_parameters()}
    local = dict(model.named_parameters())
    for group in opt.param_groups:
        group["params"] = [local[names[id(p)]] for p in group["params"]]
    state.model = model
    state.layout.update(layout)
    return state


def shard_lm_state(state: TrainState, mesh: Mesh, fsdp: bool = False,
                   config: Optional[TransformerConfig] = None) -> TrainState:
    """The state placed on the mesh (``shard_lm_state``:214): a
    tensor-parallel ``config`` (``tp_size`` > 1) first takes this rank's
    Megatron parts (``place_tp``); then with ``fsdp`` every
    ``lm_fsdp_membership`` leaf is ZeRO-sharded over the data axis.
    Otherwise replicated as it is. Call it on every rank after the weights
    are the same everywhere (rank 0's broadcast)."""
    if config is not None and config.tp_size > 1:
        state = place_tp(state, mesh, config)
    if not fsdp:
        return state
    members = lm_fsdp_membership(state.model, mesh)
    return shard_state(state, mesh, {n for n, m in members.items() if m})


def _over_mesh(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """``t`` summed in place over the (data, seq) points of this rank's
    model index (the JAX ``psum`` over ``(data, seq)``); ``t`` itself
    without a mesh."""
    if mesh is None or mesh.data_seq.size == 1:
        return t
    return all_reduce_(t, group=mesh.data_seq.group)


def check_model_axis(mesh: Optional[Mesh], config, model) -> None:
    """Refuse a tensor-parallel config whose state is not placed, or whose
    mesh's model axis is another size."""
    tp = 1 if config is None else config.tp_size
    if model.cfg.tp_size != tp:
        raise ValueError(
            f"config.tp_size {tp} but the state's model has tp_size {model.cfg.tp_size}: "
            "place the state with train.lm.shard_lm_state(..., config=config)")
    if tp > 1 and (mesh is None or mesh.model.size != tp):
        raise ValueError(f"tp_size {tp} runs on a mesh whose model axis has {tp} ranks")


def shard_positions(config, tokens: torch.Tensor, mesh: Optional[Mesh]):
    """The absolute positions of this shard's ``tokens [B, L]`` as
    ``(positions, offset)``: contiguous shards give ``(None, seq_index *
    L)``, zigzag shards the chunk-map position vector (on the tokens'
    device) and offset 0 (``_shard_positions``:345)."""
    lq = tokens.shape[1]
    if mesh is None:
        return None, 0
    if config.ring_layout == "zigzag":
        return zigzag_positions(lq, mesh.seq.size, mesh.seq.index).to(tokens.device), 0
    return None, mesh.seq.index * lq


def shard_index(mesh: Optional[Mesh]) -> int:
    """This rank's shard of the (data, seq) grid: data index · S + seq
    index (0 without a mesh)."""
    return 0 if mesh is None else mesh.data.index * mesh.seq.size + mesh.seq.index


def dropout_generator(seed: int, step: int, shard: int, device) -> torch.Generator:
    """The generator of one step's dropout masks on one shard, a function
    of (seed, step, shard) alone: seeded by a numpy ``SeedSequence`` of
    the three."""
    state = np.random.SeedSequence([seed, step, shard]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


def moe_aux_and_dropped(model) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The last forward's MoE aux losses summed over the layers, and their
    drop shares' mean (None, None for a dense model)."""
    layers = list(moe_layers(model))
    if not layers:
        return None, None
    return (sum(m.aux_loss for m in layers),
            sum(m.dropped_frac for m in layers) / len(layers))


def make_lm_train_step(*, grad_clip_norm: float = 0.0, fused_ce: bool = True,
                       nan_guard: bool = False, mesh: Optional[Mesh] = None, config=None,
                       dropout_seed: int = 0, fsdp: bool = False):
    """``step(state, batch) -> (state, metrics)`` with ``batch``
    ``{"tokens", "labels", "weights"}`` ``[B, L]`` on the model's device:
    this rank's shard on a ``mesh`` (``train.lm_trainer.shard_lm_batch``).
    Metrics are 0-dim device tensors (reading one waits for the step), the
    same on every rank: ``loss``, ``tokens``, ``grad_norm`` (with
    clipping), ``step_good`` (with ``nan_guard``, which reads its verdict
    on the host every step) and ``moe_dropped_frac`` (MoE models).
    ``config``, when given, is checked against the mesh. A model with
    dropout draws its masks from ``dropout_generator(dropout_seed,
    state.step, shard)``. ``fsdp``: the state's parameters are
    ``shard_lm_state(..., fsdp=True)``'s parts over the mesh's data axis.
    A tensor-parallel ``config`` needs its state placed
    (``shard_lm_state(..., config=)``)."""
    if config is not None:
        check_seq_parallel_attention(mesh, config)
    if fsdp and mesh is None:
        raise ValueError("fsdp=True shards over a mesh's data axis: pass mesh")
    n_shards = 1 if mesh is None else mesh.data.size * mesh.seq.size

    def step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        if config is not None:
            check_model_axis(mesh, config, model)
        model.train()
        opt.zero_grad(set_to_none=True)
        positions, offset = shard_positions(model.cfg, batch["tokens"], mesh)
        # the global count: each rank's loss is its share of the global mean
        count = _over_mesh(mesh, batch["weights"].sum())
        rng = None
        if model.cfg.dropout > 0.0:
            rng = dropout_generator(dropout_seed, state.step, shard_index(mesh),
                                    batch["tokens"].device)
        # FSDP: the whole leaves, all-gathered; their gradients come back
        # to the parts reduce-scattered over data (sums). TP parts stay
        # local
        full = gather_params(model, state.layout, mesh.data, mean=False) if fsdp else {}
        out = call_with(model, full, batch["tokens"], position_offset=offset,
                         positions=positions, return_hidden=fused_ce, dropout_rng=rng)
        loss = lm_loss_sum(out, model, batch, fused_ce, full.get("lm_head.weight"))
        loss = loss / torch.clamp(count, min=1.0)
        aux, dropped = moe_aux_and_dropped(model)
        if aux is not None:
            loss = loss + aux / n_shards
        loss.backward()
        named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
        grads = [g for _, g in named]
        zero = zero_parts(state.layout) if fsdp else {}
        if mesh is not None and mesh.data_seq.size > 1:
            # ZeRO parts came back summed over data: add the seq shards';
            # everything else (TP parts, whole leaves) sums over data x seq
            all_reduce_grads([g for n, g in named if n not in zero], mesh.data_seq.group)
            if zero and mesh.seq.size > 1:
                all_reduce_grads([g for n, g in named if n in zero], mesh.seq.group)
        metrics = {"loss": _over_mesh(mesh, loss.detach().clone()), "tokens": count}
        if dropped is not None:
            metrics["moe_dropped_frac"] = _over_mesh(mesh, dropped.detach() / n_shards)
        if grad_clip_norm:
            # each square sum over the axis its leaf is split on
            axes = None if mesh is None else [getattr(mesh, state.layout[n].axis)
                                              if n in state.layout else None
                                              for n, _ in named]
            metrics["grad_norm"] = clip_grads_by_global_norm(grads, grad_clip_norm, axes)
        lr = state.lr_schedule(state.updates)
        for group in opt.param_groups:
            group["lr"] = lr
        if nan_guard:
            # over every rank of the job: a TP part's NaN on one model rank
            # vetoes the update on all of them
            good = finite_ok(metrics["loss"], grads).int()
            if mesh is not None:
                all_reduce_(good, torch.distributed.ReduceOp.MIN)
            good = good > 0
            state.updates += int(guarded_step(good, opt))
            metrics["step_good"] = good.float()
        else:
            opt.step()
            state.updates += 1
        state.step += 1
        return state, metrics

    return step


def make_lm_eval_step(*, fused_ce: bool = True, mesh: Optional[Mesh] = None, config=None,
                      fsdp: bool = False):
    """``eval_step(state, batch, acc) -> acc``: adds the batch's weighted
    CE sum and token count, summed over data x seq, to the device
    accumulator (``empty_lm_metrics``); perplexity is
    exp(loss_sum / tokens). MoE layers run at the relaxed evaluation
    capacity (``models.moe.eval_capacity_factor``), dropout is off.
    ``fsdp``: the parts are all-gathered first, as in the train step."""
    if config is not None:
        check_seq_parallel_attention(mesh, config)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, acc: Batch) -> Batch:
        model = state.model
        if config is not None:
            check_model_axis(mesh, config, model)
        model.eval()
        positions, offset = shard_positions(model.cfg, batch["tokens"], mesh)
        full = gather_params(model, state.layout, mesh.data, mean=False) if fsdp else {}
        with relaxed_capacity(model, eval_capacity_factor(model.cfg)):
            out = call_with(model, full, batch["tokens"], position_offset=offset,
                             positions=positions, return_hidden=fused_ce)
        acc["loss_sum"] += _over_mesh(mesh, lm_loss_sum(out, model, batch, fused_ce,
                                                        full.get("lm_head.weight")))
        acc["tokens"] += _over_mesh(mesh, batch["weights"].sum())
        return acc

    return eval_step


def empty_lm_metrics(device=None) -> Batch:
    return {"loss_sum": torch.zeros((), dtype=torch.float32, device=device),
            "tokens": torch.zeros((), dtype=torch.float32, device=device)}
