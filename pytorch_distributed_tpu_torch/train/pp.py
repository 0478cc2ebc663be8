"""The LM trained through the GPipe pipeline (``pytorch_distributed_tpu/train/pp.py``).

The layer stack splits into S uniform stages of ``layers_per_stage``
``models.transformer.Block``s on the mesh's model axis (``parallel.mesh``,
stage = model index). Each stage rank holds a ``PPLM``: the embedding
(``PPEmbed``), its own stage (``PPStage``) and the head (``PPHead``). The
embedding and head are replicated on every stage; only stage 0's
embedding feeds the pipeline and only the last stage's head computes the
loss. The state's global tree is JAX's ``{"embed", "stages": [S, ...]
stacked, "head"}``: ``TrainState.layout`` marks each ``stages.*``
parameter as index s of its stacked leaf, so checkpoints hold the stacked
global leaves (``models.convert.pp_stack``) and restore into any stage
count's trainer that divides the layers.

The step (``make_pp_lm_train_step``, JAX ``make_pp_lm_train_step``:389):

- the batch is the data replica's rows on every stage, split into M
  microbatches; ``parallel.pipeline.gpipe`` runs them through the stages,
  the last stage's loss of each microbatch being its weighted CE sum over
  the global token count (``_head_loss_sum``:345, through the port's fused
  CE by default), and each MoE block's pre-weighted aux loss entering as
  its share ``aux / (M · data replicas)`` on the stage that holds it;
- gradients: a stage's own stay local; the embedding's and the head's have
  one real contributor on the model axis (stage 0, stage S-1), so their sum
  over the model group is their gradient; then every gradient is summed
  over the data group (each rank's loss is its share of the global mean);
- the global norm for clipping sums the stages' squares over the model
  group and counts the embedding and head once (``grad_norm``, a metric
  the JAX step computes but does not report);
- AdamW on every rank's parameters, so the replicated embedding and head
  take the same update on every stage;
- dropout: the masks of stage s on microbatch m come from a generator
  seeded by (seed, step, data shard, s, m) alone (``pp_dropout_generator``;
  JAX's ``pp_dropout_key``:373 folds the same into its key), so the
  sequential reference and a resumed run draw the same masks; the bits are
  torch's;
- the loss metric sums the last stages' CE shares and every stage's aux
  shares over the grid; ``pp_bubble_frac`` is (S-1)/(M+S-1).

No stage recomputes its activations: each keeps its M microbatches'
activations from the forward to the backward (JAX's ``gpipe`` runs
``remat=True``), so each stage launches its flash forward (L/S)·M times a
step and the fused backward as many.

``make_pp_reference_step`` runs the same stacked parameters through the S
stages in sequence on one device, microbatched alike: the reference the
pipeline is held to.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.models.convert import init_params, params_from_jax, pp_stack
from pytorch_distributed_tpu_torch.models.moe import moe_layers
from pytorch_distributed_tpu_torch.models.transformer import (
    Block,
    Dense,
    Embed,
    LayerNorm32,
    TransformerConfig,
    dropout,
    rope_angles,
    use_moe,
)
from pytorch_distributed_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
from pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from pytorch_distributed_tpu_torch.ops.optim import adamw, clip_grads_by_global_norm
from pytorch_distributed_tpu_torch.parallel.collectives import all_reduce_, all_reduce_grads
from pytorch_distributed_tpu_torch.parallel.mesh import AxisGroup, Mesh
from pytorch_distributed_tpu_torch.parallel.pipeline import gpipe
from pytorch_distributed_tpu_torch.train.state import TrainState
from pytorch_distributed_tpu_torch.utils.checkpoint import Shard

Batch = Dict[str, torch.Tensor]


class PPEmbed(nn.Module):
    """Token embeddings plus the learned positions' (arange: pipeline
    batches are never seq-sharded); under RoPE the rows alone."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.wte = Embed(cfg, cfg.vocab_size, cfg.embed_dim)
        if cfg.pos_embedding == "learned":
            self.wpe = Embed(cfg, cfg.max_seq_len, cfg.embed_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.wte(tokens)
        if self.cfg.pos_embedding == "rope":
            return x
        return x + self.wpe(torch.arange(tokens.shape[1], device=tokens.device))


class PPStage(nn.Module):
    """One stage: ``layers_per_stage`` Blocks, the MoE ones by the global
    ``moe_every`` pattern (which repeats per stage: ``create_pp_lm_state``
    checks ``layers_per_stage % moe_every == 0``)."""

    def __init__(self, cfg: TransformerConfig, layers_per_stage: int):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(Block(cfg, use_moe(cfg, j))
                                    for j in range(layers_per_stage))

    def forward(self, x: torch.Tensor, drop=None) -> torch.Tensor:
        cfg = self.cfg
        rope = None
        if cfg.pos_embedding == "rope":
            rope = rope_angles(torch.arange(x.shape[1], device=x.device), cfg.head_dim,
                               cfg.rope_theta)
        for blk in self.layers:
            x = blk(x, rope=rope, drop=drop)
        return x


class PPHead(nn.Module):
    """``ln_f`` and ``lm_head``: the fp32 hidden states for the fused CE,
    or fp32 logits."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln_f = LayerNorm32(cfg.embed_dim)
        self.lm_head = Dense(cfg, cfg.embed_dim, cfg.vocab_size, bias=False)

    def forward(self, x: torch.Tensor, return_hidden: bool = False) -> torch.Tensor:
        x = self.ln_f(x)
        return x if return_hidden else self.lm_head(x).float()


class PPLM(nn.Module):
    """A stage rank's model: the replicated ``embed`` and ``head`` and its
    own stage as ``stages`` (whose parameters are one index of the global
    stacked leaves of the same names)."""

    def __init__(self, cfg: TransformerConfig, n_stages: int):
        super().__init__()
        self.cfg = cfg
        self.embed = PPEmbed(cfg)
        self.stages = PPStage(cfg, cfg.num_layers // n_stages)
        self.head = PPHead(cfg)


class PPReference(nn.Module):
    """All S stages on one device, for ``make_pp_reference_step``."""

    def __init__(self, cfg: TransformerConfig, n_stages: int):
        super().__init__()
        self.cfg = cfg
        self.embed = PPEmbed(cfg)
        self.stage_list = nn.ModuleList(PPStage(cfg, cfg.num_layers // n_stages)
                                        for _ in range(n_stages))
        self.head = PPHead(cfg)

    def load_stacked(self, stacked: Dict[str, torch.Tensor]) -> None:
        """Load a stacked state dict (``pp_stack``'s layout)."""
        sd = {}
        for k, v in stacked.items():
            if k.startswith("stages."):
                for s in range(len(self.stage_list)):
                    sd[f"stage_list.{s}.{k[len('stages.'):]}"] = v[s]
            else:
                sd[k] = v
        self.load_state_dict(sd)

    def stacked_state_dict(self) -> Dict[str, torch.Tensor]:
        out, stages = {}, {}
        for k, v in self.state_dict().items():
            if k.startswith("stage_list."):
                s, rest = k[len("stage_list."):].split(".", 1)
                stages.setdefault(rest, {})[int(s)] = v
            else:
                out[k] = v
        for rest, by_stage in stages.items():
            out["stages." + rest] = torch.stack([by_stage[s] for s in sorted(by_stage)])
        return out


def check_pp_config(config: TransformerConfig, n_stages: int) -> int:
    """``create_pp_lm_state``'s checks (:135-185); the layers a stage holds."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if config.num_layers % n_stages:
        raise ValueError(
            f"num_layers {config.num_layers} not divisible by n_stages {n_stages}")
    if getattr(config, "vocab_parallel", False):
        raise ValueError(
            "vocab_parallel does not compose with the PP trainer: PPEmbed/"
            "PPHead params are stage-replicated and their grads psum over "
            "the stage axis (train/pp.py grad combine) — a vocab-sharded "
            "embedding there would need its own placement + combine rules. "
            "Use the (data, seq, model) LM trainer for vocab parallelism.")
    if config.tp_size > 1:
        raise NotImplementedError(
            f"tp_size={config.tp_size} inside the pipeline's stages: not ported yet "
            "(ROADMAP.md, queue 1 item 6.5: the stages ride the model axis, and TP "
            "within them needs a stage axis of its own)")
    lps = config.num_layers // n_stages
    if config.n_experts and lps % config.moe_every:
        raise ValueError(
            f"stage stacking needs an identical MoE pattern per stage: "
            f"layers_per_stage {lps} must be divisible by moe_every "
            f"{config.moe_every}")
    return lps


def init_pp_params(config: TransformerConfig, n_stages: int, seed: int = 0
                   ) -> Dict[str, torch.Tensor]:
    """The stacked global state dict of the plain LM's flax-layout
    initialisation of ``seed`` (``models.convert.init_params``): the
    pipeline starts from the same weights as ``train.lm.create_lm_state``."""
    return pp_stack(params_from_jax(init_params(config, seed)), n_stages)


def _pp_config(config: TransformerConfig) -> TransformerConfig:
    return dataclasses.replace(config, param_dtype=torch.float32)


def create_pp_lm_state(config: TransformerConfig, n_stages: int, *,
                       lr_schedule: Callable[[int], float], weight_decay: float = 1e-4,
                       seed: int = 0, params: Optional[Dict[str, torch.Tensor]] = None,
                       mesh: Optional[Mesh] = None, device=None) -> TrainState:
    """This stage rank's state (stage = the mesh's model index; stage 0 of
    one without a mesh): a ``PPLM`` with fp32 parameters on ``device``
    (CUDA unless asked for the CPU), its part of ``params`` (a stacked
    global state dict, e.g. ``pp_params_from_jax``'s) or of
    ``init_pp_params(seed)``, AdamW over it, and ``layout`` marking the
    stage's parameters as index s of their stacked leaves, written by the
    stage's rank of data replica 0."""
    check_pp_config(config, n_stages)
    if mesh is not None and mesh.model.size != n_stages:
        raise ValueError(f"state has {n_stages} stages but the mesh's 'model' axis is "
                         f"{mesh.model.size} — they must match")
    cfg = _pp_config(config)
    stage = 0 if mesh is None else mesh.model.index
    stacked = params if params is not None else init_pp_params(cfg, n_stages, seed)
    dev = resolve_device(device)
    with torch.device(dev):
        model = PPLM(cfg, n_stages)
    owners = tuple(mesh.rank_of(model=i) if mesh is not None else 0 for i in range(n_stages))
    layout, local = {}, {}
    for k, v in stacked.items():
        if k.startswith("stages."):
            layout[k] = Shard(tuple(v.shape), 0, stage, owners, stacked=True, axis="model")
            v = v[stage]
        local[k] = v
    model.load_state_dict(local)
    return TrainState(model=model, optimizer=adamw(model.parameters(), weight_decay),
                      lr_schedule=lr_schedule, layout=layout)


def create_pp_reference_state(config: TransformerConfig, n_stages: int, *,
                              lr_schedule: Callable[[int], float], weight_decay: float = 1e-4,
                              seed: int = 0, params: Optional[Dict[str, torch.Tensor]] = None,
                              device=None) -> TrainState:
    """The sequential reference's state: every stage on one device, from
    ``params`` (stacked) or ``init_pp_params(seed)``."""
    check_pp_config(config, n_stages)
    cfg = _pp_config(config)
    with torch.device(resolve_device(device)):
        model = PPReference(cfg, n_stages)
    model.load_stacked(params if params is not None else init_pp_params(cfg, n_stages, seed))
    return TrainState(model=model, optimizer=adamw(model.parameters(), weight_decay),
                      lr_schedule=lr_schedule)


def pp_dropout_generator(seed: int, step: int, data_shard: int, stage: int, mb_idx: int,
                         device) -> torch.Generator:
    """The generator of stage ``stage``'s dropout masks on microbatch
    ``mb_idx`` of one step on one data shard, a function of the five alone
    (seeded by a numpy ``SeedSequence`` of them), shared by the pipelined
    and the sequential steps."""
    state = np.random.SeedSequence([seed, step, data_shard, stage, mb_idx]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return gen


def _stage_call(stage: PPStage, x: torch.Tensor, rng: Optional[torch.Generator]):
    """The stage's output and its MoE layers' summed aux loss (None for a
    dense stage)."""
    drop = None
    if rng is not None:
        rate = stage.cfg.dropout

        def drop(t):
            return dropout(t, rate, rng)

    y = stage(x, drop)
    layers = list(moe_layers(stage))
    return y, (sum(m.aux_loss for m in layers) if layers else None)


def _head_loss_sum(head: PPHead, y: torch.Tensor, batch: Batch, fused_ce: bool,
                   compute_dtype) -> torch.Tensor:
    """ln_f, lm_head and the weighted CE sum: through the fused CE, or
    the full logits' plain CE."""
    if fused_ce:
        return fused_linear_cross_entropy(head(y, return_hidden=True), head.lm_head.weight,
                                          batch["labels"], batch["weights"],
                                          compute_dtype=compute_dtype)
    logits = head(y)
    per_tok = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                                 batch["labels"].reshape(-1), reduction="none")
    return (per_tok * batch["weights"].reshape(-1)).sum()


def _sum_over(t: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    return t if axis.size == 1 else all_reduce_(t, group=axis.group)


def _microbatches(batch: Batch, m: int) -> list:
    b = batch["tokens"].shape[0]
    if b % m:
        raise ValueError(f"local batch {b} not divisible by n_microbatches {m}")
    n = b // m
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()} for i in range(m)]


def _pp_run(model: PPLM, batch: Batch, mesh: Mesh, n_microbatches: int, count, fused_ce,
            rngs: Optional[Callable[[int], torch.Generator]]):
    """The pipeline over this stage: stage 0 embeds each microbatch, the
    last computes each one's CE share ``loss_sum / count``."""
    cfg = model.cfg
    axis = mesh.model
    mbs = _microbatches(batch, n_microbatches)
    if axis.index == 0:
        inputs = [model.embed(mb["tokens"]) for mb in mbs]
    else:
        b, l = mbs[0]["tokens"].shape
        like = torch.empty((b, l, cfg.embed_dim), dtype=cfg.dtype,
                           device=batch["tokens"].device)
        inputs = [like] * n_microbatches
    has_aux = bool(cfg.n_experts)

    def stage_fn(stage, x, m):
        y, aux = _stage_call(stage, x, None if rngs is None else rngs(m))
        return (y, aux) if has_aux else y

    def head(y, m):
        return _head_loss_sum(model.head, y, mbs[m], fused_ce, cfg.dtype) / count

    return gpipe(stage_fn, model.stages, inputs, axis=axis, head=head, has_aux=has_aux)


def _check_mesh(mesh: Mesh, config: TransformerConfig) -> int:
    if mesh.seq.size > 1:
        raise ValueError(
            "the PP trainer shards batches over data only; use "
            "seq_parallel=1 (ring attention cannot run inside a "
            "pipeline stage)")
    return check_pp_config(config, mesh.model.size)


def make_pp_lm_train_step(mesh: Mesh, config: TransformerConfig, n_microbatches: int = 8, *,
                          dropout_seed: int = 0, grad_clip_norm: float = 0.0,
                          fused_ce: bool = True):
    """``step(state, batch) -> (state, metrics)`` over the pipeline (module
    docstring), ``batch`` ``{"tokens", "labels", "weights"}`` ``[B, L]``:
    the data replica's rows, the same on every stage. Metrics, 0-dim
    device tensors, the same on every rank: ``loss``, ``tokens``,
    ``pp_bubble_frac`` and with clipping ``grad_norm`` (pre-clip)."""
    _check_mesh(mesh, config)
    s_axis, data = mesh.model, mesh.data
    n_stages = s_axis.size
    last = s_axis.index == n_stages - 1

    def step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        dev = batch["tokens"].device
        count = torch.clamp(_sum_over(batch["weights"].sum(), data), min=1.0)
        rngs = None
        if config.dropout > 0.0:
            def rngs(m, step=state.step):
                return pp_dropout_generator(dropout_seed, step, data.index, s_axis.index, m, dev)
        pipe = _pp_run(model, batch, mesh, n_microbatches, count, fused_ce, rngs)
        aux_w = 1.0 / (n_microbatches * data.size)
        pipe.backward(aux_weight=aux_w)
        local = torch.zeros((), device=dev)
        if last:
            local = local + torch.stack(pipe.losses).sum().detach()
        if pipe.aux is not None:
            local = local + pipe.aux.detach() * aux_w
        # every parameter gets a gradient on every stage (zeros where the
        # stage did not use it), so the sums below match across ranks
        named = []
        for n, p in model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            named.append((n, p.grad))
        grads = [g for _, g in named]
        if n_stages > 1:
            all_reduce_grads([g for n, g in named if not n.startswith("stages.")], s_axis.group)
        if data.size > 1:
            all_reduce_grads(grads, data.group)
        metrics = {"loss": all_reduce_(local), "tokens": count,
                   "pp_bubble_frac": torch.tensor((n_stages - 1) / (n_microbatches + n_stages - 1),
                                                  device=dev)}
        if grad_clip_norm:
            metrics["grad_norm"] = clip_grads_by_global_norm(
                grads, grad_clip_norm,
                [s_axis if n.startswith("stages.") else None for n, _ in named])
        lr = state.lr_schedule(state.updates)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.updates += 1
        state.step += 1
        return state, metrics

    return step


def make_pp_lm_eval_step(mesh: Mesh, config: TransformerConfig, n_microbatches: int = 8, *,
                         fused_ce: bool = True):
    """``eval_step(state, batch, acc) -> acc`` over the pipeline, forward
    only (dropout off; MoE at the training capacity, as the JAX
    pipeline's eval step runs it): the last stages' CE sums and the token
    count, summed over the grid, added to ``train.lm.empty_lm_metrics``'
    accumulator."""
    _check_mesh(mesh, config)
    s_axis, data = mesh.model, mesh.data
    last = s_axis.index == s_axis.size - 1

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, acc: Batch) -> Batch:
        model = state.model
        model.eval()
        pipe = _pp_run(model, batch, mesh, n_microbatches, 1.0, fused_ce, None)
        local = torch.zeros((), device=batch["tokens"].device)
        if last:
            local = local + torch.stack(pipe.losses).sum()
        acc["loss_sum"] += all_reduce_(local)
        acc["tokens"] += _sum_over(batch["weights"].sum(), data)
        return acc

    return eval_step


def make_pp_reference_step(config: TransformerConfig, n_stages: int, n_microbatches: int = 1,
                           *, dropout_seed: int = 0, grad_clip_norm: float = 0.0,
                           fused_ce: bool = True):
    """The sequential step over a ``create_pp_reference_state`` state
    (``make_pp_reference_step``:618): the same stacked parameters, stage
    after stage on one device, microbatched as the pipeline (the same MoE
    token groups, the same ``pp_dropout_generator`` masks, data shard 0),
    the loss CE / count + Σ aux / M, AdamW. Metrics ``loss``, ``tokens``
    and with clipping ``grad_norm``."""
    check_pp_config(config, n_stages)

    def step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        dev = batch["tokens"].device
        count = torch.clamp(batch["weights"].sum(), min=1.0)
        loss = torch.zeros((), device=dev)
        aux_total = torch.zeros((), device=dev)
        for m, mb in enumerate(_microbatches(batch, n_microbatches)):
            act = model.embed(mb["tokens"])
            for s, stage in enumerate(model.stage_list):
                rng = (pp_dropout_generator(dropout_seed, state.step, 0, s, m, dev)
                       if config.dropout > 0.0 else None)
                act, aux = _stage_call(stage, act, rng)
                if aux is not None:
                    aux_total = aux_total + aux
            loss = loss + _head_loss_sum(model.head, act, mb, fused_ce, config.dtype) / count
        loss = loss + aux_total / n_microbatches
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics = {"loss": loss.detach(), "tokens": count}
        if grad_clip_norm:
            metrics["grad_norm"] = clip_grads_by_global_norm(grads, grad_clip_norm)
        lr = state.lr_schedule(state.updates)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.updates += 1
        state.step += 1
        return state, metrics

    return step


def pp_microbatches(requested: int, batch_size: int) -> Tuple[int, Optional[str]]:
    """The microbatch count: ``requested`` clamped to a divisor of the
    per-shard ``batch_size`` (``LMTrainer``:309-324), and the message that
    says so when it changed."""
    if requested < 1:
        raise ValueError(f"pp_microbatches must be >= 1, got {requested}")
    mb = min(requested, batch_size)
    while batch_size % mb:
        mb -= 1
    note = None
    if mb != requested:
        note = (f"pp_microbatches {requested} -> {mb} "
                f"(must divide the per-shard batch {batch_size})")
    return mb, note
