"""Token sampling, the serving-config checks and generation over a dense
KV cache (``pytorch_distributed_tpu/models/generate.py``).

- ``generate``: one causal forward prefills the cache over the prompt
  batch, then one forward a token decodes against it (greedy, temperature
  or top-k sampling).
- ``generate_ragged``: per-request prompt lengths; the prompts are
  right-padded, prefilled in one forward, and each request decodes from
  its own position. Padding needs no mask: causal attention hides a
  prompt's padded tail from its real tokens, and decode writes over the
  padding's K/V before the ``<= position`` mask reaches it.
- ``ContinuousBatcher``: requests admitted and retired at token boundaries
  across ``n_slots`` decode lanes, over the paged engine
  (``cache_layout="paged"``, the kernels of ``ops.paged_flash``) or one
  ``max_seq_len`` cache row per slot (``"dense"``).

- ``generate_tp``, ``generate_ragged_tp`` and ``ContinuousBatcher(mesh=)``:
  the same under Megatron tensor parallelism (a config with ``tp_size`` T
  and ``model_axis``, and the ``parallel.mesh.Mesh`` whose model axis has
  T ranks). Every model rank runs the call with the same arguments: it
  keeps its part of the global ``params`` (``models.convert.tp_parts`` of
  ``train.lm.tp_layout``; the JAX ``_tp_rules``), its cache holds its
  H_kv/T heads (the JAX ``_cache_specs``), the model's ``tp_copy`` /
  ``tp_reduce`` run inside each forward, and the logits come out whole on
  every rank, so each rank samples the same tokens from a generator seeded
  the same.

The cache is ``models.transformer.DenseCache`` per layer, written in
place. The JAX module compiles prefill and a ``lax.scan`` of decode steps
as one program; here they run as one forward each. ``params`` is a state
dict of ``TransformerLM`` (``models.convert.params_from_jax``; under TP the
global one) or the built model (under TP, a rank's). The entry points run
on CUDA unless ``device="cpu"`` is passed. Sampling draws from a
``torch.Generator``, not ``jax.random``, so only greedy streams are
comparable with the JAX package's; sampled TP streams are comparable with
the port's replicated ones.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.models.transformer import DenseCache, TransformerLM
from pytorch_distributed_tpu_torch.ops.attention import NEG_INF

CACHE_LAYOUTS = ("paged", "dense")


def _sample(logits: torch.Tensor, temperature: float, top_k: Optional[int],
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Next tokens ``[B]`` int32 from logits ``[B, V]``. Temperature 0 is
    greedy: argmax, which takes the first of equal maxima in torch as in
    jnp. Otherwise the logits divide by the temperature, ``top_k`` keeps
    the k largest (ties with the k-th stay), and ``generator`` draws. The
    draws differ from ``jax.random``'s for the same seed.

    The draw is ``torch.multinomial(probs, 1, generator)``'s own one-sample
    path written out, argmax of ``probs / q`` with ``q ~ Exp(1)`` from the
    generator: the same numbers from the same generator state, without
    multinomial's checks of the probabilities, which read them on the host
    and so cannot enter a CUDA graph. Inside a graph, ``generator`` must be
    registered with it (``CUDAGraph.register_generator_state``) so that
    each replay draws anew."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / max(temperature, 1e-6)
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1).to(torch.int32)


def _validate_sampling(config, temperature: float, top_k: Optional[int]) -> None:
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k is not None and not 1 <= top_k <= config.vocab_size:
        raise ValueError(
            f"top_k must be in [1, vocab_size={config.vocab_size}], got {top_k}")


def _validate_dense_decode(config) -> None:
    if getattr(config, "attention", "dense") != "dense":
        raise ValueError(
            "generation is dense-attention only (the KV cache IS the global "
            "sequence); build the decode config with attention='dense' — "
            "ring/ring_flash are training-time sequence-parallel layouts")


def _validate_serving_config(config, mesh=None) -> None:
    """The JAX check (``_validate_serving_config``:282): generation is
    dense-attention only, because the KV cache is the whole sequence; a
    mesh needs a TP config, a TP config needs the mesh, and the mesh's
    model axis must have ``tp_size`` ranks."""
    _validate_dense_decode(config)
    if mesh is not None and config.model_axis is None:
        raise ValueError(
            "a mesh was passed but config.model_axis is unset — serving "
            "would silently run replicated on one device; set "
            "model_axis/tp_size (or drop mesh=)")
    if config.model_axis is not None:
        if mesh is None:
            raise ValueError(
                "a TP config (model_axis set) needs the mesh: pass "
                "mesh= to ContinuousBatcher/generate_ragged_tp — or "
                "clear model_axis/tp_size for replicated serving")
        if mesh.axis_size(config.model_axis) != config.tp_size:
            raise ValueError(
                f"mesh {config.model_axis!r} size "
                f"{mesh.axis_size(config.model_axis)} != tp_size "
                f"{config.tp_size}")


def _require_tp(config, what: str, replicated: str) -> None:
    if config.model_axis is None or config.tp_size <= 1:
        raise ValueError(
            f"{what} needs a TP config (model_axis + tp_size > 1); "
            f"use {replicated}() for replicated "
            f"{'decoding' if what == 'generate_tp' else 'serving'}")


def tp_state(config, params, mesh) -> dict:
    """This model rank's state dict from the global one (``params``, e.g.
    ``params_from_jax``'s): each leaf a Megatron rule of ``config`` claims
    cut to the rank's part (``train.lm.tp_layout``; the JAX serving
    ``_tp_rules``), the rest whole. ``params`` itself without TP."""
    if config.tp_size == 1:
        return params
    from pytorch_distributed_tpu_torch.models.convert import tp_parts
    from pytorch_distributed_tpu_torch.train.lm import tp_layout

    shapes = {k: tuple(v.shape) for k, v in params.items()}
    owners = tuple(mesh.rank_of(model=i) for i in range(mesh.model.size))
    return tp_parts(params, tp_layout(config, shapes, mesh.model.index, owners))


def _validate_generate_args(config, prompt, max_new_tokens: int, temperature: float,
                            top_k: Optional[int]) -> None:
    l_prompt = prompt.shape[1]
    if l_prompt < 1:
        raise ValueError("prompt must contain at least one token")
    if l_prompt + max_new_tokens > config.max_seq_len:
        raise ValueError(
            f"prompt ({l_prompt}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq_len {config.max_seq_len}")
    _validate_sampling(config, temperature, top_k)
    _validate_dense_decode(config)


def _validate_ragged(config, prompts, max_new_tokens: int, temperature: float = 0.0,
                     top_k: Optional[int] = None) -> None:
    _validate_serving_config(config)
    _validate_sampling(config, temperature, top_k)
    # the worst case: any request may be full-length (lengths[b] == L_max)
    if prompts.shape[1] + max_new_tokens > config.max_seq_len:
        raise ValueError(
            f"padded prompt length ({prompts.shape[1]}) + max_new_tokens "
            f"({max_new_tokens}) exceeds max_seq_len {config.max_seq_len} "
            "(static worst case: a request may be full-length)")


def _model(config, params, device=None, mesh=None) -> TransformerLM:
    """``params`` as a model in eval mode: a ``TransformerLM`` as it is, a
    state dict loaded into one built on ``device`` (under TP this rank's
    part of it, ``tp_state``)."""
    if isinstance(params, TransformerLM):
        return params
    with torch.device(resolve_device(device)):
        model = TransformerLM(config)
    model.load_state_dict(tp_state(config, params, mesh))
    return model.eval().requires_grad_(False)


def _device_of(model: TransformerLM) -> torch.device:
    return next(model.parameters()).device


def _generator(device: torch.device, generator: Optional[torch.Generator],
               seed: int) -> torch.Generator:
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(seed)


def init_cache(config, batch_size: int, device=None) -> List[DenseCache]:
    """A zero dense cache: per layer ``DenseCache`` of ``[batch_size,
    max_seq_len, H_kv, D]`` K and V in ``config.dtype`` (H_kv = the
    config's ``kv_heads``, a rank's ``kv_heads // tp_size`` under TP)."""
    device = resolve_device(device)
    shape = (batch_size, config.max_seq_len, config.kv_heads // config.tp_size,
             config.head_dim)
    return [DenseCache(torch.zeros(shape, dtype=config.dtype, device=device),
                       torch.zeros(shape, dtype=config.dtype, device=device))
            for _ in range(config.num_layers)]


@torch.no_grad()
def generate(config, params, prompt, max_new_tokens: int = 32, temperature: float = 0.0,
             top_k: Optional[int] = None, *, seed: int = 0,
             generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Continue ``prompt`` ``[B, L]`` by ``max_new_tokens`` tokens; returns
    ``[B, L + max_new_tokens]`` int32 on the model's device. Temperature 0
    is greedy; otherwise ``generator`` (or one seeded with ``seed``)
    draws. A TP config is refused, as in JAX: ``generate_tp``."""
    _validate_generate_args(config, prompt, max_new_tokens, temperature, top_k)
    if config.model_axis is not None:
        raise ValueError(
            "generate() runs replicated; for tensor-parallel decoding use "
            "generate_tp(mesh, config, params, ...) — or clear "
            "model_axis/tp_size (checkpoints are interchangeable across tp "
            "degrees, so TP-trained params load into the replicated config)")
    return _generate_core(config, _model(config, params, device), prompt, max_new_tokens,
                          temperature, top_k, seed, generator)


@torch.no_grad()
def generate_tp(mesh, config, params, prompt, max_new_tokens: int = 32,
                temperature: float = 0.0, top_k: Optional[int] = None, *, seed: int = 0,
                generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """Tensor-parallel ``generate`` (JAX ``generate_tp``:147), called on
    every model rank of ``mesh`` with the same arguments: the rank keeps
    its part of the global ``params``, its cache holds its heads, and the
    tokens, sampled on the whole logits every rank holds, come out the same
    on every rank."""
    _require_tp(config, "generate_tp", "generate")
    if mesh.axis_size(config.model_axis) != config.tp_size:
        raise ValueError(
            f"mesh {config.model_axis!r} size {mesh.axis_size(config.model_axis)} "
            f"!= tp_size {config.tp_size}")
    _validate_generate_args(config, prompt, max_new_tokens, temperature, top_k)
    return _generate_core(config, _model(config, params, device, mesh), prompt,
                          max_new_tokens, temperature, top_k, seed, generator)


def _generate_core(config, model: TransformerLM, prompt, max_new_tokens: int,
                   temperature: float, top_k: Optional[int], seed: int,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """The prefill and the decode loop (JAX ``_generate_core``), replicated
    or on a TP rank's model."""
    dev = _device_of(model)
    prompt = torch.as_tensor(prompt, device=dev).long()
    gen = _generator(dev, generator, seed)
    b, l = prompt.shape
    cache = init_cache(config, b, dev)
    logits = model(prompt, 0, cache=cache)[:, -1]
    out = []
    for i in range(max_new_tokens):
        token = _sample(logits, temperature, top_k, gen)
        out.append(token)
        if i + 1 < max_new_tokens:  # the last token's logits are never read
            logits = model(token[:, None].long(), l + i, cache=cache, decode=True)[:, 0]
    return torch.cat([prompt.to(torch.int32)] + [t[:, None] for t in out], dim=1)


@torch.no_grad()
def ragged_prefill(config, params, prompts, lengths,
                   device=None) -> Tuple[List[DenseCache], torch.Tensor]:
    """One causal forward prefills every request's cache row.
    ``prompts`` ``[B, L_max]`` right-padded, ``lengths`` ``[B]`` (1 <=
    length <= L_max). Returns ``(cache, last_logits)``: ``last_logits[b]``
    the logits at request b's last real token."""
    model = _model(config, params, device)
    dev = _device_of(model)
    prompts = torch.as_tensor(prompts, device=dev).long()
    lengths = torch.as_tensor(lengths, device=dev).long()
    cache = init_cache(config, prompts.shape[0], dev)
    logits = model(prompts, 0, cache=cache)
    return cache, logits[torch.arange(prompts.shape[0], device=dev), lengths - 1]


@torch.no_grad()
def ragged_decode_step(config, params, cache: List[DenseCache], tokens,
                       positions) -> Tuple[List[DenseCache], torch.Tensor]:
    """Advance every row one token: ``tokens`` ``[B]`` written at
    ``positions`` ``[B]``. Returns ``(cache, logits [B, vocab])``, the
    cache being the one passed, written in place."""
    model = _model(config, params, cache[0].key.device)
    dev = _device_of(model)
    tokens = torch.as_tensor(tokens, device=dev).long()
    positions = torch.as_tensor(positions, device=dev).long()
    return cache, model(tokens[:, None], positions, cache=cache, decode=True)[:, 0]


@torch.no_grad()
def generate_ragged(config, params, prompts, lengths, max_new_tokens: int = 32,
                    temperature: float = 0.0, top_k: Optional[int] = None, *,
                    seed: int = 0, generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """Batched generation with per-request prompt lengths: ``prompts``
    ``[B, L_max]`` right-padded, ``lengths`` ``[B]``. Returns ``[B,
    max_new_tokens]`` int32, request b's continuation from its own
    position ``lengths[b]``."""
    _validate_ragged(config, prompts, max_new_tokens, temperature, top_k)
    return _ragged_core(config, _model(config, params, device), prompts, lengths,
                        max_new_tokens, temperature, top_k, seed, generator)


@torch.no_grad()
def generate_ragged_tp(mesh, config, params, prompts, lengths, max_new_tokens: int = 32,
                       temperature: float = 0.0, top_k: Optional[int] = None, *,
                       seed: int = 0, generator: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
    """Tensor-parallel ``generate_ragged`` (JAX ``generate_ragged_tp``:421),
    called on every model rank of ``mesh`` with the same arguments (the
    rank's parameter parts, its heads' cache, the same tokens on every
    rank)."""
    _require_tp(config, "generate_ragged_tp", "generate_ragged")
    _validate_serving_config(config, mesh)
    _validate_sampling(config, temperature, top_k)
    if prompts.shape[1] + max_new_tokens > config.max_seq_len:
        raise ValueError(
            f"padded prompt length ({prompts.shape[1]}) + max_new_tokens "
            f"({max_new_tokens}) exceeds max_seq_len {config.max_seq_len}")
    return _ragged_core(config, _model(config, params, device, mesh), prompts, lengths,
                        max_new_tokens, temperature, top_k, seed, generator)


def _ragged_core(config, model: TransformerLM, prompts, lengths, max_new_tokens: int,
                 temperature: float, top_k: Optional[int], seed: int,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    dev = _device_of(model)
    gen = _generator(dev, generator, seed)
    cache, logits = ragged_prefill(config, model, prompts, lengths)
    pos = torch.as_tensor(lengths, device=dev).long()
    out = []
    for i in range(max_new_tokens):
        token = _sample(logits, temperature, top_k, gen)
        out.append(token)
        if i + 1 < max_new_tokens:
            cache, logits = ragged_decode_step(config, model, cache, token, pos + i)
    if not out:
        return torch.zeros((pos.shape[0], 0), dtype=torch.int32, device=dev)
    return torch.stack(out, dim=1)


class ContinuousBatcher:
    """Continuous batching over ``n_slots`` decode lanes: ``submit``
    prefills one request into a free slot, ``step`` advances every active
    slot one token and retires those at their budget (or at ``eos_id``),
    so requests enter and leave at token boundaries.

    ``cache_layout="paged"`` (the default) runs on ``serving.PagedEngine``:
    admission allocates a block chain and prefills chunk by chunk
    (``prefill_bucket`` is the chunk), decode is the engine's tick. The
    knobs ``block_len``, ``n_blocks``, ``gather_impl``, ``kv_dtype`` and
    ``split_s`` are the engine's. ``"dense"`` keeps one ``max_seq_len``
    cache row per slot: ``submit`` prefills the prompt padded to
    ``prefill_bucket`` into its slot's row, ``step`` decodes every slot
    against its row. Both give the same greedy streams. For queueing
    instead of a refused submit, use ``serving.Scheduler``.

    ``mesh`` (with a TP config): every model rank builds the batcher from
    the same global ``params`` and drives it with the same calls; it holds
    its parameter parts and its heads of the cache (either layout; the
    paged engine's pool is its H_kv/T heads), and every rank steps out the
    same tokens. ``cuda_graphs`` is the paged engine's (``False`` on a gloo
    group sharing one card, which stages every collective through the
    host)."""

    def __init__(self, config, params, n_slots: int, temperature: float = 0.0,
                 top_k: Optional[int] = None, prefill_bucket: int = 128, seed: int = 0,
                 eos_id: Optional[int] = None, mesh=None, cache_layout: str = "paged",
                 block_len: int = 16, n_blocks: Optional[int] = None,
                 gather_impl: Optional[str] = None, kv_dtype: Optional[str] = None,
                 split_s: Optional[int] = None, cuda_graphs: bool = True, device=None):
        _validate_serving_config(config, mesh)
        _validate_sampling(config, temperature, top_k)
        if eos_id is not None and not 0 <= eos_id < config.vocab_size:
            raise ValueError(
                f"eos_id {eos_id} outside [0, vocab_size={config.vocab_size})")
        if cache_layout not in CACHE_LAYOUTS:
            raise ValueError(
                f"cache_layout {cache_layout!r} must be 'paged' (block-pooled KV, "
                "O(prompt) admission) or 'dense' (one max_seq_len row per slot)")
        if cache_layout != "paged" and (gather_impl not in (None, "dense")
                                        or kv_dtype is not None or split_s is not None):
            raise ValueError(
                "gather_impl=/kv_dtype=/split_s= are block-pool knobs (the dense "
                "layout has no block tables to gather through, no quantized pool, "
                "and no chain sweep to split); use cache_layout='paged'")
        self.config = config
        self.n_slots = n_slots
        self.temperature = temperature
        self.top_k = top_k
        self.prefill_bucket = prefill_bucket
        self.eos_id = eos_id
        self.cache_layout = cache_layout
        self.positions = np.zeros(n_slots, np.int64)
        self.remaining = np.zeros(n_slots, np.int64)
        if cache_layout == "paged":
            from pytorch_distributed_tpu_torch.serving.engine import PagedEngine

            self.engine = PagedEngine(
                config, params, n_slots, n_blocks=n_blocks, block_len=block_len,
                prefill_chunk=prefill_bucket, temperature=temperature, top_k=top_k,
                gather_impl=gather_impl, kv_dtype=kv_dtype, split_s=split_s,
                seed=seed, cuda_graphs=cuda_graphs, mesh=mesh, device=device)
            self.config = self.engine.config
            self.device = self.engine.device
            return
        self.engine = None
        self.model = _model(config, params, device, mesh)
        self.device = _device_of(self.model)
        self._cache = init_cache(config, n_slots, self.device)
        self._logits = torch.zeros((n_slots, config.vocab_size), dtype=torch.float32,
                                   device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @property
    def cache(self):
        """The KV cache: the block pools under the paged layout (per layer
        ``[n_blocks, block_len, H_kv, D]``), the per-slot rows (``[n_slots,
        max_seq_len, H_kv, D]``) under the dense one; a rank's H_kv/T heads
        under TP."""
        return self.engine.cache if self.engine is not None else self._cache

    @property
    def logits(self) -> torch.Tensor:
        """Each slot's next-token logits ``[n_slots, vocab]``."""
        return self.engine.logits if self.engine is not None else self._logits

    def free_slots(self) -> List[int]:
        return [i for i in range(self.n_slots) if self.remaining[i] == 0]

    def _validate_submit(self, l: int, max_new_tokens: int) -> None:
        if l < 1:
            raise ValueError("prompt must contain at least one token")
        pad = -l % self.prefill_bucket
        # the prefill writes l + pad rows; decode reaches l + max_new - 1
        if l + pad > self.config.max_seq_len:
            raise ValueError(
                f"prompt ({l}) padded to {l + pad} exceeds max_seq_len "
                f"{self.config.max_seq_len}")
        if l + max_new_tokens > self.config.max_seq_len:
            raise ValueError(
                f"prompt ({l}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_seq_len {self.config.max_seq_len}")

    @torch.no_grad()
    def submit(self, prompt, max_new_tokens: int) -> int:
        """Admit one request (``[L]`` tokens); returns its slot. Raises when
        no slot is free or the request cannot fit the cache (paged: also
        when an undersized ``n_blocks`` pool is exhausted)."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free decode slot; call step() to drain")
        slot = free[0]
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        l = len(prompt)
        self._validate_submit(l, max_new_tokens)
        if self.engine is not None:
            from pytorch_distributed_tpu_torch.serving.engine import ChunkJob

            if not self.engine.admit(slot, l, max_new_tokens):
                raise RuntimeError(
                    "KV block pool exhausted (custom n_blocks below slot capacity); "
                    "retire requests, raise n_blocks, or use serving.Scheduler to "
                    "queue admissions")
            c = self.engine.chunk
            for start in range(0, l, c):  # in order: chunk n+1 reads chunk n's KV
                seg = prompt[start:start + c]
                tokens = np.zeros((c,), np.int32)
                tokens[:len(seg)] = seg
                is_last = start + c >= l
                self.engine.run_chunks([ChunkJob(
                    slot=slot, tokens=tokens, start=start, is_last=is_last,
                    last_idx=(l - 1 - start) if is_last else 0)])
        else:
            padded = np.zeros((1, l + (-l % self.prefill_bucket)), np.int64)
            padded[0, :l] = prompt
            # the slot's row prefilled in place; K/V a previous request left
            # past l + pad is masked out until decode writes over it
            row = [DenseCache(c.key[slot:slot + 1], c.value[slot:slot + 1])
                   for c in self._cache]
            logits = self.model(torch.as_tensor(padded, device=self.device), 0, cache=row)
            self._logits[slot] = logits[0, l - 1]
        self.positions[slot] = l
        self.remaining[slot] = max_new_tokens
        return slot

    @torch.no_grad()
    def step(self) -> List[Tuple[int, int]]:
        """One decode tick for every active slot; returns ``[(slot,
        token)]``. A slot that reaches its budget, or emits ``eos_id``,
        retires at once and is free for the next ``submit``."""
        active = self.remaining > 0
        if not active.any():
            return []
        if self.engine is not None:
            toks, self.positions = self.engine.decode(self.positions, active)
        else:
            tokens = _sample(self._logits, self.temperature, self.top_k, self.generator)
            # idle rows step at position 0 of their own row: dead state,
            # rewritten by the next submit
            pos = torch.as_tensor(np.where(active, self.positions, 0), device=self.device)
            self._logits = self.model(tokens[:, None].long(), pos, cache=self._cache,
                                      decode=True)[:, 0]
            self.positions = np.where(active, self.positions + 1, self.positions)
            toks = tokens.cpu().numpy()
        out = []
        for slot in np.nonzero(active)[0].tolist():
            token = int(toks[slot])
            out.append((slot, token))
            if self.eos_id is not None and token == self.eos_id:
                self.remaining[slot] = 0
            else:
                self.remaining[slot] -= 1
            if self.engine is not None and self.remaining[slot] == 0:
                # the chain goes back to the pool; the dead lane writes to trash
                self.engine.release(slot)
        return out
