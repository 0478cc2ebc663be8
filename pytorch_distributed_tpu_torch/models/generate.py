"""Token sampling and the serving-config checks
(``pytorch_distributed_tpu/models/generate.py:62-80, 282``)."""

from __future__ import annotations

from typing import Optional

import torch

from pytorch_distributed_tpu_torch.ops.attention import NEG_INF


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


def _validate_serving_config(config) -> None:
    """The JAX check without its mesh half (tensor-parallel serving is
    not ported): generation is dense-attention only, because the KV cache
    is the whole sequence."""
    if getattr(config, "attention", "dense") != "dense":
        raise ValueError(
            "generation is dense-attention only (the KV cache IS the global "
            "sequence); build the serving config with attention='dense'")
