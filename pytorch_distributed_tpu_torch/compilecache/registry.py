"""Program registry: every program a serve needs, enumerated ahead of
traffic (``pytorch_distributed_tpu/compilecache/registry.py``).

The JAX package compiles one XLA program per decode tick and per
chunk-prefill bucket. The port's counterpart of a compiled program is a
captured CUDA graph (``serving.PagedEngine``): one per bucket, replayed
with one launch. The registry lists every such program from the
engine's own geometry (``chunk_buckets``, ``handoff_buckets``,
``swap_buckets``) so that

- the warmup runtime (``compilecache.warmup``) can capture them before
  traffic, in priority order;
- the coverage guard (``ProgramRegistry.assert_covers``) fails a run
  whose engine holds a program no entry predicted;
- a run's fingerprint (torch and CUDA versions, the card, the config
  extras) says which environment the programs belong to.

Each spec carries a ``warm(execute)`` thunk. ``execute=True`` runs the
program once with inert inputs (writes to the trash block and a dump
logits row) before it is captured; ``execute=False`` captures without the
run. Both return the capture's own seconds (0.0 where nothing is
captured). The JAX package's XLA AOT probes (``aot_spec``,
``jit_cache_size``, ``ProgramSpec.aot``/``cache_probe``) have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional


class CoverageError(AssertionError):
    """A compiled program exists that no registry entry predicted."""


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One program a run will need.

    ``warm(execute)`` makes it ready (captured): ``execute=True`` permits
    an inert run first (only between steps, on the serving thread),
    ``execute=False`` captures without running it. It returns the
    capture's seconds, or None.

    ``expect_entries`` is the number of live entries this program may
    hold in the engine's inventory (``compiled_program_names``): one graph
    per bucket."""

    name: str
    warm: Callable[[bool], Optional[float]]
    priority: int = 1  # 0 = serve-critical: captured first, in the foreground
    expect_entries: int = 1


class ProgramRegistry:
    """Ordered, name-unique collection of ``ProgramSpec`` entries plus the
    run fingerprint they belong to."""

    def __init__(self, fingerprint: str = ""):
        self.fingerprint = fingerprint
        self._specs: Dict[str, ProgramSpec] = {}

    def add(self, spec: ProgramSpec) -> ProgramSpec:
        if spec.name in self._specs:
            raise ValueError(f"duplicate program spec {spec.name!r}")
        self._specs[spec.name] = spec
        return spec

    def __iter__(self) -> Iterator[ProgramSpec]:
        return iter(self._specs.values())

    def __len__(self) -> int:
        return len(self._specs)

    @property
    def names(self) -> List[str]:
        return list(self._specs)

    def predicts(self, name: str) -> bool:
        return name in self._specs

    # ---- the coverage guard ----

    def assert_covers(self, observed: Iterable[str]) -> None:
        """Fail if ``observed`` contains a program (or more live entries
        of one) that the registry did not predict.

        ``observed`` is the run's live program inventory, e.g.
        ``PagedEngine.compiled_program_names()``, with one element per
        live entry, so multiplicity is checked too: a program captured
        past its ``expect_entries`` budget is a coverage failure."""
        counts: Dict[str, int] = {}
        for name in observed:
            counts[name] = counts.get(name, 0) + 1
        unpredicted = sorted(n for n in counts if n not in self._specs)
        if unpredicted:
            raise CoverageError(
                f"compiled program(s) outside the registry: {unpredicted} "
                f"— the registry enumerated {sorted(self._specs)}; either "
                "the enumeration is missing a bucket/config variant or "
                "the run compiled something it was never meant to"
            )
        over = sorted(
            f"{n} ({c} entries > {self._specs[n].expect_entries} expected)"
            for n, c in counts.items()
            if c > self._specs[n].expect_entries
        )
        if over:
            raise CoverageError(
                f"program(s) retraced past their registry budget: {over} "
                "— shape/dtype drift compiled extra variants the registry "
                "did not predict"
            )


def run_fingerprint(device=None, extra: Iterable = ()) -> str:
    """Stable hex key for the environment a run's programs are valid in:
    the torch and CUDA versions, the device's type, name and compute
    capability (``device``: a ``torch.device``; None or a CPU device
    names the CPU), and the caller's extras (config reprs, flags)."""
    import torch

    parts = [f"torch={torch.__version__}", f"cuda={torch.version.cuda}"]
    if device is not None and torch.device(device).type == "cuda":
        major, minor = torch.cuda.get_device_capability(device)
        parts += ["backend=cuda", f"device_kind={torch.cuda.get_device_name(device)}",
                  f"capability={major}.{minor}"]
    else:
        parts.append("backend=cpu")
    for item in extra:
        parts.append(repr(item))
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def serving_registry(engine, extra: Iterable = ()) -> ProgramRegistry:
    """Every program a ``serving.PagedEngine`` can run: one chunk-prefill
    program per (padded job count, table-slice width) bucket, read from
    ``engine.chunk_buckets()`` so registry and engine cannot drift, the
    decode tick, the handoff's export and import per chain-length bucket
    under ``handoff`` (the fleet's disaggregated replicas), the
    copy-on-write block copy under ``prefix_cache`` and the swap pair per
    chain-length bucket under ``swap``.

    Priority: the decode tick and the smallest prefill bucket are 0
    (serve-critical: with them ready the scheduler can admit and stream
    its first request), everything else 1."""
    reg = ProgramRegistry(
        run_fingerprint(
            device=engine.device,
            extra=(
                engine.config,
                f"n_slots={engine.n_slots}",
                f"block_len={engine.block_len}",
                f"chunk={engine.chunk}",
                f"temperature={engine.temperature}",
                f"top_k={engine.top_k}",
                f"kv_dtype={engine.kv_dtype}",
                f"prefix_cache={engine.prefix_cache}",
                f"cuda_graphs={engine.cuda_graphs}",
                *extra,
            ),
        )
    )
    reg.add(ProgramSpec(
        name=engine.DECODE_PROGRAM,
        warm=lambda execute: engine.warm_decode(execute=execute),
        priority=0,
    ))
    buckets = engine.chunk_buckets()
    smallest = min(buckets) if buckets else None
    for k_pad, wp in buckets:
        reg.add(ProgramSpec(
            name=engine.chunk_program_name(k_pad, wp),
            warm=(lambda execute, k=k_pad, w=wp:
                  engine.warm_chunk(k, w, execute=execute)),
            priority=0 if (k_pad, wp) == smallest else 1,
        ))
    for n_pad in engine.handoff_buckets():
        reg.add(ProgramSpec(
            name=engine.export_program_name(n_pad),
            warm=(lambda execute, n=n_pad:
                  engine.warm_export(n, execute=execute)),
        ))
        reg.add(ProgramSpec(
            name=engine.import_program_name(n_pad),
            warm=(lambda execute, n=n_pad:
                  engine.warm_import(n, execute=execute)),
        ))
    if engine.prefix_cache:
        reg.add(ProgramSpec(
            name=engine.BLOCK_COPY_PROGRAM,
            warm=lambda execute: engine.warm_block_copy(execute=execute),
        ))
    for n_pad in engine.swap_buckets():
        reg.add(ProgramSpec(
            name=engine.swap_out_program_name(n_pad),
            warm=(lambda execute, n=n_pad:
                  engine.warm_swap_out(n, execute=execute)),
        ))
        reg.add(ProgramSpec(
            name=engine.swap_in_program_name(n_pad),
            warm=(lambda execute, n=n_pad:
                  engine.warm_swap_in(n, execute=execute)),
        ))
    return reg
