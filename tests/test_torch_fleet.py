"""The port's serving fleet against the JAX package's
(``pytorch_distributed_tpu/fleet/router.py``, the handoff half of
``serving/engine.py`` and ``scheduler.py``; cf. ``tests/test_fleet.py``).

The same seeded trace through both packages' ``FleetRouter`` (2 replicas;
the synchronous loop, the lagged one and the disaggregated fleet) gives
the same tokens for every rid, the same placement and the same admit,
spill, shed and handoff counts. The JAX replicas run their dense gather
with the anomaly sentinel off (the port has none: a compile-length tick
would make it spill on the wall clock). Around it: session affinity and
its LRU cap, a graceful drain, the handoff's export and import (exact in
every pool dtype, a clean refusal on a full pool, the chain freed when an
import fails after its allocation), ``handoff=False`` refusing, and the
registry's coverage across replicas with the handoff programs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.compilecache import serving_registry as jax_registry
from pytorch_distributed_tpu.fleet import FleetRouter as JaxRouter
from pytorch_distributed_tpu.fleet import SLOConfig as JaxSLO
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.serving import PagedEngine as JaxEngine
from pytorch_distributed_tpu.serving.engine import ChunkJob as JaxChunkJob
from pytorch_distributed_tpu_torch.compilecache import CoverageError, serving_registry
from pytorch_distributed_tpu_torch.fleet import (
    FleetRouter,
    SLOConfig,
    clamp_trace,
    generate_trace,
    prompt_for,
    replay_trace,
)
from pytorch_distributed_tpu_torch.models import params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.serving import ChunkJob, PagedEngine, Scheduler

MAX_SEQ = 64
SERVE = dict(n_slots=3, block_len=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def weights():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    yield jcfg, params, params_from_jax(jax.tree.map(np.asarray, params))
    torch.set_num_threads(threads)


def port(weights, **kw):
    return FleetRouter(tiny_config(max_seq_len=MAX_SEQ), weights[2], device="cpu",
                       **{**SERVE, **kw})


def reference(weights, **kw):
    slo = kw.pop("slo", None)
    return JaxRouter(weights[0], weights[1], gather_impl="dense", anomaly_threshold=0,
                     slo=None if slo is None else JaxSLO(**slo), **{**SERVE, **kw})


TRACE = clamp_trace(generate_trace(seed=1, duration_s=6.0, base_rate=3.0, sessions=4,
                                   prompt_median=12, max_new_median=4), MAX_SEQ, 8)


def replayed(router):
    streams = {}

    def tick():
        for rid, tok in router.step():
            streams.setdefault(rid, []).append(int(tok))

    replay_trace(TRACE, lambda r: router.submit(prompt_for(r, 128), r.max_new,
                                                session=r.session),
                 tick, lambda: router.idle, tick_s=0.5)
    m = router.metrics()
    return streams, dict(router.placement), dict(router.rejected), {
        k: m[k] for k in ("submitted", "shed", "spilled", "handoffs", "completed",
                          "preempt_routes")}


@pytest.mark.parametrize("mode", [dict(), dict(async_host=True),
                                  dict(disaggregate=True, decode_slots=4,
                                       handoffs_per_tick=1)],
                         ids=["sync", "async_host", "disaggregated"])
def test_trace_through_both_fleets_makes_the_same_decisions(weights, mode):
    slo = dict(spill_queue_depth=1, shed_queue_depth=3)
    got = replayed(port(weights, n_replicas=2, slo=SLOConfig(**slo), **mode))
    want = replayed(reference(weights, n_replicas=2, slo=slo, **mode))
    assert got[3] == want[3]
    assert got[3]["shed"] and (got[3]["spilled"] or got[3]["handoffs"])
    if mode.get("disaggregate"):
        assert got[3]["handoffs"] == got[3]["completed"] > 0
    assert got[2] == want[2] and got[1] == want[1]
    assert got[0] == want[0]


def test_session_affinity_and_its_lru_cap(weights):
    r = port(weights, n_replicas=2, affinity_cap=2)
    prompt = np.arange(1, 10, dtype=np.int32)
    rids = []
    for _ in range(3):
        rids.append(r.submit(prompt, 2, session=7))
        r.drain()
    home = r.placement[rids[0]]
    assert all(r.placement[rid] == home for rid in rids)
    assert dict(r._affinity) == {7: home}
    for sess in (8, 9, 10):
        r.submit(prompt, 2, session=sess)
    r.drain()
    m = r.metrics()
    assert list(r._affinity) == [9, 10] and m["affinity_evictions"] == 2
    assert m["affinity_sessions"] == 2
    # the spill: no tick between submits, session 5's home queues past the bound
    r = port(weights, n_replicas=2, slo=SLOConfig(spill_queue_depth=2, shed_queue_depth=64))
    rids = [r.submit(prompt, 2, session=5) for _ in range(6)]
    home = r.placement[rids[0]]
    placements = [r.placement[rid] for rid in rids]
    assert placements.count(home) >= 2 and 1 - home in placements
    assert r.metrics()["spilled"] > 0 and r._affinity[5] == home
    assert len(r.drain()) == 6 and not r.rejected
    with pytest.raises(ValueError, match="affinity_cap"):
        port(weights, affinity_cap=0)


def test_graceful_drain_leaves_zero_blocks(weights):
    s = Scheduler(tiny_config(max_seq_len=MAX_SEQ), weights[2], device="cpu", **SERVE)
    prompt = np.arange(1, 20, dtype=np.int32)
    rids = [s.submit(prompt, 3) for _ in range(6)]
    for _ in range(2):
        s.step()
    in_flight = {r.rid for r in s.resident.values()}
    assert in_flight and s.queue
    produced, requeued = s.drain_graceful()
    assert set(produced) == in_flight
    assert {r.rid for r in requeued} == set(rids) - in_flight
    assert s.engine.allocator.in_use == 0 and s.draining
    with pytest.raises(RuntimeError, match="draining"):
        s.submit(prompt, 2)
    # a prefill-only replica's drain ends with its requests parked for handoff
    p = Scheduler(tiny_config(max_seq_len=MAX_SEQ), weights[2], device="cpu",
                  prefill_only=True, **SERVE)
    ready = [p.submit(prompt, 3) for _ in range(2)]
    p.step()
    _, requeued = p.drain_graceful()
    assert not requeued and p.ready_rids() == ready
    assert p.stuck_rids() == {"handoff-ready": ready}
    assert p.engine.allocator.in_use > 0 and p.metrics()["ready"] == 2


def _prefilled(engine, prompt, slot, job):
    assert engine.admit(slot, len(prompt), 3)
    tokens = np.zeros((16,), np.int32)
    tokens[:len(prompt)] = prompt
    engine.run_chunks([job(slot=slot, tokens=tokens, start=0, is_last=True,
                           last_idx=len(prompt) - 1)])


@pytest.mark.parametrize("kv", [None, "int8", "fp8", "fp8_e5m2"])
def test_handoff_export_import_is_exact(weights, kv):
    cfg = tiny_config(max_seq_len=MAX_SEQ)
    kw = dict(block_len=8, prefill_chunk=16, handoff=True, kv_dtype=kv, device="cpu")
    src = PagedEngine(cfg, weights[2], 2, **kw)
    dst = PagedEngine(cfg, weights[2], 3, **kw)
    prompt = np.arange(1, 14, dtype=np.int32)
    _prefilled(src, prompt, 0, ChunkJob)
    export = src.export_chain(0)
    assert export.n_blocks == len(src.allocator.chain(0))
    if kv is None:  # the exported logits row against the JAX engine's
        jsrc = JaxEngine(weights[0], weights[1], 2, block_len=8, prefill_chunk=16,
                         handoff=True, gather_impl="dense")
        _prefilled(jsrc, prompt, 0, JaxChunkJob)
        np.testing.assert_allclose(export.logits_row.numpy(),
                                   np.asarray(jsrc.export_chain(0).logits_row), atol=1e-5)
    assert dst.admit(0, 8, 2)  # the imported chain lands on other block ids
    assert dst.import_chain(1, export)
    s_idx = torch.tensor(src.allocator.chain(0))
    d_idx = torch.tensor(dst.allocator.chain(1))
    assert s_idx.tolist() != d_idx.tolist()
    for s_layer, d_layer in zip(src.cache, dst.cache):
        for s_t, d_t in zip(s_layer, d_layer):
            if s_t is not None:
                assert torch.equal(s_t[s_idx].view(torch.uint8), d_t[d_idx].view(torch.uint8))
    assert torch.equal(src.logits[0], dst.logits[1])
    assert list(dst.tables[1, :len(d_idx)]) == d_idx.tolist()
    assert dst.compiled_program_names()[-1:] == ["kv_import[n=2]"]
    # a full pool: False, nothing changed
    small = PagedEngine(cfg, weights[2], 1, n_blocks=2, **kw)
    assert not small.import_chain(0, export)
    assert small.allocator.in_use == 0


def test_failed_import_frees_its_chain_and_the_export_stays_valid(weights, monkeypatch):
    cfg = tiny_config(max_seq_len=MAX_SEQ)
    kw = dict(block_len=8, prefill_chunk=16, handoff=True, device="cpu")
    src, dst = PagedEngine(cfg, weights[2], 2, **kw), PagedEngine(cfg, weights[2], 2, **kw)
    _prefilled(src, np.arange(1, 14, dtype=np.int32), 0, ChunkJob)
    export = src.export_chain(0)

    def broken(ids):
        raise OSError("the copy failed")

    monkeypatch.setattr(dst, "_index", broken)
    with pytest.raises(OSError, match="copy failed"):
        dst.import_chain(0, export)
    assert dst.allocator.in_use == 0 and (dst.tables[0] == 0).all()
    monkeypatch.undo()
    assert dst.import_chain(0, export)
    assert torch.equal(dst.logits[0], src.logits[0])
    with pytest.raises(ValueError, match="block_len"):
        PagedEngine(cfg, weights[2], 2, block_len=4, prefill_chunk=16, handoff=True,
                    device="cpu").import_chain(0, export)
    with pytest.raises(ValueError, match="layout"):
        PagedEngine(cfg, weights[2], 2, kv_dtype="fp8", **kw).import_chain(0, export)


def test_handoff_needs_the_flag(weights):
    cfg = tiny_config(max_seq_len=MAX_SEQ)
    eng = PagedEngine(cfg, weights[2], 2, block_len=8, prefill_chunk=16, device="cpu")
    eng.admit(0, 9, 2)
    with pytest.raises(RuntimeError, match="handoff=True"):
        eng.export_chain(0)
    with pytest.raises(RuntimeError, match="handoff=True"):
        eng.warm_import(1)
    assert eng.handoff_buckets() == []
    prefill = Scheduler(cfg, weights[2], device="cpu", prefill_only=True, **SERVE)
    assert prefill.engine.handoff
    with pytest.raises(RuntimeError, match="cannot adopt"):
        prefill.adopt(None, None)


def test_fleet_registry_covers_every_replica_with_the_handoff_programs(weights):
    r = port(weights, n_replicas=2, disaggregate=True)
    prompt = np.arange(1, 20, dtype=np.int32)
    for _ in range(3):
        r.submit(prompt, 3, session=2)
    r.drain()
    names = [n for s in r.replicas for n in s.engine.compiled_program_names()]
    assert any(n.startswith("kv_export") for n in names)
    assert any(n.startswith("kv_import") for n in names)
    r.assert_registry_covers()
    with pytest.raises(CoverageError, match="rogue"):
        r.registries()[0].assert_covers(["rogue"])
    assert all(s.engine.allocator.in_use == 0 for s in r.replicas)
    assert r.replicas[1].engine.model is r.replicas[0].engine.model  # one copy of the weights
    # the handoff programs at the JAX names and priorities
    eng = r.replicas[0].engine
    jeng = JaxEngine(weights[0], weights[1], eng.n_slots, block_len=8, prefill_chunk=8,
                     handoff=True, gather_impl="dense")
    assert [(p.name, p.priority) for p in serving_registry(eng)] == [
        (p.name, p.priority) for p in jax_registry(jeng)]
    # a warmup runs each handoff program once: coverage holds before traffic
    w = port(weights, n_replicas=2, disaggregate=True)
    w.warmup()
    names = w.replicas[1].engine.compiled_program_names()
    assert {f"kv_export[n={n}]" for n in eng.handoff_buckets()} <= set(names)
    assert {f"kv_import[n={n}]" for n in eng.handoff_buckets()} <= set(names)
    w.assert_registry_covers()
