"""The port's program registry and warmup against the JAX package's.

The headline: ``serving_registry`` of the port names the same programs at
the same priorities as the JAX function for the same engine geometry, its
coverage guard raises and passes on the same inventories, and a warmed-up
port ``Scheduler`` serves with no cold request and the guard closed over
the run, its greedy streams equal to the JAX ``Scheduler``'s. Around it:
the warmup runner's order, records and background contract, the inert
warm runs (pools and live logits bit-equal), the sampler's draws and the
launch-counter bookkeeping that CUDA graph replays lean on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.compilecache import ProgramRegistry as JaxProgramRegistry
from pytorch_distributed_tpu.compilecache import ProgramSpec as JaxProgramSpec
from pytorch_distributed_tpu.compilecache import WarmupRunner as JaxWarmupRunner
from pytorch_distributed_tpu.compilecache import serving_registry as jax_serving_registry
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.serving import PagedEngine as JaxPagedEngine
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu_torch.compilecache import (
    CoverageError,
    ProgramRegistry,
    ProgramSpec,
    WarmupRunner,
    run_fingerprint,
    serving_registry,
)
from pytorch_distributed_tpu_torch.models import params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.models.generate import _sample
from pytorch_distributed_tpu_torch.ops import paged_flash
from pytorch_distributed_tpu_torch.recipes import serve_lm
from pytorch_distributed_tpu_torch.serving import TRASH_BLOCK, ChunkJob, PagedEngine, Scheduler

GEOM = dict(block_len=16, prefill_chunk=32)


@pytest.fixture(scope="module")
def lms():
    """JAX params and the port's state dict, per max_seq_len."""
    out = {}
    for max_seq in (96, 128):
        jcfg = jax_tiny_config(attention="dense", max_seq_len=max_seq)
        params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
        out[max_seq] = (jcfg, params, params_from_jax(jax.tree.map(np.asarray, params)))
    return out


def prompts(n=5, seed=0, lo=3, hi=70):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=int(l)).astype(np.int32)
            for l in rng.integers(lo, hi, size=n)]


def drain_all(sched, reqs, max_new=5):
    rids = [sched.submit(p, max_new) for p in reqs]
    out = sched.drain()
    return [[int(t) for t in out[r]] for r in rids]


def port_engine(lms, max_seq, n_slots=3, **kw):
    _, _, state = lms[max_seq]
    return PagedEngine(tiny_config(max_seq_len=max_seq), state, n_slots, device="cpu",
                       **GEOM, **kw)


# ---------------------------------------------------------------------------
# the registry against the JAX function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("max_seq", [96, 128])
@pytest.mark.parametrize("n_slots", [1, 3, 8])
def test_serving_registry_names_and_priorities_match_jax(lms, n_slots, max_seq,
                                                         prefix_cache, swap):
    jcfg, params, _ = lms[max_seq]
    ref = jax_serving_registry(JaxPagedEngine(jcfg, params, n_slots, swap=swap,
                                              prefix_cache=prefix_cache, **GEOM))
    got = serving_registry(port_engine(lms, max_seq, n_slots, swap=swap,
                                       prefix_cache=prefix_cache))
    assert [(s.name, s.priority) for s in got] == [(s.name, s.priority) for s in ref]
    assert [s.expect_entries for s in got] == [s.expect_entries for s in ref]
    assert len(got.fingerprint) == 16 and int(got.fingerprint, 16) >= 0


@pytest.mark.parametrize("n_slots", [1, 3, 8])
def test_every_bucket_a_job_mix_can_take_is_enumerated(lms, n_slots):
    """Job counts 1..n_slots at every admissible chunk start: each bucket
    is JAX's and is in ``chunk_buckets()`` and the registry."""
    jcfg, params, _ = lms[128]
    ref = JaxPagedEngine(jcfg, params, n_slots, **GEOM)
    eng = port_engine(lms, 128, n_slots)
    reg = serving_registry(eng)
    assert eng.chunk_buckets() == ref.chunk_buckets()
    for k in range(1, n_slots + 1):
        for start in range(0, 128 - eng.chunk + 1, eng.chunk):
            jobs = [ChunkJob(0, np.zeros(eng.chunk, np.int32), start, True, 0)] * k
            bucket = eng.bucket_for(jobs)
            assert bucket == ref.bucket_for(jobs)
            assert bucket in eng.chunk_buckets()
            assert reg.predicts(eng.chunk_program_name(*bucket))
    assert eng.handoff_buckets() == [] == ref.handoff_buckets()


def test_swap_buckets_follow_the_swap_flag(lms):
    jcfg, params, _ = lms[96]
    for swap in (False, True):
        ref = JaxPagedEngine(jcfg, params, 2, swap=swap, **GEOM)
        assert port_engine(lms, 96, 2, swap=swap).swap_buckets() == ref.swap_buckets()
    with pytest.raises(RuntimeError, match="swap=True"):
        port_engine(lms, 96, 2).warm_swap_out(1)


def _guard_outcome(registry_cls, spec_cls, observed):
    reg = registry_cls()
    reg.add(spec_cls("step", warm=lambda e: None, expect_entries=2))
    reg.add(spec_cls("tick", warm=lambda e: None))
    try:
        reg.assert_covers(observed)
    except AssertionError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("observed", [
    [], ["step"], ["step", "step"], ["tick", "step"], ["step", "rogue"], ["step"] * 3,
    ["tick", "tick"], ["rogue", "tick", "tick"],
])
def test_coverage_guard_matches_jax(observed):
    """Unpredicted programs and programs past their budget raise, with
    JAX's message; fewer live programs than predicted pass."""
    assert (_guard_outcome(ProgramRegistry, ProgramSpec, observed)
            == _guard_outcome(JaxProgramRegistry, JaxProgramSpec, observed))
    assert issubclass(CoverageError, AssertionError)


def test_registry_rejects_duplicates_and_reports_names():
    reg = ProgramRegistry("fp")
    reg.add(ProgramSpec("a", warm=lambda e: None))
    with pytest.raises(ValueError, match="duplicate"):
        reg.add(ProgramSpec("a", warm=lambda e: None))
    reg.add(ProgramSpec("b", warm=lambda e: None, priority=0))
    assert reg.names == ["a", "b"] and len(reg) == 2
    assert reg.predicts("a") and not reg.predicts("c")
    with pytest.raises(CoverageError, match="outside the registry"):
        reg.assert_covers(["c"])


def test_run_fingerprint_stable_and_sensitive():
    a = run_fingerprint(extra=("cfg_a",))
    assert a == run_fingerprint(extra=("cfg_a",))
    assert a != run_fingerprint(extra=("cfg_b",)) and a != run_fingerprint()
    assert a == run_fingerprint(device=torch.device("cpu"), extra=("cfg_a",))


# ---------------------------------------------------------------------------
# the warmup runner
# ---------------------------------------------------------------------------


def test_runner_priority_order_records_and_summary_keys():
    order = []
    reg = ProgramRegistry("fp123")
    reg.add(ProgramSpec("late", warm=lambda e: order.append(("late", e)), priority=1))
    reg.add(ProgramSpec("first", warm=lambda e: order.append(("first", e)) or 0.25,
                        priority=0))
    runner = WarmupRunner(reg).run(background=False)
    assert order == [("first", True), ("late", True)]  # foreground warms run inert
    s = runner.summary()
    jreg = JaxProgramRegistry("fp123")
    jreg.add(JaxProgramSpec("only", warm=lambda e: None, priority=0))
    assert set(s) == set(JaxWarmupRunner(jreg).run(background=False).summary())
    assert s["programs"] == 2 and s["fingerprint"] == "fp123" and s["fresh"] == 2
    assert s["cache_hits"] == 0
    rec = {r["program"]: r for r in runner.records}
    assert set(rec["first"]) == {"program", "seconds", "backend_compile_s", "cache_hit",
                                 "fingerprint", "priority", "background"}
    assert rec["first"]["backend_compile_s"] == min(0.25, rec["first"]["seconds"])
    assert rec["late"]["backend_compile_s"] == 0.0
    with pytest.raises(NotImplementedError, match="manifest"):
        WarmupRunner(reg, manifest=object())


def test_runner_background_defers_to_wait_on_the_calling_thread():
    """``background=True``: priority 0 warms (executed) before ``run``
    returns; the rest waits for ``wait()`` (captured without the inert
    run) and is recorded as background; ``wait(timeout=0)`` starts
    nothing."""
    events = []
    reg = ProgramRegistry()
    reg.add(ProgramSpec("fg", warm=lambda e: events.append(("fg", e)), priority=0))
    reg.add(ProgramSpec("bg1", warm=lambda e: events.append(("bg1", e))))
    reg.add(ProgramSpec("bg2", warm=lambda e: events.append(("bg2", e))))
    runner = WarmupRunner(reg).run(background=True)
    assert events == [("fg", True)] and len(runner.records) == 1
    runner.wait(timeout=0)
    assert len(runner.records) == 1
    runner.wait()
    assert events == [("fg", True), ("bg1", False), ("bg2", False)]
    runner.wait()
    assert len(runner.records) == 3
    recs = {r["program"]: r for r in runner.records}
    assert recs["fg"]["background"] is False
    assert recs["bg1"]["background"] is True and recs["bg2"]["background"] is True


def test_scheduler_background_warmup_leaves_serve_critical_hot(lms):
    _, _, state = lms[96]
    s = Scheduler(tiny_config(max_seq_len=96), state, 2, device="cpu", **GEOM)
    runner = s.warmup(background=True)
    reg = serving_registry(s.engine)
    assert s.engine.has_decode_program
    assert [r["program"] for r in runner.records] == [
        n for n in reg.names if dict((x.name, x.priority) for x in reg)[n] == 0]
    assert not s.engine.has_chunk_program(1, 2)
    runner.wait()
    assert {r["program"] for r in runner.records} == set(reg.names)
    assert all(r["priority"] > 0 for r in runner.records if r["background"])
    # every bucket a job can reach is ready; (k, 1) is narrower than a chunk
    assert all(s.engine.has_chunk_program(k, w) == (w > 1) for k, w in s.engine.chunk_buckets())
    reg.assert_covers(s.engine.compiled_program_names())


# ---------------------------------------------------------------------------
# warmup, cold requests and streams
# ---------------------------------------------------------------------------


def test_warmed_scheduler_has_no_cold_request_and_the_guard_closes(lms):
    _, _, state = lms[96]
    cfg = tiny_config(max_seq_len=96)
    s = Scheduler(cfg, state, 2, device="cpu", offload=True, prefix_cache=True, **GEOM)
    runner = s.warmup(background=False)
    reg = serving_registry(s.engine)
    assert runner.summary()["programs"] == len(reg)
    assert not any(r["background"] for r in runner.records)
    drain_all(s, prompts(4, lo=3, hi=60))
    m = s.metrics()
    assert m["cold_requests"] == 0 and m["ttft_warm_count"] == m["ttft_count"] == 4
    assert m["compile_s"] == 0.0 and m["graphs"] == 0 and m["cuda_graphs"] is False
    names = s.engine.compiled_program_names()
    assert s.engine.DECODE_PROGRAM in names and "kv_block_copy" in names
    reg.assert_covers(names)


def test_unwarmed_first_requests_are_cold(lms):
    """The first requests ride their buckets' and the tick's first runs:
    cold, kept out of the warm TTFT; later requests on warm programs are
    not."""
    _, _, state = lms[96]
    s = Scheduler(tiny_config(max_seq_len=96), state, 2, device="cpu", **GEOM)
    reqs = prompts(2, lo=5, hi=20)
    drain_all(s, reqs)
    cold = s.metrics()["cold_requests"]
    assert cold >= 1
    drain_all(s, reqs)  # the same buckets again: warm
    m = s.metrics()
    assert m["cold_requests"] == cold
    assert m["ttft_warm_count"] == m["ttft_count"] - cold == 4 - cold
    serving_registry(s.engine).assert_covers(s.engine.compiled_program_names())


@pytest.mark.parametrize("kw", [dict(), dict(kv_dtype="fp8"),
                                dict(temperature=0.9, top_k=20, seed=3)])
def test_streams_after_an_inert_warmup_equal_streams_without(lms, kw):
    """The inert runs change nothing a stream sees: greedy and fp8 streams
    are bit-equal, and a sampled serve draws the same tokens (the inert
    decode puts the generator's state back)."""
    _, _, state = lms[128]
    cfg = tiny_config(max_seq_len=128)
    reqs = prompts(5, seed=1, lo=3, hi=90)
    plain = drain_all(Scheduler(cfg, state, 3, device="cpu", **GEOM, **kw), reqs)
    s = Scheduler(cfg, state, 3, device="cpu", **GEOM, **kw)
    s.warmup(background=False)
    assert drain_all(s, reqs) == plain


def _live_state(eng, reqs):
    """Admit and prefill ``reqs`` into slots 0.., leaving logits rows and
    blocks live."""
    c = eng.chunk
    for slot, p in enumerate(reqs):
        assert eng.admit(slot, len(p), 4)
    jobs = []
    for slot, p in enumerate(reqs):
        toks = np.zeros(c, np.int32)
        toks[:min(c, len(p))] = p[:c]
        jobs.append(ChunkJob(slot, toks, 0, len(p) <= c, min(c, len(p)) - 1))
    eng.run_chunks(jobs)


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
def test_every_warm_run_leaves_pools_and_live_logits_bit_equal(lms, kv_dtype):
    eng = port_engine(lms, 96, 3, kv_dtype=kv_dtype, swap=True, prefix_cache=True)
    _live_state(eng, prompts(2, seed=4, lo=5, hi=30))
    live = [b for b in range(eng.allocator.n_blocks) if b != TRASH_BLOCK]
    before = [[t[live].clone() for t in layer if t is not None] for layer in eng.cache]
    logits = eng.logits.clone()
    reg = serving_registry(eng)
    for spec in reg:
        spec.warm(True)
        after = [[t[live] for t in layer if t is not None] for layer in eng.cache]
        for b_layer, a_layer in zip(before, after):
            for b, a in zip(b_layer, a_layer):
                assert torch.equal(b, a), spec.name
        assert torch.equal(eng.logits, logits), spec.name
    reg.assert_covers(eng.compiled_program_names())
    assert len(eng.compiled_program_names()) == len(reg) - 3  # the w=1 buckets


def test_warmed_serve_matches_the_jax_scheduler(lms):
    """The static-buffer programs against JAX ``Scheduler(gather_impl=
    "dense")``: three slots (padding jobs: 3 jobs run as 4), inactive
    lanes, prompts over several chunks, a background warmup finished by
    ``wait()`` between steps."""
    jcfg, jparams, state = lms[128]
    reqs = prompts(6, seed=2, lo=3, hi=90)
    want = drain_all(JaxScheduler(jcfg, jparams, 3, gather_impl="dense", **GEOM), reqs)
    s = Scheduler(tiny_config(max_seq_len=128), state, 3, device="cpu", **GEOM)
    runner = s.warmup(background=True)
    rids = [s.submit(p, 5) for p in reqs]
    got = {}
    while not s.idle:
        for rid, tok in s.step():
            got.setdefault(rid, []).append(tok)
        runner.wait(timeout=0.01)
    assert [got[r] for r in rids] == want
    serving_registry(s.engine).assert_covers(s.engine.compiled_program_names())


def test_recipe_warmup_serves_warm(capsys):
    m = serve_lm.main(["--device", "cpu", "--tiny", "--requests", "3", "--max-new", "3",
                       "--slots", "2", "--warmup"])
    assert m["completed"] == 3 and m["cold_requests"] == 0
    assert "warmup:" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# what the graphs lean on: the sampler, the counters, the split's scratch
# ---------------------------------------------------------------------------


def test_sampler_draws_as_torch_multinomial():
    """The sampler writes out multinomial's one-sample draw: the same
    tokens from the same generator state, and the generator advanced
    alike."""
    logits = torch.randn(6, 300, generator=torch.Generator().manual_seed(0)) * 3
    for temperature, top_k in ((1.0, None), (0.8, 50), (0.5, 1)):
        ours_g, theirs_g = (torch.Generator().manual_seed(9) for _ in range(2))
        z = logits / temperature
        if top_k is not None:
            kth = torch.sort(z, dim=-1).values[:, -top_k][:, None]
            z = z.masked_fill(z < kth, float("-inf"))
        probs = torch.softmax(z, dim=-1)
        for _ in range(5):
            ours = _sample(logits, temperature, top_k, ours_g)
            theirs = torch.multinomial(probs, 1, generator=theirs_g)[:, 0]
            assert torch.equal(ours.long(), theirs)
        assert torch.equal(ours_g.get_state(), theirs_g.get_state())


def test_launch_counter_snapshots_add_and_restore():
    paged_flash.reset_launch_counts()
    snap = paged_flash.launch_snapshot()
    paged_flash.launch_counts[paged_flash.SPLIT] += 3
    key = paged_flash.append_key(paged_flash.SWEEP, torch.float8_e4m3fn)
    paged_flash.route_launch_counts[key] += 2
    delta = paged_flash.launches_since(snap)
    assert delta == ({paged_flash.SPLIT: 3}, {}, {key: 2})
    paged_flash.restore_launches(snap)
    assert paged_flash.launches_since(snap) == ({}, {}, {})
    for _ in range(2):  # two replays
        paged_flash.add_launches(delta)
    assert paged_flash.launch_counts[paged_flash.SPLIT] == 6
    assert paged_flash.route_launch_counts[key] == 4
    paged_flash.reset_launch_counts()


def test_split_scratch_reserved_for_every_bucket_is_not_grown(monkeypatch):
    """``reserve_split_buffers`` sizes the split's scratch for every call a
    capture will make, so the launches inside it find it large enough."""
    class Lib:
        @staticmethod
        def pdt_paged_attention_rows_per_tile():
            return 8

    monkeypatch.setattr(paged_flash, "_library", lambda: Lib)
    monkeypatch.setattr(paged_flash, "_split_scratch", {})
    pool = torch.zeros(20, 16, 2, 64, dtype=torch.bfloat16)
    calls = [(8, 1, 4, 128, None), (4, 32, 4, 64, None), (1, 32, 4, 2, None),
             (2, 32, 4, 16, 3)]
    paged_flash.reserve_split_buffers(7, "cpu", torch.bfloat16, pool, calls)
    bufs = dict(paged_flash._split_scratch[("cpu", 7)])
    kernel = paged_flash.sweep_kernel(torch.bfloat16, pool.dtype, 64, 16)
    assert kernel == paged_flash.TENSOR_CORES
    for b, c, h, w, split_s in calls:
        s = paged_flash.split_workers(w, b, split_s)
        if s > 1:
            rows = (h // 2) * c
            paged_flash.split_buffers(("cpu", 7), b, 2, s, rows, 64,
                                      paged_flash.split_row_tiles(kernel, rows, 8), "cpu")
    assert all(paged_flash._split_scratch[("cpu", 7)][k] is v for k, v in bufs.items())
    assert paged_flash.split_workers(128, 8, None) == 8
    assert paged_flash.split_workers(2, 1, None) == 1 and paged_flash.split_workers(2, 2, 4) == 2
