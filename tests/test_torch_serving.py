"""The port's serving path against the JAX package's.

The headline: ``Scheduler(device="cpu")`` greedy streams equal the JAX
``Scheduler(gather_impl="dense")``'s on the same weights and prompts, with
an ample pool and with an over-committed one (pool OOM queues requests),
and every block comes back after the drain. Around it: the allocator,
the block arithmetic, the pools, sampling and the engine's padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu.serving.kv_pool import BlockAllocator as JaxBlockAllocator
from pytorch_distributed_tpu.serving.kv_pool import blocks_needed as jax_blocks_needed
from pytorch_distributed_tpu_torch.models import init_params, params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.models.generate import _sample
from pytorch_distributed_tpu_torch.recipes import serve_lm
from pytorch_distributed_tpu_torch.serving import (
    TRASH_BLOCK,
    BlockAllocator,
    ChunkJob,
    PagedEngine,
    Scheduler,
    blocks_needed,
    init_paged_cache,
)

MAX_SEQ = 64
SERVE = dict(n_slots=3, block_len=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params))


def prompts(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=int(l)).astype(np.int32)
            for l in rng.integers(3, 25, size=n)]


def drain_all(sched, reqs, max_new=6):
    rids = [sched.submit(p, max_new) for p in reqs]
    out = sched.drain()
    return [out[r] for r in rids]


@pytest.mark.parametrize("n_blocks", [None, 8])
def test_greedy_streams_match_jax_scheduler(weights, n_blocks):
    """n_blocks=8 over-commits the pool (7 usable blocks; a request holds
    up to 4), so admission queues on OOM."""
    jcfg, jparams, state = weights
    reqs = prompts()
    want = drain_all(JaxScheduler(jcfg, jparams, n_blocks=n_blocks,
                                  gather_impl="dense", **SERVE), reqs)
    s = Scheduler(tiny_config(max_seq_len=MAX_SEQ), state, n_blocks=n_blocks,
                  device="cpu", **SERVE)
    got = drain_all(s, reqs)
    assert got == [[int(t) for t in w] for w in want]
    assert s.engine.allocator.in_use == 0
    assert (s.engine.tables == TRASH_BLOCK).all()
    m = s.metrics()
    assert m["completed"] == m["admitted"] == len(reqs)
    assert m["tokens_out"] == 6 * len(reqs)
    if n_blocks is not None:
        assert m["admission_latency_steps_mean"] > 0  # something queued


def test_kernel_and_dense_spellings_serve_the_same_streams(weights):
    _, _, state = weights
    cfg = tiny_config(max_seq_len=MAX_SEQ)
    streams = [drain_all(Scheduler(cfg, state, gather_impl=g, split_s=s,
                                   device="cpu", **SERVE), prompts(seed=1))
               for g, s in (("kernel", None), ("kernel", 2), ("dense", None))]
    assert streams[0] == streams[1] == streams[2]


def test_eos_retires_early_and_frees_blocks(weights):
    _, _, state = weights
    cfg = tiny_config(max_seq_len=MAX_SEQ)
    p = prompts(1)[0]
    first = drain_all(Scheduler(cfg, state, device="cpu", **SERVE), [p])[0]
    s = Scheduler(cfg, state, eos_id=first[1], device="cpu", **SERVE)
    assert drain_all(s, [p]) == [first[:2]]
    assert s.engine.allocator.in_use == 0


def test_scheduler_metrics_keys(weights):
    _, _, state = weights
    s = Scheduler(tiny_config(max_seq_len=MAX_SEQ), state, device="cpu", **SERVE)
    drain_all(s, prompts(4), max_new=3)
    m = s.metrics()
    for key in ("steps", "queue_depth", "occupancy", "occupancy_mean",
                "pool_blocks_in_use", "pool_frac_in_use", "padding_waste_frac",
                "admitted", "completed", "tokens_out", "tokens_per_s",
                "ttft_p50_s", "ttft_p95_s", "token_lat_p50_s", "queue_wait_p50_s",
                "tick_p95_s"):
        assert key in m, key
    assert m["ttft_count"] == 4 and m["token_lat_count"] == 4 * 2
    assert m["queue_depth"] == 0 and m["pool_blocks_in_use"] == 0


def test_submit_validation(weights):
    _, _, state = weights
    s = Scheduler(tiny_config(max_seq_len=MAX_SEQ), state, device="cpu", **SERVE)
    with pytest.raises(ValueError, match="at least one token"):
        s.submit(np.zeros(0, np.int32), 4)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        s.submit(np.ones(60, np.int32), 8)
    with pytest.raises(ValueError, match="padded"):
        s.submit(np.ones(MAX_SEQ + 1, np.int32), 1)
    with pytest.raises(ValueError, match="eos_id"):
        Scheduler(tiny_config(), state, 1, eos_id=10_000, device="cpu")


def test_run_chunks_pads_jobs_to_a_power_of_two(weights):
    """Three jobs run as four; the padding job's row is dropped, and only
    final chunks write logits rows."""
    _, _, state = weights
    eng = PagedEngine(tiny_config(max_seq_len=MAX_SEQ), state, device="cpu", **SERVE)
    for slot in range(3):
        assert eng.admit(slot, 8 if slot < 2 else 16, 4)
    jobs = [ChunkJob(slot, np.arange(1, 9, dtype=np.int32), 0, slot < 2, 7)
            for slot in range(3)]
    assert eng.bucket_for(jobs) == (4, 1)  # one 8-token block covers every chunk
    eng.run_chunks(jobs)
    assert eng.logits[:2].abs().sum(-1).gt(0).all()
    assert not eng.logits[2].any()  # not a final chunk
    eng.release_all()
    assert eng.allocator.in_use == 0


def test_decode_routes_inactive_lanes_to_trash(weights):
    _, _, state = weights
    eng = PagedEngine(tiny_config(max_seq_len=MAX_SEQ), state, device="cpu", **SERVE)
    assert eng.admit(0, 4, 4)
    before = [k.clone() for k, *_ in eng.cache]
    tokens, pos = eng.decode(np.array([4, 9, 9]), np.array([True, False, False]))
    assert tokens.shape == (3,) and list(pos) == [5, 9, 9]
    for k0, (k1, *_) in zip(before, eng.cache):
        changed = (k0 != k1).any(dim=(1, 2, 3)).nonzero().flatten().tolist()
        # lane 0 writes its own block at offset 4; dead lanes only the trash
        assert set(changed) <= {TRASH_BLOCK, int(eng.tables[0, 0])}
        assert (k0[int(eng.tables[0, 0]), 4] != k1[int(eng.tables[0, 0]), 4]).any()


def test_allocator_lifo_oom_and_refcounts():
    a = BlockAllocator(6)
    assert a.alloc(0, 2) == [1, 2]
    assert a.alloc(1, 3) == [3, 4, 5]
    assert a.alloc(2, 1) is None and a.available == 0  # OOM: unchanged
    a.free(0)
    assert a.in_use == 3 and a.alloc(2, 2) == [1, 2]  # most recent frees first
    a.incref(3)
    a.free(1)
    assert a.ref(3) == 1 and a.ref(4) == 0 and a.in_use == 3
    assert a.decref(3) and a.in_use == 2
    with pytest.raises(RuntimeError, match="double free"):
        a.decref(3)
    with pytest.raises(ValueError, match="already holds"):
        a.alloc(2, 1)
    with pytest.raises(ValueError, match="trash"):
        BlockAllocator(1)
    a.free(7)  # no chain: a no-op


def test_allocator_hands_out_the_jax_order():
    ours, ref = BlockAllocator(12), JaxBlockAllocator(12)
    script = [("alloc", 0, 3), ("alloc", 1, 2), ("free", 0), ("alloc", 2, 4),
              ("alloc", 3, 5), ("free", 2), ("free", 1), ("alloc", 0, 6)]
    for op in script:
        if op[0] == "alloc":
            assert ours.alloc(op[1], op[2]) == ref.alloc(op[1], op[2])
        else:
            ours.free(op[1])
            ref.free(op[1])
        assert ours.in_use == ref.in_use


def test_blocks_needed_matches_jax():
    for prompt in (1, 7, 8, 9, 31, 100):
        for new in (1, 5, 40):
            for bl in (4, 8, 16):
                for chunk in (8, 32):
                    assert (blocks_needed(prompt, new, bl, chunk)
                            == jax_blocks_needed(prompt, new, bl, chunk))


def test_init_paged_cache_layout():
    cfg = tiny_config(dtype=torch.bfloat16)
    cache = init_paged_cache(cfg, n_blocks=5, block_len=4)
    assert len(cache) == cfg.num_layers
    for k, v, k_scale, v_scale in cache:
        assert k.shape == v.shape == (5, 4, cfg.num_heads, cfg.head_dim)
        assert k.dtype == torch.bfloat16 and not k.any()
        assert k_scale is None and v_scale is None
    # quantized pools: 1-byte values, scales [n_blocks, block_len, H_kv]
    # (fp32 multipliers for int8, int8 exponents for fp8)
    for kv, pool_dt, sc_dt in (("int8", torch.int8, torch.float32),
                               ("fp8", torch.float8_e4m3fn, torch.int8),
                               ("fp8_e5m2", torch.float8_e5m2, torch.int8)):
        for layer in init_paged_cache(cfg, 5, 4, kv_dtype=kv):
            assert layer.key.dtype == layer.value.dtype == pool_dt
            assert layer.key.shape == (5, 4, cfg.num_heads, cfg.head_dim)
            assert layer.key_scale.dtype == layer.value_scale.dtype == sc_dt
            assert layer.key_scale.shape == (5, 4, cfg.num_heads)
    with pytest.raises(ValueError, match="kv_dtype"):
        init_paged_cache(cfg, 5, 4, kv_dtype="int4")


def test_sample_greedy_and_top_k():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, -1.0, 2.0, 5.0]])
    assert _sample(logits, 0.0, None).tolist() == [1, 0]  # first maximum
    assert _sample(logits, 0.0, None).dtype == torch.int32
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([_sample(logits, 1.0, 2, g) for _ in range(200)])
    assert set(draws[:, 0].tolist()) <= {1, 2}
    assert set(draws[:, 1].tolist()) <= {0, 3}
    again = torch.stack([_sample(logits, 1.0, 2, torch.Generator().manual_seed(0))
                         for _ in range(1)])
    assert torch.equal(again[0], draws[0])


def test_sampled_serving_is_seeded(weights):
    _, _, state = weights
    cfg = tiny_config(max_seq_len=MAX_SEQ)
    runs = [drain_all(Scheduler(cfg, state, temperature=1.0, top_k=8, seed=s,
                                device="cpu", **SERVE), prompts(3))
            for s in (5, 5, 6)]
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_recipe_serves_on_cpu(capsys):
    m = serve_lm.main(["--device", "cpu", "--tiny", "--requests", "3",
                       "--max-new", "3", "--slots", "2"])
    assert m["completed"] == 3 and m["tokens_out"] == 9
    assert m["device"] == "cpu" and m["pool_blocks_in_use"] == 0
    assert '"completed": 3' in capsys.readouterr().out
    # random weights come from the numpy seed
    cfg = serve_lm.full_config()
    assert (cfg.vocab_size, cfg.num_layers, cfg.embed_dim, cfg.max_seq_len) == (
        32000, 12, 768, 2048)
    assert init_params(tiny_config(), 0)["lm_head"]["kernel"].shape == (32, 128)
