"""The port's prefix sharing against the JAX package's.

The allocator's refcounts and ``alloc_mixed``, ``blocks_needed_suffix``
and the radix ``PrefixIndex`` follow the JAX ones op for op. On the
tiny fp32 model the port's ``Scheduler(prefix_cache=True)`` streams the
JAX scheduler's tokens and its own prefix-off tokens, with the same
accounting: hits, copy-on-write of a block-aligned duplicate (int8 pools
copy their scales too), the covered cap near ``max_seq_len``, and
eviction of index-only blocks under pool pressure (the JAX tests at
``tests/test_prefix.py:181``, ``:210``, ``:228``, ``:248``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.serving import BlockAllocator as JaxBlockAllocator
from pytorch_distributed_tpu.serving import PrefixIndex as JaxPrefixIndex
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu.serving import blocks_needed_suffix as jax_blocks_needed_suffix
from pytorch_distributed_tpu_torch.models import params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.serving import (
    BlockAllocator,
    PagedEngine,
    PrefixIndex,
    Scheduler,
    blocks_needed_suffix,
)

# ---------------------------------------------------------------------------
# allocator refcounts and the radix index (host logic)
# ---------------------------------------------------------------------------


def test_allocator_alloc_mixed_shares_and_pins():
    a = BlockAllocator(10)
    donor = a.alloc(0, 3)
    a.incref(donor[0])
    a.incref(donor[1])  # the index's references
    a.free(0)  # the donor retires; two blocks survive as index-only
    mixed = a.alloc_mixed(1, donor[:2], 2)
    assert mixed[:2] == donor[:2]
    assert a.ref(donor[0]) == 2 and a.shared_blocks == 2
    assert a.fresh_allocated == 5 and a.shared_reused == 2
    a.free(1)  # shared blocks survive (index ref), fresh ones do not
    assert a.ref(donor[0]) == 1 and a.ref(mixed[2]) == 0
    with pytest.raises(ValueError, match="cannot share"):
        a.alloc_mixed(2, [mixed[2]], 1)
    before = a.ref(donor[0])
    assert a.alloc_mixed(2, donor[:1], 99) is None  # all or nothing
    assert a.ref(donor[0]) == before
    with pytest.raises(ValueError, match="n_new"):
        a.alloc_mixed(2, [], 0)
    with pytest.raises(ValueError, match="dead block"):
        a.incref(mixed[3])


def test_allocator_and_index_follow_jax_op_for_op():
    """One script of allocations, shares, inserts, lookups, frees and
    evictions through both packages' allocator + index: the same chains,
    matches, refcounts and counters at every step."""
    sides = []
    for alloc_cls, index_cls in ((BlockAllocator, PrefixIndex),
                                 (JaxBlockAllocator, JaxPrefixIndex)):
        a = alloc_cls(14)
        sides.append((a, index_cls(4, a)))
    toks = np.arange(100, 124, dtype=np.int32)  # six full blocks of 4
    fork = toks.copy()
    fork[9] += 1
    script = [("alloc", 0, 5), ("insert", toks, 0, 16), ("lookup", toks),
              ("lookup", fork), ("mixed", 1, toks, 3), ("insert", fork, 1, 20),
              ("free", 0), ("evict", 2), ("free", 1), ("lookup", toks),
              ("evict", 9), ("alloc", 2, 6)]
    for op in script:
        results = []
        for a, ix in sides:
            if op[0] == "alloc":
                r = a.alloc(op[1], op[2])
            elif op[0] == "insert":
                r = ix.insert(op[1], a.chain(op[2]), op[3])
            elif op[0] == "lookup":
                r = ix.lookup(op[1])
            elif op[0] == "mixed":
                r = a.alloc_mixed(op[1], ix.lookup(op[2]), op[3])
            elif op[0] == "free":
                r = a.free(op[1])
            else:
                r = ix.evict(op[1])
            refs = [a.ref(b) for b in range(a.n_blocks)]
            results.append((r, refs, a.in_use, a.shared_blocks, len(ix), ix.metrics()))
        assert results[0] == results[1], op
    a, ix = sides[0]
    assert ix.clear() == len(sides[1][1])


def test_prefix_index_lru_prefers_oldest_leaf():
    a = BlockAllocator(16)
    idx = PrefixIndex(2, a)
    t1 = np.asarray([1, 2], np.int32)
    t2 = np.asarray([3, 4], np.int32)
    c1 = a.alloc(0, 1)
    idx.insert(t1, c1, 2)
    a.free(0)
    c2 = a.alloc(0, 1)
    idx.insert(t2, c2, 2)
    a.free(0)
    idx.lookup(t1)  # t1 is now the recent one
    assert idx.evict(1) == 1
    assert idx.lookup(t1) == c1 and idx.lookup(t2) == []
    with pytest.raises(ValueError, match="needs"):
        idx.insert(np.arange(8), c1, 8)


def test_blocks_needed_suffix_matches_jax():
    for covered in (0, 8, 16, 24):
        for prompt in (25, 31, 40):
            for new in (1, 9):
                for bl, chunk in ((4, 8), (8, 8), (8, 16)):
                    if covered % bl:
                        continue
                    assert (blocks_needed_suffix(covered, prompt, new, bl, chunk)
                            == jax_blocks_needed_suffix(covered, prompt, new, bl, chunk))


# ---------------------------------------------------------------------------
# the scheduler against the JAX scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny_config(attention="dense", max_seq_len=96)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params))


def shared_prompts(prefix_len=24, tails=(8, 9, 3), seed=0):
    shared = np.arange(1, prefix_len + 1, dtype=np.int32)
    rng = np.random.default_rng(seed)
    return [np.concatenate([shared, rng.integers(1, 128, (l,)).astype(np.int32)])
            for l in tails]


def drive(s, prompts, budgets, stagger=4):
    """Submit with ``stagger`` steps between arrivals (earlier prompts'
    blocks are indexed before later lookups), then drain; streams in
    submit order."""
    outs, rids = {}, []
    for p, b in zip(prompts, budgets):
        rids.append(s.submit(p, b))
        for _ in range(stagger):
            for rid, tok in s.step():
                outs.setdefault(rid, []).append(int(tok))
    for rid, toks in s.drain().items():
        outs.setdefault(rid, []).extend(int(t) for t in toks)
    return [outs[r] for r in rids]


PREFIX_KEYS = ("prefix_hits", "prefix_lookups", "prefix_cow_copies",
               "prefix_covered_tokens", "admitted_prefill_tokens",
               "prefix_index_blocks", "prefix_inserts", "prefix_evictions",
               "blocks_fresh_allocated", "blocks_shared_reused")


@pytest.mark.parametrize("kv", [None, "int8", "fp8"])
def test_prefix_on_off_streams_and_accounting_match_jax(weights, kv):
    """Tail 8 makes a 32-token prompt, a block multiple: its duplicate is
    a full-cover hit, the copy-on-write path (quantized pools: the scales
    are copied too)."""
    jcfg, jparams, state = weights
    prompts = shared_prompts()
    prompts.append(prompts[0].copy())
    budgets = [6] * 4
    kw = dict(n_slots=3, block_len=8, prefill_chunk=16, kv_dtype=kv)
    jon = JaxScheduler(jcfg, jparams, prefix_cache=True, gather_impl="dense", **kw)
    want = drive(jon, prompts, budgets)
    cfg = tiny_config(max_seq_len=96)
    on = Scheduler(cfg, state, prefix_cache=True, device="cpu", **kw)
    off = Scheduler(cfg, state, device="cpu", **kw)
    assert drive(on, prompts, budgets) == want
    assert drive(off, prompts, budgets) == want
    m_on, m_off, m_jax = on.metrics(), off.metrics(), jon.metrics()
    assert {k: m_on[k] for k in PREFIX_KEYS} == {k: m_jax[k] for k in PREFIX_KEYS}
    assert m_on["prefix_hits"] >= 3 and m_on["prefix_cow_copies"] >= 1
    assert m_on["admitted_prefill_tokens"] < m_off["admitted_prefill_tokens"]
    assert m_off["prefix_hits"] == 0 and not m_off["prefix_cache"]
    # retired chains decref, the index keeps its blocks; teardown drops them
    assert on.engine.allocator.in_use == m_on["prefix_index_blocks"] > 0
    on.engine.release_all()
    assert on.engine.allocator.in_use == 0


def test_prefix_covered_cap_keeps_padded_tail_in_bounds():
    """A 28-token prompt twice at max_seq_len 32: the full-cover candidate
    (27 covered) would pad to 35 > 32, so the cap drops it to the 24-token
    block boundary (3 shared blocks, no copy-on-write)."""
    jcfg = jax_tiny_config(attention="dense", max_seq_len=32)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    prompt = np.arange(1, 29, dtype=np.int32)
    kw = dict(n_slots=2, block_len=8, prefill_chunk=8)
    want = drive(JaxScheduler(jcfg, params, prefix_cache=True, gather_impl="dense",
                              **kw), [prompt, prompt.copy()], [4, 4])
    on = Scheduler(tiny_config(max_seq_len=32), params_from_jax(
        jax.tree.map(np.asarray, params)), prefix_cache=True, device="cpu", **kw)
    assert drive(on, [prompt, prompt.copy()], [4, 4]) == want
    m = on.metrics()
    assert m["prefix_hits"] >= 1 and m["prefix_covered_tokens"] == 24
    assert m["prefix_cow_copies"] == 0


def test_prefix_eviction_under_pool_pressure(weights):
    """Index-only blocks are the first valve: an admission short of fresh
    blocks evicts least recently used index blocks and proceeds."""
    jcfg, jparams, state = weights
    kw = dict(n_slots=1, n_blocks=8, block_len=8, prefill_chunk=8, prefix_cache=True)
    first, second = np.arange(1, 17, dtype=np.int32), np.arange(40, 80, dtype=np.int32)
    runs = []
    for sched in (JaxScheduler(jcfg, jparams, gather_impl="dense", **kw),
                  Scheduler(tiny_config(max_seq_len=96), state, device="cpu", **kw)):
        r0 = sched.submit(first, 2)
        out0 = sched.drain()[r0]
        indexed = sched.metrics()["prefix_index_blocks"]
        r1 = sched.submit(second, 2)  # needs 6 of the 7 usable blocks
        out1 = sched.drain()[r1]
        m = sched.metrics()
        runs.append(([int(t) for t in out0], [int(t) for t in out1], indexed,
                     m["prefix_evictions"], m["prefix_index_blocks"]))
    assert runs[1] == runs[0]
    assert runs[1][2] >= 2 and runs[1][3] >= 1


def test_prefix_hit_under_pressure_spares_its_own_blocks(weights):
    """A hit whose fresh blocks do not fit evicts for room, but never the
    index blocks it is about to share: with only those evictable the
    admission is a clean OOM (None, nothing changed), where the JAX engine
    evicts its own match and then fails to share a dead block. The same
    prefix admits once the request fits."""
    _, _, state = weights
    eng = PagedEngine(tiny_config(max_seq_len=96), state, 2, n_blocks=5, block_len=4,
                      prefill_chunk=4, prefix_cache=True, device="cpu")
    first = np.arange(1, 9, dtype=np.int32)
    assert eng.admit_shared(0, first, 1).covered == 0
    assert eng.prefix_insert(0, first, 8) == 2
    eng.release(0)  # two index-only blocks, two free
    longer = np.concatenate([first, np.arange(20, 24, dtype=np.int32)])
    assert eng.admit_shared(1, longer, 5) is None  # 2 shared + 3 fresh > 4 usable
    assert len(eng.prefix) == 2 and eng.allocator.in_use == 2
    assert eng.prefix.metrics()["prefix_evictions"] == 0
    hit = eng.admit_shared(1, longer, 1)  # 2 shared + 2 fresh
    assert hit.covered == 8 and hit.shared == 2 and eng.allocator.in_use == 4
