"""The port's pressure tier against the JAX package's.

The allocator's swap states, the host store's byte budget and the
swap-vs-recompute decision (with the ``PDT_PEAK_*_GBS`` overrides) follow
the JAX ones. A request preempted mid-decode and restored, by swap or by
recompute, streams the tokens of an unpreempted JAX scheduler; so do an
over-committed pool that preempts on OOM, a quantized pool whose chain
travels with its scales, a preempted chain that shares prefix blocks
(which stay resident), and a recompute restore that hits its own prefix
(the JAX tests at ``tests/test_pressure.py:81-280`` and
``tests/test_prefix.py:266``, ``:316``). No block or host byte is left
behind.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu.telemetry.costmodel import (
    swap_vs_recompute as jax_swap_vs_recompute,
)
from pytorch_distributed_tpu_torch.models import init_params, params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.serving import (
    BlockAllocator,
    HostBlockStore,
    HostChain,
    PagedEngine,
    Scheduler,
)
from pytorch_distributed_tpu_torch.telemetry import costmodel
from pytorch_distributed_tpu_torch.telemetry.costmodel import (
    LINK_ENV_D2H,
    LINK_ENV_H2D,
    swap_vs_recompute,
)

MAX_SEQ = 64

# ---------------------------------------------------------------------------
# allocator swap states, host store, the decision (host logic)
# ---------------------------------------------------------------------------


def test_allocator_swap_state_machine():
    a = BlockAllocator(8)
    a.alloc(0, 3)
    assert a.state(0) == "resident"
    a.set_state(0, "swapping-out")
    assert a.state(0) == "swapping-out" and a.swapping() == [0]
    with pytest.raises(RuntimeError, match="swapping-out"):
        a.free(0)  # a chain in transit cannot be freed
    a.clear_state(0)
    a.free(0)
    assert a.available == 7
    a.alloc(1, 2)
    a.set_state(1, "swapping-in")
    with pytest.raises(RuntimeError, match="swapping-in"):
        a.free(1)
    a.clear_state(1)
    a.free(1)
    with pytest.raises(ValueError, match="no chain"):
        a.set_state(5, "swapping-out")
    a.alloc(2, 1)
    with pytest.raises(ValueError, match="must be one of"):
        a.set_state(2, "teleporting")
    a.clear_state(99)  # idempotent
    # a swapped chain's free never drags a block the index still holds
    a.incref(a.chain(2)[0])
    a.set_state(2, "swapping-out")
    a.clear_state(2)
    a.free(2)
    assert a.in_use == 1


def test_release_all_refuses_mid_swap():
    cfg = tiny_config(max_seq_len=32)
    eng = PagedEngine(cfg, params_from_jax(init_params(cfg)), 2, block_len=8,
                      prefill_chunk=8, device="cpu")
    assert eng.admit(0, 9, 4)
    eng.allocator.set_state(0, "swapping-out")
    with pytest.raises(RuntimeError, match="swapping-out"):
        eng.release_all()
    eng.allocator.clear_state(0)
    eng.release_all()
    assert eng.allocator.in_use == 0


def test_host_block_store_accounting_and_budget():
    def chain(nbytes):
        return HostChain(blocks=None, logits_row=None, n_blocks=1, block_len=8,
                         nbytes=nbytes)

    store = HostBlockStore(max_bytes=100)
    assert store.has_room(100) and not store.has_room(101)
    assert store.put(1, chain(60))
    assert 1 in store and store.bytes_used == 60 and len(store) == 1
    assert not store.put(2, chain(50))  # over budget: refused, unchanged
    assert store.bytes_used == 60 and 2 not in store
    with pytest.raises(ValueError, match="already has"):
        store.put(1, chain(10))
    assert store.put(3, chain(40))
    assert store.rids() == [1, 3]
    assert store.pop(1).nbytes == 60 and store.bytes_used == 40
    assert HostBlockStore().has_room(10 ** 15)
    with pytest.raises(ValueError, match="max_bytes"):
        HostBlockStore(max_bytes=0)


def test_swap_vs_recompute_matches_jax_and_the_env_overrides(monkeypatch):
    cases = [dict(chunks=4, chunk_wall_s=0.010, h2d_bytes_s=2 ** 30, d2h_bytes_s=2 ** 30),
             dict(chunks=4, chunk_wall_s=0.0001, h2d_bytes_s=2 ** 30, d2h_bytes_s=2 ** 30),
             dict(chunks=0, h2d_bytes_s=2 ** 30, d2h_bytes_s=2 ** 30),
             dict(chunks=4, chunk_wall_s=0.01, h2d_bytes_s=0.0, d2h_bytes_s=0.0)]
    for kw in cases:
        ours = swap_vs_recompute(2 ** 20, **kw)
        ref = jax_swap_vs_recompute(2 ** 20, **kw)
        assert (ours.choice, ours.reason, ours.swap_s, ours.recompute_s,
                ours.bytes_to_move, ours.chunks) == (
            ref.choice, ref.reason, ref.swap_s, ref.recompute_s,
            ref.bytes_to_move, ref.chunks)
    # the overrides pin the decision: a dead link recomputes, a fast one swaps
    monkeypatch.setenv(LINK_ENV_H2D, "1e-9")
    monkeypatch.setenv(LINK_ENV_D2H, "1e-9")
    assert swap_vs_recompute(2 ** 20, chunks=2, chunk_wall_s=0.01).choice == "recompute"
    monkeypatch.setenv(LINK_ENV_H2D, "1e9")
    monkeypatch.setenv(LINK_ENV_D2H, "1e9")
    assert costmodel.link_bandwidth() == (1e18, 1e18)
    assert swap_vs_recompute(2 ** 20, chunks=2, chunk_wall_s=0.01).choice == "swap"


def test_link_probe_without_a_card_is_unmeasured(monkeypatch):
    """No card, no overrides: the link is unmeasured (None), never a CPU
    memcpy passed off as the link, and the decision says so."""
    monkeypatch.delenv(LINK_ENV_H2D, raising=False)
    monkeypatch.delenv(LINK_ENV_D2H, raising=False)
    monkeypatch.setattr(costmodel, "_link_cache", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert costmodel.link_bandwidth() == (None, None)
    assert swap_vs_recompute(10, chunks=1, chunk_wall_s=0.1).reason == "link-unmeasured"


# ---------------------------------------------------------------------------
# preempt and restore against the JAX scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params))


PROMPTS = [np.arange(1, 10, dtype=np.int32), np.arange(1, 6, dtype=np.int32)]


@pytest.fixture(scope="module")
def reference(weights):
    """Streams of an unpreempted JAX scheduler with an ample pool."""
    jcfg, jparams, _ = weights
    out = {}
    for kv in (None, "fp8"):
        s = JaxScheduler(jcfg, jparams, n_slots=2, block_len=8, prefill_chunk=8,
                         kv_dtype=kv, gather_impl="dense")
        rids = [s.submit(p, 6) for p in PROMPTS]
        res = s.drain()
        out[kv] = [[int(t) for t in res[r]] for r in rids]
    return out


def port(weights, **kw):
    return Scheduler(tiny_config(max_seq_len=MAX_SEQ), weights[2], device="cpu", **kw)


def assert_all_home(s):
    assert s.engine.allocator.in_use == 0 and not s.engine.allocator.swapping()
    assert len(s.host_store) == 0 and s.host_store.bytes_used == 0
    assert not s.parked and not s._swapping and not s._swap_slots


@pytest.mark.parametrize("kv", [None, "fp8"])
@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_preempt_restore_token_identical(weights, reference, policy, kv):
    """Preempted after 3 steps (mid-decode) and restored: the stream is
    the unpreempted one. An fp8 chain's swap carries its scales."""
    s = port(weights, n_slots=2, block_len=8, prefill_chunk=8, offload=True,
             swap_policy=policy, protect_ticks=0, kv_dtype=kv)
    a, b = (s.submit(p, 6) for p in PROMPTS)
    got = {a: [], b: []}
    for _ in range(3):
        for rid, tok in s.step():
            got[rid].append(tok)
    d = s.preempt(a)
    assert d is not None and d.choice == policy and d.reason == f"forced-{policy}"
    assert a not in {r.rid for r in s.resident.values()}
    for rid, toks in s.drain().items():
        got[rid].extend(toks)
    assert [got[a], got[b]] == reference[kv]
    m = s.metrics()
    assert m["preempts"] == m["restores"] == 1
    assert (m["decision_swap"], m["decision_recompute"]) == (
        (1, 0) if policy == "swap" else (0, 1))
    if policy == "swap":
        assert m["swap_outs"] == m["swap_ins"] == 1 and m["swap_bytes"] > 0
        assert m["swap_bytes"] == 2 * s.engine.chain_bytes(2)  # out and back in
    assert_all_home(s)


def test_swap_after_a_recompute_restore_resumes_at_its_position(weights):
    """Recompute-preempted, restored, then swap-preempted: the swap
    restore resumes at the position the lane had (the port keeps it);
    the stream is the unpreempted one. (The JAX scheduler puts such a lane
    at ``len(tokens) + produced``, which counts the tokens re-prefilled
    by the recompute twice, and its stream diverges here.)"""
    jcfg, jparams, _ = weights
    prompt = np.arange(1, 10, dtype=np.int32)
    ref = JaxScheduler(jcfg, jparams, n_slots=2, block_len=8, prefill_chunk=8,
                       gather_impl="dense")
    r = ref.submit(prompt, 12)
    want = [int(t) for t in ref.drain()[r]]
    s = port(weights, n_slots=2, block_len=8, prefill_chunk=8, offload=True,
             protect_ticks=0)
    rid = s.submit(prompt, 12)
    got = []
    for policy, steps in (("recompute", 3), ("swap", 5)):
        for _ in range(steps):
            got += [t for q, t in s.step() if q == rid]
        s.swap_policy = policy
        assert s.preempt(rid).choice == policy
    got += s.drain()[rid]
    assert got == want
    assert s.metrics()["restores"] == 2
    assert_all_home(s)


def test_preempt_validation(weights):
    s = port(weights, n_slots=2, block_len=8, prefill_chunk=8, offload=True)
    with pytest.raises(ValueError, match="not resident"):
        s.preempt(99)
    rid = s.submit(np.arange(1, 20, dtype=np.int32), 2)
    s.step()  # admitted, one chunk of three prefilled
    with pytest.raises(ValueError, match="mid-prefill"):
        s.preempt(rid)
    with pytest.raises(ValueError, match="preempt_on_oom"):
        port(weights, n_slots=2, preempt_on_oom=True)
    with pytest.raises(ValueError, match="swap_policy"):
        port(weights, n_slots=2, offload=True, swap_policy="maybe")


def test_full_host_store_turns_swap_into_recompute(weights, reference):
    s = port(weights, n_slots=2, block_len=8, prefill_chunk=8, offload=True,
             swap_policy="swap", protect_ticks=0, host_store_max_bytes=16)
    a, b = (s.submit(p, 6) for p in PROMPTS)
    got = {a: [], b: []}
    for _ in range(3):
        for rid, tok in s.step():
            got[rid].append(tok)
    d = s.preempt(a)
    assert (d.choice, d.reason) == ("recompute", "host-store-full")
    for rid, toks in s.drain().items():
        got[rid].extend(toks)
    assert [got[a], got[b]] == reference[None]
    assert_all_home(s)


def test_refused_host_commit_leaves_the_stream_resident(weights, reference):
    """The store fills between the swap-out's start and its commit: the
    commit is refused, the window closes with the chain untouched, and
    the lane decodes on as if nothing happened."""
    s = port(weights, n_slots=2, block_len=8, prefill_chunk=8, offload=True,
             swap_policy="swap", protect_ticks=0,
             host_store_max_bytes=10 ** 6)
    a, b = (s.submit(p, 6) for p in PROMPTS)
    got = {a: [], b: []}
    for _ in range(3):
        for rid, tok in s.step():
            got[rid].append(tok)
    assert s.preempt(a).choice == "swap"
    assert s.engine.allocator.swapping() == [s._swapping[0][2].slot]
    s.host_store.put(-1, HostChain(None, None, 1, 8, 10 ** 6))  # fills the budget
    for rid, toks in s.drain().items():
        got[rid].extend(toks)
    assert [got[a], got[b]] == reference[None]
    m = s.metrics()
    assert m["swap_aborts"] == 1 and m["parked"] == 0 and m["restores"] == 0
    s.host_store.pop(-1)
    assert_all_home(s)


def test_env_link_rate_steers_the_scheduler_decision(weights, monkeypatch):
    """With a measured chunk wall, the pinned link rate alone flips the
    preemption between swap and recompute."""

    def preempt_one(gbs):
        monkeypatch.setenv(LINK_ENV_H2D, gbs)
        monkeypatch.setenv(LINK_ENV_D2H, gbs)
        s = port(weights, n_slots=2, block_len=8, prefill_chunk=8, offload=True,
                 protect_ticks=0)
        s.submit(np.arange(1, 10, dtype=np.int32), 2)
        s.drain()  # the first chunk call is not a sample
        rid = s.submit(np.arange(1, 10, dtype=np.int32), 6)
        for _ in range(3):
            s.step()
        assert s._chunk_calls >= 1
        d = s.preempt(rid)
        s.drain()
        assert_all_home(s)
        return d

    d = preempt_one("1e9")
    assert (d.choice, d.reason) == ("swap", "measured-crossover")
    d = preempt_one("1e-9")
    assert (d.choice, d.reason) == ("recompute", "measured-crossover")


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_overcommitted_pool_preempts_on_oom(weights, policy):
    """Six requests on 7 usable blocks (each holds 2-4): admission OOM
    preempts the least recently served chain instead of waiting, and
    every stream equals the JAX scheduler's with an ample pool."""
    jcfg, jparams, _ = weights
    rng = np.random.default_rng(3)
    reqs = [rng.integers(1, 128, size=int(l)).astype(np.int32)
            for l in rng.integers(5, 20, size=6)]
    ref = JaxScheduler(jcfg, jparams, n_slots=4, block_len=8, prefill_chunk=8,
                       gather_impl="dense")
    ids = [ref.submit(p, 6) for p in reqs]
    res = ref.drain()
    want = [[int(t) for t in res[r]] for r in ids]
    s = port(weights, n_slots=4, n_blocks=8, block_len=8, prefill_chunk=8,
             offload=True, preempt_on_oom=True, swap_policy=policy, protect_ticks=0)
    ids = [s.submit(p, 6) for p in reqs]
    res = s.drain()
    assert [res[r] for r in ids] == want
    m = s.metrics()
    assert m["preempts"] == m["restores"] >= 1
    assert_all_home(s)


def shared_prompts(tails, prefix_len=24, seed=0):
    shared = np.arange(1, prefix_len + 1, dtype=np.int32)
    rng = np.random.default_rng(seed)
    return [np.concatenate([shared, rng.integers(1, 128, (l,)).astype(np.int32)])
            for l in tails]


@pytest.fixture(scope="module")
def weights96():
    jcfg = jax_tiny_config(attention="dense", max_seq_len=96)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params))


def test_shared_block_survives_preemption(weights96):
    """Swapping out a chain that shares prefix blocks never drags them:
    the index keeps them resident, and every stream (the restored victim
    included) equals the JAX scheduler's without sharing or preemption."""
    jcfg, jparams, state = weights96
    prompts, budgets = shared_prompts((5, 7)), [4, 8]
    cfg = tiny_config(max_seq_len=96)
    on = Scheduler(cfg, state, n_slots=3, block_len=8, prefill_chunk=8,
                   prefix_cache=True, offload=True, swap_policy="swap",
                   protect_ticks=0, device="cpu")
    outs = {}
    rid_a = on.submit(prompts[0], budgets[0])
    for _ in range(8):  # a prefills 4 chunks, streams 4 tokens, retires
        for rid, tok in on.step():
            outs.setdefault(rid, []).append(tok)
    assert len(outs[rid_a]) == budgets[0]
    rid_b = on.submit(prompts[1], budgets[1])
    for _ in range(4):  # b hits the prefix, prefills its tail, decodes
        for rid, tok in on.step():
            outs.setdefault(rid, []).append(tok)
    alloc = on.engine.allocator
    shared = [b for b in range(1, alloc.n_blocks) if alloc.ref(b) > 1]
    assert len(shared) >= 3
    assert on.preempt(rid_b).choice == "swap"
    for _ in range(2):
        for rid, tok in on.step():
            outs.setdefault(rid, []).append(tok)
    assert all(alloc.ref(b) >= 1 for b in shared)
    for rid, toks in on.drain().items():
        outs.setdefault(rid, []).extend(toks)
    m = on.metrics()
    assert m["preempts"] == m["restores"] == 1

    ref = JaxScheduler(jcfg, jparams, n_slots=3, block_len=8, prefill_chunk=8,
                       gather_impl="dense")
    want = {}
    ra = ref.submit(prompts[0], budgets[0])
    for _ in range(8):
        for rid, tok in ref.step():
            want.setdefault(rid, []).append(int(tok))
    rb = ref.submit(prompts[1], budgets[1])
    for rid, toks in ref.drain().items():
        want.setdefault(rid, []).extend(int(t) for t in toks)
    assert outs[rid_a] == want[ra] and outs[rid_b] == want[rb]
    on.engine.release_all()
    assert alloc.in_use == 0


def test_recompute_restore_hits_its_own_prefix(weights96):
    jcfg, jparams, state = weights96
    prompt = shared_prompts((5,))[0]
    on = Scheduler(tiny_config(max_seq_len=96), state, n_slots=2, block_len=8,
                   prefill_chunk=8, prefix_cache=True, offload=True,
                   swap_policy="recompute", protect_ticks=0, device="cpu")
    outs = []
    rid = on.submit(prompt, 8)
    for _ in range(6):
        outs += [t for r, t in on.step() if r == rid]
    hits = on.metrics()["prefix_hits"]
    assert on.preempt(rid).choice == "recompute"
    outs += on.drain()[rid]
    assert on.metrics()["prefix_hits"] > hits  # the restore hit its blocks
    ref = JaxScheduler(jcfg, jparams, n_slots=2, block_len=8, prefill_chunk=8,
                       gather_impl="dense")
    r = ref.submit(prompt, 8)
    assert outs == [int(t) for t in ref.drain()[r]]
