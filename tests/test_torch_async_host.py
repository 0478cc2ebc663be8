"""The port's lagged host loop against the JAX package's.

``Scheduler.dispatch_tick`` launches a tick and ``collect_tick`` takes its
tokens; driven lagged (``collect_tick(); dispatch_tick()`` each
iteration, one tick in flight between them) the port's greedy streams
equal the JAX ``Scheduler`` driven the same way (no fleet router) and
the port's own ``step()``, on an ample pool and on an over-committed one
that preempts by swap and by recompute. The first collect returns
nothing and a tick stays pending between iterations; ``preempt_lru``,
``cancel`` and ``begin_drain`` collect the tick in flight first and keep
its tokens for the next collect (cf. the JAX package's
``tests/test_async_host.py:161-228``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu_torch.models import params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.serving import TRASH_BLOCK, Scheduler

MAX_SEQ = 64
SERVE = dict(block_len=8, prefill_chunk=8)
POOLS = {
    "ample": dict(n_slots=3),
    "swap": dict(n_slots=4, n_blocks=8, offload=True, preempt_on_oom=True,
                 swap_policy="swap", protect_ticks=0),
    "recompute": dict(n_slots=4, n_blocks=8, offload=True, preempt_on_oom=True,
                      swap_policy="recompute", protect_ticks=0),
}


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params))


def make(weights, jax_ref=False, **kw):
    jcfg, jparams, state = weights
    if jax_ref:
        return JaxScheduler(jcfg, jparams, gather_impl="dense", **SERVE, **kw)
    return Scheduler(tiny_config(max_seq_len=MAX_SEQ), state, device="cpu", **SERVE, **kw)


def prompts(n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, size=int(l)).astype(np.int32)
            for l in rng.integers(5, 20, size=n)]


def take(streams, pairs):
    for rid, tok in pairs:
        streams.setdefault(rid, []).append(int(tok))


def lagged_drain(s, streams=None, max_ticks=1000):
    """``collect_tick(); dispatch_tick()`` until idle after a collect."""
    streams = {} if streams is None else streams
    for _ in range(max_ticks):
        take(streams, s.collect_tick())
        if s.idle:
            return streams
        s.dispatch_tick()
    raise AssertionError(f"lagged loop did not converge: {s.stuck_rids()}")


def step_drain(s, streams=None):
    streams = {} if streams is None else streams
    for rid, toks in s.drain().items():
        streams.setdefault(rid, []).extend(int(t) for t in toks)
    return streams


def assert_all_home(s):
    assert s.engine.allocator.in_use == 0 and len(s.host_store) == 0
    assert (np.asarray(s.engine.tables) == TRASH_BLOCK).all()
    assert not s.has_uncollected


@pytest.mark.parametrize("pool", list(POOLS))
def test_lagged_loop_streams_match_jax(weights, pool):
    reqs = prompts()
    ref = make(weights, jax_ref=True, **POOLS[pool])
    for p in reqs:
        ref.submit(p, 6)
    want = lagged_drain(ref)
    runs = {}
    for name, drain in (("lagged", lagged_drain), ("step", step_drain)):
        s = make(weights, **POOLS[pool])
        for p in reqs:
            s.submit(p, 6)
        runs[name] = (drain(s), s.metrics())
        assert_all_home(s)
    assert runs["lagged"][0] == want == runs["step"][0]
    m, m_step = runs["lagged"][1], runs["step"][1]
    mj = ref.metrics()
    for key in ("steps", "preempts", "restores", "swap_outs", "swap_ins",
                "decision_swap", "decision_recompute", "tokens_out"):
        assert m[key] == m_step[key] == mj[key], key
    if pool != "ample":
        assert m["preempts"] == m["restores"] >= 1


def test_first_collect_is_empty_and_a_tick_stays_in_flight(weights):
    s = make(weights, n_slots=3)
    rid = s.submit(np.arange(1, 10, dtype=np.int32), 3)  # two chunks of prefill
    assert s.collect_tick() == [] and not s.has_uncollected
    s.dispatch_tick()  # the first chunk: nothing to decode yet
    assert s._pending_tick is not None and not s.has_uncollected
    with pytest.raises(RuntimeError, match="one tick in flight"):
        s.dispatch_tick()
    assert s.collect_tick() == []
    seen, in_flight = [], 0
    for _ in range(10):
        s.dispatch_tick()
        in_flight += s.has_uncollected  # tokens launched, not yet collected
        seen += [t for r, t in s.collect_tick() if r == rid]
        if s.idle:
            break
    assert in_flight == 3 and len(seen) == 3
    ref = make(weights, n_slots=3)
    r = ref.submit(np.arange(1, 10, dtype=np.int32), 3)
    assert [int(t) for t in ref.drain()[r]] == [int(t) for t in seen]
    # step() after a lone dispatch collects that tick first: nothing lost
    s2 = make(weights, n_slots=3)
    r2 = s2.submit(np.arange(1, 10, dtype=np.int32), 3)
    s2.step()  # the first chunk
    s2.dispatch_tick()  # the second and the first token, left in flight
    got = [t for q, t in s2.step() if q == r2] + list(s2.drain()[r2])
    assert [int(t) for t in got] == [int(t) for t in seen]


def early_collect(weights, jax_ref, op):
    """Three requests, the lagged loop for four iterations, then ``op``
    with the fourth tick in flight, then the lagged loop to the end."""
    kw = dict(n_slots=3, offload=True, swap_policy="recompute", protect_ticks=0)
    s = make(weights, jax_ref=jax_ref, **kw)
    rids = [s.submit(p, 4) for p in prompts(3, seed=5)]
    streams = {}
    for _ in range(4):
        take(streams, s.collect_tick())
        s.dispatch_tick()
    assert s._pending_tick is not None
    if op == "preempt_lru":
        result = s.preempt_lru()
    elif op == "cancel":
        result = s.cancel(rids[0])
    else:
        s.begin_drain()
        result = s.draining
    assert s._pending_tick is None  # collected before the mutation
    stashed = list(s._collected)
    if op == "begin_drain":
        produced, requeued = s.drain_graceful()  # its first step delivers the stash
        assert requeued == [] and s.collect_tick() == []
        for r, ts in produced.items():
            streams.setdefault(r, []).extend(int(t) for t in ts)
    else:
        lagged_drain(s, streams)
    assert s.engine.allocator.in_use == 0
    return result, [(int(r), int(t)) for r, t in stashed], streams


@pytest.mark.parametrize("op", ["preempt_lru", "cancel", "begin_drain"])
def test_a_mutation_collects_the_tick_in_flight_first_as_jax(weights, op):
    want = early_collect(weights, True, op)
    got = early_collect(weights, False, op)
    assert got == want
    result, stashed, streams = got
    assert stashed  # the tick in flight had tokens, kept for the next collect
    if op != "cancel":
        assert sorted(streams) == [0, 1, 2] and all(len(v) == 4 for v in streams.values())
    else:
        assert result is True and len(streams[0]) < 4
