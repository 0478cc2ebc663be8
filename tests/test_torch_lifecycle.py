"""The request lifecycle of the port's ``Scheduler`` against the JAX
package's: cancel in every state a request can be in (queued,
mid-prefill, decoding, parked on either path, mid swap-out), deadlines
expiring in each, ``drain_graceful``'s requeued requests,
``harvest_requests`` and ``abandon`` with a tick in flight, and the
``kv.*`` fault sites under the same plan (cf. the JAX package's
``tests/test_chaos_matrix.py:358-433`` and ``tests/test_pressure.py:303``).

Each scenario runs one script of actions at fixed ticks through the JAX
scheduler's ``step()`` and through the port's ``step()`` and lagged loop
(``collect_tick(); dispatch_tick()``, the actions taken with a tick in
flight): return values, counters and greedy streams must be equal, and
no block or host byte may be left behind.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.resilience import faults as jax_faults
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu_torch.models import params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.resilience import faults
from pytorch_distributed_tpu_torch.serving import TRASH_BLOCK, Scheduler

MAX_SEQ = 64
KW = dict(n_slots=3, block_len=8, prefill_chunk=8, offload=True, swap_policy="swap",
          protect_ticks=0)
# rids 0-6: A decodes from tick 1, B prefills over three ticks, E, F and G
# wait in the queue
PROMPTS = [(np.arange(1, 6), 8), (np.arange(1, 21), 6), (np.arange(30, 36), 10),
           (np.arange(40, 47), 10), (np.arange(50, 54), 5), (np.arange(60, 69), 6),
           (np.arange(70, 73), 6)]
A, B, C, D, E, F, G = range(7)
SITES = ["kv.swap_out_d2h", "kv.host_write", "kv.swap_in_h2d"]
RUNS = ["jax", "port", "port-lagged"]


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jcfg, params, params_from_jax(jax.tree.map(np.asarray, params))


def make(run, weights, **kw):
    jcfg, jparams, state = weights
    if run == "jax":
        return JaxScheduler(jcfg, jparams, gather_impl="dense", **{**KW, **kw})
    return Scheduler(tiny_config(max_seq_len=MAX_SEQ), state, device="cpu", **{**KW, **kw})


def plans(run):
    """The fault module of the run's package."""
    return jax_faults if run == "jax" else faults


def raise_at(run, site, times=1):
    mod = plans(run)
    return mod.install_plan(mod.FaultPlan([mod.FaultSpec(site=site, kind="raise", at=0,
                                                         times=times)]))


def drive(s, actions, lagged, max_ticks=300):
    """Run ``s`` to idle by ``step()`` or by the lagged loop, calling
    ``actions[tick](s)`` after tick ``tick`` (lagged: with it in flight).
    Returns the streams and each action's result by tick."""
    streams, results = {}, {}
    for tick in range(1, max_ticks):
        if lagged:
            got = s.collect_tick()
        elif s.idle:
            break
        else:
            got = s.step()
        for rid, tok in got:
            streams.setdefault(rid, []).append(int(tok))
        if lagged:
            if s.idle:
                break
            s.dispatch_tick()
        if tick in actions:
            results[tick] = actions[tick](s)
    else:
        raise AssertionError(f"not idle after {max_ticks} ticks: {s.stuck_rids()}")
    return streams, results


def submit_all(s, **kw):
    return [s.submit(np.asarray(p, np.int32), n, **kw) for p, n in PROMPTS]


def assert_all_home(s):
    assert s.engine.allocator.in_use == 0 and not s.engine.allocator.swapping()
    assert len(s.host_store) == 0 and not s.parked and not s._swapping
    assert (np.asarray(s.engine.tables) == TRASH_BLOCK).all()


def run_scenario(run, weights, actions):
    s = make(run, weights)
    submit_all(s)
    try:
        streams, results = drive(s, actions(run), lagged=run == "port-lagged")
    finally:
        plans(run).clear_plan()
    assert_all_home(s)
    return s, streams, results


def cancel_actions(run):
    def t1(s):
        stuck = s.stuck_rids()
        return stuck, s.cancel(E), s.cancel(B)

    def t3(s):
        choice = s.preempt(A).choice
        return choice, s.stuck_rids(), s.cancel(A), s.cancel(A)

    def t4(s):
        choice = s.preempt(C).choice
        raise_at(run, "kv.swap_in_h2d", times=50)  # holds C parked
        return choice

    def t5(s):
        stuck = s.stuck_rids()
        done = s.cancel(C)
        plans(run).clear_plan()
        return stuck, done

    def t6(s):
        s.swap_policy = "recompute"
        choice = s.preempt(D).choice
        s.swap_policy = "swap"
        return choice, s.stuck_rids(), s.cancel(D), s.cancel(99)

    return {1: t1, 3: t3, 4: t4, 5: t5, 6: t6}


@pytest.fixture(scope="module")
def cancelled(weights):
    return {run: run_scenario(run, weights, cancel_actions) for run in RUNS}


@pytest.mark.parametrize("run", RUNS[1:])
def test_cancel_in_every_state_matches_jax(cancelled, run):
    ref, got = cancelled["jax"], cancelled[run]
    assert got[1] == ref[1]  # every stream, the cancelled ones' prefixes too
    assert got[2] == ref[2]  # every action's results
    for key in ("cancelled", "deadline_misses", "preempts", "restores", "swap_aborts",
                "completed", "tokens_out"):
        assert got[0].metrics()[key] == ref[0].metrics()[key], key


def test_cancel_scenario_reaches_every_state(cancelled):
    s, streams, results = cancelled["port"]
    assert results[1][0] == {"queued": [D, E, F, G], "prefill": [B], "decoding": [A, C]}
    assert results[1][1:] == (True, True)
    assert results[3][:2] == ("swap", {"queued": [F, G], "decoding": [C, D],
                                       "swapping": [A]})
    assert results[3][2:] == (True, False)  # idempotent
    # C's restore failed at kv.swap_in_h2d, and G took the slot it freed
    assert results[5] == ({"decoding": [D, F, G], "parked": [C]}, True)
    assert results[6][0] == "recompute" and results[6][1]["parked"] == [D]
    assert results[6][2:] == (True, False)
    m = s.metrics()
    assert (m["cancelled"], m["deadline_misses"], m["completed"]) == (5, 0, 2)
    assert m["swap_aborts"] == 1
    assert sorted(streams) == [A, C, D, F, G]  # B and E never decoded
    assert [len(streams[r]) for r in (A, C, D, F, G)] == [3, 4, 5, 6, 6]
    assert s.live_requests() == 0


def deadline_actions(run):
    def lapse(s, *rids):
        for req in s.harvest_requests():
            if req.rid in rids:
                req.deadline = 0.0  # long past on the perf_counter clock
        return s.stuck_rids()

    def t3(s):
        s.preempt(A)
        return lapse(s, A)

    def t4(s):
        s.preempt(C)
        raise_at(run, "kv.swap_in_h2d", times=50)

    def t6(s):
        plans(run).clear_plan()
        return lapse(s, D)

    return {1: lambda s: lapse(s, E, B), 3: t3, 4: t4, 5: lambda s: lapse(s, C), 6: t6}


@pytest.mark.parametrize("run", RUNS[1:])
def test_deadlines_expire_in_every_state_as_jax(weights, run):
    ref = run_scenario("jax", weights, deadline_actions)
    got = run_scenario(run, weights, deadline_actions)
    assert got[1] == ref[1] and got[2] == ref[2]
    m, mr = got[0].metrics(), ref[0].metrics()
    for key in ("cancelled", "deadline_misses", "preempts", "swap_aborts", "completed"):
        assert m[key] == mr[key], key
    assert (m["deadline_misses"], m["cancelled"]) == (5, 0)
    # the states they expired in: queued, prefill, swapping, parked, decoding
    states = {rid: state for stuck in got[2].values() if stuck
              for state, rids in stuck.items() for rid in rids}
    assert [states[r] for r in (E, B, A, C, D)] == [
        "queued", "prefill", "swapping", "parked", "decoding"]


def test_a_deadline_armed_at_submit_expires(weights):
    s = make("port", weights, offload=False, swap_policy="auto")
    fired = []
    s.on_retire = lambda rid, outcome: fired.append((rid, outcome))
    late = s.submit(np.arange(1, 9, dtype=np.int32), 4, deadline_s=-1.0)
    ok = s.submit(np.arange(1, 9, dtype=np.int32), 4, deadline_s=3600.0)
    out = s.drain()
    assert late not in out and len(out[ok]) == 4
    assert fired == [(late, "deadline"), (ok, "complete")]
    assert s.harvest_requests() == [] and s.metrics()["deadline_misses"] == 1


def test_drain_graceful_requeues_the_queue_as_jax(weights):
    outs = {}
    for run in ("jax", "port"):
        s = make(run, weights)
        submit_all(s)
        for _ in range(2):
            s.step()
        produced, requeued = s.drain_graceful()
        outs[run] = ({r: [int(t) for t in ts] for r, ts in produced.items()},
                     [r.rid for r in requeued])
        assert s.engine.allocator.in_use == 0 and s.draining
        with pytest.raises(RuntimeError, match="draining"):
            s.submit(np.arange(1, 4, dtype=np.int32), 2)
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == [D, E, F, G]


def test_harvest_and_abandon_with_a_tick_in_flight_as_jax(weights):
    harvested = {}
    for run in ("jax", "port"):
        s = make(run, weights)
        submit_all(s)
        for _ in range(3):
            s.step()
        s.preempt(A)  # mid swap-out
        s.swap_policy = "recompute"
        s.preempt(C)  # parked
        harvested[run] = ([r.rid for r in s.harvest_requests()], s.live_requests(),
                          s.stuck_rids())
        s.dispatch_tick()  # a tick in flight
        s.abandon()
        assert s.engine.allocator.in_use == 0 and len(s.host_store) == 0
        assert not s.engine.allocator.swapping() and not s.has_uncollected
        assert s.live_requests() == 0 and s.collect_tick() == []
        with pytest.raises(RuntimeError):
            s.submit(np.arange(1, 4, dtype=np.int32), 2)
    assert harvested["port"] == harvested["jax"]
    rids, live, stuck = harvested["port"]
    assert rids == list(range(7)) and live == 7 and set(stuck) == {
        "queued", "decoding", "parked", "swapping"}


@pytest.mark.parametrize("site", SITES, ids=lambda s: s.split(".")[1])
def test_fault_at_a_swap_site_matches_jax(weights, site):
    """A raise at each site: a swap-out fault reverts the preemption, a
    swap-in fault keeps the request parked and retries it; the streams,
    the aborts and the restores are the JAX scheduler's."""
    got = {}
    for run in ("jax", "port"):
        plan = raise_at(run, site)
        try:
            s = make(run, weights, n_slots=2)
            a = s.submit(np.arange(1, 10, dtype=np.int32), 6)
            stream = []
            for _ in range(3):
                stream += [int(t) for r, t in s.step() if r == a]
            s.preempt(a)
            stream += [int(t) for t in s.drain().get(a, [])]
            fired = list(plan.fired)
        finally:
            plans(run).clear_plan()
        m = s.metrics()
        got[run] = (stream, m["swap_aborts"], m["restores"], fired)
        assert s.engine.allocator.in_use == 0 and len(s.host_store) == 0
    assert got["port"] == got["jax"]
    assert got["port"][1:] == (1, int(site == "kv.swap_in_h2d"), [(site, 0, "raise")])


@pytest.mark.parametrize("lagged", [False, True], ids=["step", "lagged"])
def test_pressure_serve_survives_a_fault_at_every_site(weights, lagged):
    """The over-committed serve that preempts on OOM by swap, under a plan
    raising once at each ``kv.*`` site: every site fires, and the streams
    are the fault-free serve's, with nothing left behind."""
    rng = np.random.default_rng(3)
    reqs = [rng.integers(1, 128, size=int(l)).astype(np.int32)
            for l in rng.integers(5, 20, size=6)]
    kw = dict(n_slots=4, n_blocks=8, preempt_on_oom=True)

    def serve():
        s = make("port", weights, **kw)
        rids = [s.submit(p, 6) for p in reqs]
        streams, _ = drive(s, {}, lagged)
        assert_all_home(s)
        return [streams[r] for r in rids], s.metrics()

    want, m0 = serve()
    plan = faults.install_plan(faults.FaultPlan(
        [faults.FaultSpec(site=site, kind="raise", at=0) for site in SITES]))
    try:
        got, m = serve()
    finally:
        faults.clear_plan()
    assert got == want
    assert sorted(site for site, _, _ in plan.fired) == sorted(SITES)
    assert m["swap_aborts"] >= 3 and m0["swap_aborts"] == 0
    # the two swap-out faults revert their preemptions; the swap-in one retries
    assert m["restores"] == m["preempts"] - 2 >= 1
