"""The fleet's failure plane on the port, the fast subset of the JAX
package's chaos matrix (``tests/test_chaos_matrix.py``): a replica
killed mid-serve is condemned, abandoned with no block left and its
requests re-dispatched, their streams equal to the fault-free run's and
to the JAX fleet's under the same plan; a transient fault leaves a
replica suspect, then healthy; a hang past the tick deadline condemns;
the attempt cap fails a request; ``revive`` rejoins with no capture by
the survivors; a deadline expires a handoff-ready request and survives a
re-dispatch unchanged. Then ``HostWorkerPool`` and ``FleetWatchdog`` on
their own. The backoff is 0 s in the runs held against each other, so
that a re-dispatch never waits on the wall clock.
"""

import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.fleet import FleetRouter as JaxRouter
from pytorch_distributed_tpu.models.transformer import TransformerLM as JaxLM
from pytorch_distributed_tpu.models.transformer import tiny_config as jax_tiny_config
from pytorch_distributed_tpu.resilience import faults as jax_faults
from pytorch_distributed_tpu.serving import Scheduler as JaxScheduler
from pytorch_distributed_tpu_torch.fleet import FleetRouter
from pytorch_distributed_tpu_torch.models import params_from_jax, tiny_config
from pytorch_distributed_tpu_torch.resilience import FleetWatchdog, faults
from pytorch_distributed_tpu_torch.serving import HostWorkerPool, Scheduler

MAX_SEQ = 96
SERVE = dict(n_slots=3, block_len=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def model():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jax_tiny_config(attention="dense", max_seq_len=MAX_SEQ)
    params = JaxLM(jcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    yield jcfg, params, params_from_jax(jax.tree.map(np.asarray, params))
    torch.set_num_threads(threads)


def fleet(model, **kw):
    return FleetRouter(tiny_config(max_seq_len=MAX_SEQ), model[2], device="cpu",
                       **{"n_replicas": 2, **SERVE, **kw})


def prompts(n=3, base=9, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 128, (base + i,)).astype(np.int32) for i in range(n)]


def run(router, reqs, max_new=6, plan=None, fault_module=faults, deadline_s=None):
    if plan is not None:
        fault_module.install_plan(plan)
    try:
        rids = [router.submit(p, max_new, deadline_s=deadline_s) for p in reqs]
        out = router.drain(max_steps=4000)
    finally:
        if plan is not None:
            fault_module.clear_plan()
    return {rid: [int(t) for t in out.get(rid, [])] for rid in rids}


def left(router):
    return [s.engine.allocator.in_use for s in router.replicas]


def test_redispatched_streams_equal_the_fault_free_run_and_jax(model):
    ref = run(fleet(model), prompts())
    assert all(len(v) == 6 for v in ref.values())
    router = fleet(model, fail_threshold=1, redispatch_base_delay_s=0.0)
    plan = faults.FaultPlan([faults.FaultSpec(site="serve.dispatch", kind="raise", at=2)])
    got = run(router, prompts(), plan=plan)
    assert plan.fired == [("serve.dispatch", 2, "raise")]
    m = router.metrics()
    assert m["replica_deaths"] == 1 and m["replicas_healthy"] == 1
    assert m["redispatched"] >= 1 and m["failed"] == 0
    assert [h["state"] for h in router.health] == ["dead", "healthy"]
    assert got == ref and left(router) == [0, 0]
    jrouter = JaxRouter(model[0], model[1], n_replicas=2, fail_threshold=1,
                        redispatch_base_delay_s=0.0, gather_impl="dense", anomaly_threshold=0,
                        **SERVE)
    jplan = jax_faults.FaultPlan([jax_faults.FaultSpec(site="serve.dispatch", kind="raise",
                                                       at=2)])
    assert run(jrouter, prompts(), plan=jplan, fault_module=jax_faults) == got
    assert jrouter.metrics()["redispatched"] == m["redispatched"]


@pytest.mark.parametrize("site,n_replicas", [("serve.collect", 2),
                                             ("serve.handoff_export", 2),
                                             ("serve.handoff_import", 3)])
def test_a_transient_fault_marks_suspect_then_recovers(model, site, n_replicas):
    router = fleet(model, n_replicas=n_replicas, disaggregate=site.startswith("serve.handoff"),
                   fail_threshold=2)
    plan = faults.FaultPlan([faults.FaultSpec(site=site, kind="raise")])
    out = run(router, prompts(), max_new=4, plan=plan)
    assert plan.fired and all(len(v) == 4 for v in out.values())
    assert all(h["state"] == "healthy" for h in router.health)
    assert sum(h["failures"] for h in router.health) == 1
    assert router.metrics()["replica_deaths"] == 0 and not any(left(router))


def test_a_hang_past_the_tick_deadline_condemns(model):
    router = fleet(model, tick_deadline_s=0.5, redispatch_base_delay_s=0.0)
    router.warmup()
    plan = faults.FaultPlan([faults.FaultSpec(site="serve.dispatch", kind="hang", at=2,
                                              seconds=0.6)])
    out = run(router, prompts(), plan=plan)
    assert plan.fired == [("serve.dispatch", 2, "hang")]
    assert [h["state"] for h in router.health].count("dead") == 1
    assert all(len(v) == 6 for v in out.values()) and not any(left(router))
    assert router.watchdog is not None and "replica0" not in router.watchdog._beats


def test_the_attempt_cap_fails_the_request_and_revive_drains_the_rest(model):
    outcomes = {}
    router = fleet(model, fail_threshold=1, redispatch_max_attempts=1,
                   redispatch_base_delay_s=0.0)
    router.on_retire = lambda rid, outcome: outcomes.__setitem__(rid, outcome)
    plan = faults.FaultPlan([faults.FaultSpec(site="serve.dispatch", kind="raise", at=2),
                             faults.FaultSpec(site="serve.dispatch", kind="raise", at=6)])
    faults.install_plan(plan)
    try:
        rids = [router.submit(p, 6) for p in prompts()]
        for _ in range(12):
            router.step()
    finally:
        faults.clear_plan()
    m = router.metrics()
    assert len(plan.fired) == 2 and m["replica_deaths"] == 2 and m["replicas_healthy"] == 0
    assert m["failed"] >= 1 and set(router.failed) <= set(rids)
    assert all(outcomes[rid] == "failed" for rid in router.failed)
    waiting = sorted(e["rid"] for e in router._pending_redispatch)
    assert set(waiting) == set(rids) - set(router.failed) and not router.idle
    shed = router.submit(prompts(1)[0], 4)
    assert router.rejected[shed] == "fleet-unavailable"
    router.revive(0)
    with pytest.raises(RuntimeError, match="not dead"):
        router.revive(0)
    out = router.drain(max_steps=4000)
    assert all(len(out[rid]) == 6 for rid in waiting)
    assert all(outcomes[rid] == "complete" for rid in waiting)


def test_revive_rejoins_with_no_capture_by_the_survivor(model):
    router = fleet(model, fail_threshold=1, redispatch_base_delay_s=0.0)
    plan = faults.FaultPlan([faults.FaultSpec(site="serve.dispatch", kind="raise", at=2)])
    out = run(router, prompts(), plan=plan)
    assert all(len(v) == 6 for v in out.values())
    dead = [i for i, h in enumerate(router.health) if h["state"] == "dead"]
    assert len(dead) == 1
    survivor = 1 - dead[0]
    programs = tuple(router.replicas[survivor].engine.compiled_program_names())
    router.revive(dead[0])
    assert router.health[dead[0]]["state"] == "healthy"
    rid = router.submit(prompts(1, base=12)[0], 4, session=9)
    rid2 = router.submit(prompts(1, base=13)[0], 4, session=10)
    out2 = router.drain()
    assert len(out2[rid]) == len(out2[rid2]) == 4
    assert tuple(router.replicas[survivor].engine.compiled_program_names()) == programs
    assert router.replicas[dead[0]].metrics()["completed"] >= 1
    router.assert_registry_covers()
    assert not any(left(router))


def test_a_deadline_expires_a_handoff_ready_request_as_in_jax(model):
    def expire(s):
        rid = s.submit(np.arange(1, 9, dtype=np.int32), 4, deadline_s=30.0)
        for _ in range(3):
            s.step()
        assert s.stuck_rids() == {"handoff-ready": [rid]}
        next(r for r in s.harvest_requests() if r.rid == rid).deadline = 0.0
        s.step()
        s.drain()
        m = s.metrics()
        return s.stuck_rids(), m["deadline_misses"], m["ready"], s.engine.allocator.in_use

    got = expire(Scheduler(tiny_config(max_seq_len=MAX_SEQ), model[2], device="cpu",
                           prefill_only=True, **SERVE))
    want = expire(JaxScheduler(model[0], model[1], prefill_only=True, handoff=True,
                               gather_impl="dense", **SERVE))
    assert got == want == ({}, 1, 0, 0)


def test_a_deadline_survives_redispatch_unchanged(model):
    router = fleet(model, disaggregate=True, fail_threshold=1, redispatch_base_delay_s=0.0)
    router.warmup()
    plan = faults.FaultPlan([faults.FaultSpec(site="serve.dispatch", kind="raise", at=3)])
    faults.install_plan(plan)
    try:
        rids = [router.submit(p, 4, deadline_s=0.5) for p in prompts(2)]
        deadlines = {r.rid: r.deadline for s in router.replicas for r in s.harvest_requests()}
        for _ in range(6):
            router.step()
    finally:
        faults.clear_plan()
    assert router.health[0]["state"] == "dead" and router.metrics()["redispatch_pending"] >= 1
    assert {rid: router._origin[rid]["deadline"] for rid in rids} == deadlines
    time.sleep(0.55)  # no entry replica: the deadline keeps running while they wait
    router.step()
    m = router.metrics()
    assert m["deadline_expired_redispatch"] >= 1 and router.idle
    assert all(len(router.results.get(rid, ())) < 4 for rid in rids)
    assert router.submit(prompts(1)[0], 4, deadline_s=-0.01) in router.rejected


def test_host_worker_pool_on_its_own():
    pool = HostWorkerPool(n_threads=3)
    hits, lock = [], threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def bump(i):
            with lock:
                hits.append(i)

        for i in range(200):
            pool.submit(lambda i=i: bump(i))
        pool.flush()
        assert sorted(hits) == list(range(200)) and pool.completed == pool.submitted == 200
        pool.submit(lambda: 1 / 0)
        with pytest.raises(RuntimeError, match="1 host-worker task"):
            pool.flush()
        pool.flush()  # a handled failure does not raise again
        assert pool.pending == 0
    finally:
        sys.setswitchinterval(old)
    pool.close()
    pool.close()
    assert not any(t.is_alive() for t in pool._threads)
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit(lambda: None)
    with pytest.raises(ValueError):
        HostWorkerPool(n_threads=0)


def test_fleet_watchdog_on_its_own():
    fired = []
    dog = FleetWatchdog(0.05, on_stall=lambda name, s, dump: fired.append((name, dump)))
    dog.watch("replica0")
    dog.watch("replica1")
    time.sleep(0.06)
    dog.beat("replica1")
    assert dog.check() == ["replica0"] and dog.stalled() == ["replica0"]
    assert dog.check() == [] and "thread" in fired[0][1]
    dog.unwatch("replica0")
    time.sleep(0.06)
    assert dog.check() == ["replica1"] and dog.stalls == 2
    with dog:
        dog.watch("replica2")
        deadline = time.monotonic() + 5.0
        while not any(n == "replica2" for n, _ in fired) and time.monotonic() < deadline:
            time.sleep(0.01)
    assert any(n == "replica2" for n, _ in fired) and dog._thread is None
    with pytest.raises(ValueError):
        FleetWatchdog(0)
