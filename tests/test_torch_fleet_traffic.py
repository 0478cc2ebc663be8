"""The port's seeded traffic traces and admission policy against the JAX
package's (``pytorch_distributed_tpu/fleet/traffic.py``,
``admission.py``): the same numpy draws for every seed, trace files either
package reads, the same clamping and step mapping, and the same
``SLOGate`` decision and autoscaler recommendation on a grid of replica
metrics that reaches every rung."""

import itertools

import numpy as np
import pytest

from pytorch_distributed_tpu.fleet import admission as jax_admission
from pytorch_distributed_tpu.fleet import traffic as jax_traffic
from pytorch_distributed_tpu_torch.fleet import admission, traffic

TRACE_KW = [
    dict(seed=0),
    dict(seed=3, duration_s=300.0, base_rate=1.0, burst_rate_mult=6.0, burst_every_s=30.0,
         burst_len_s=3.0, prompt_median=24, prompt_sigma=0.9, prompt_max=512,
         max_new_median=8),
    dict(seed=11, duration_s=20.0, base_rate=5.0, burst_rate_mult=1.0, sessions=2,
         prompt_min=1, max_new_max=4),
]


def rows(trace):
    return [(r.rid, r.t, r.session, r.prompt_len, r.max_new) for r in trace]


@pytest.mark.parametrize("kw", TRACE_KW)
def test_traces_and_prompts_are_the_jax_draws(kw):
    want = jax_traffic.generate_trace(**kw)
    got = traffic.generate_trace(**kw)
    assert want and rows(got) == rows(want)
    for unique in (False, True):
        assert rows(traffic.iter_trace(unique_sessions=unique, **kw)) == rows(
            jax_traffic.iter_trace(unique_sessions=unique, **kw))
    for r_got, r_want in zip(got[:8], want[:8]):
        np.testing.assert_array_equal(traffic.prompt_for(r_got, 1000, seed=kw["seed"]),
                                      jax_traffic.prompt_for(r_want, 1000, seed=kw["seed"]))
        got_p = traffic.shared_prefix_prompt_for(r_got, 1000, 16, seed=kw["seed"],
                                                 n_prefixes=3)
        want_p = jax_traffic.shared_prefix_prompt_for(r_want, 1000, 16, seed=kw["seed"],
                                                      n_prefixes=3)
        assert got_p.dtype == want_p.dtype == np.int32
        np.testing.assert_array_equal(got_p, want_p)
    with pytest.raises(ValueError, match="prefix_len"):
        traffic.shared_prefix_prompt_for(got[0], 1000, 0)


def test_trace_files_cross_between_the_packages(tmp_path):
    trace = traffic.generate_trace(seed=1, duration_s=20.0)
    mine, theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    traffic.save_trace(mine, trace, seed=1)
    jax_traffic.save_trace(theirs, jax_traffic.generate_trace(seed=1, duration_s=20.0), seed=1)
    assert open(mine).read() == open(theirs).read()
    assert rows(jax_traffic.load_trace(mine)) == rows(traffic.load_trace(theirs))
    with open(mine, "a") as f:
        f.write('{"kind": "other"}\n\n')
    assert len(traffic.load_trace(mine)) == len(trace)
    with open(mine, "a") as f:
        f.write("not json\n")
    with pytest.raises(ValueError, match="not JSONL"):
        traffic.load_trace(mine)
    with open(theirs, "a") as f:
        f.write('{"kind": "trace", "rid": 0, "t": 0, "session": 0, "prompt_len": 1, '
                '"max_new": 1}\n')
    with pytest.raises(ValueError, match="duplicate rids"):
        traffic.load_trace(theirs)


def test_clamp_and_replay_follow_the_jax_package():
    trace = traffic.generate_trace(seed=2, duration_s=30.0, base_rate=3.0)
    jtrace = jax_traffic.generate_trace(seed=2, duration_s=30.0, base_rate=3.0)
    for max_seq, chunk in ((64, 16), (2048, 32), (100, 7)):
        assert rows(traffic.clamp_trace(trace, max_seq, chunk)) == rows(
            jax_traffic.clamp_trace(jtrace, max_seq, chunk))

    def replay(mod, trace, stream, tick_s=0.7):
        log, ticks = [], []
        fn = mod.replay_stream if stream else mod.replay_trace
        n = fn(iter(trace) if stream else trace, lambda r: log.append((len(ticks), r.rid)),
               lambda: ticks.append(None), lambda: len(log) == len(trace), tick_s=tick_s)
        return n, log

    for stream in (False, True):
        assert replay(traffic, trace, stream) == replay(jax_traffic, jtrace, stream)
    small = [traffic.TraceRequest(i, t, 0, 4, 2) for i, t in enumerate([0.0, 0.5, 1.0, 2.2])]
    # arrival t maps to the first tick k with t <= k * tick_s
    assert replay(traffic, small, False, 1.0)[1] == [(0, 0), (1, 1), (1, 2), (3, 3)]
    with pytest.raises(ValueError, match="tick_s"):
        traffic.replay_trace(small, print, print, lambda: True, tick_s=0)
    with pytest.raises(RuntimeError, match="did not converge"):
        traffic.replay_trace(small, lambda r: None, lambda: None, lambda: False, max_steps=5)
    with pytest.raises(ValueError, match="time-ordered"):
        traffic.replay_stream(reversed(small), lambda r: None, lambda: None, lambda: True)


def metric_grid():
    """Replica metrics dicts whose combinations reach every rung."""
    base = dict(queue_depth=0, occupancy=0.0, ttft_p95_s=0.0, queue_wait_p95_s=0.0,
                occupancy_mean=0.5, goodput_frac=0.9)
    variants = [
        {}, dict(queue_depth=1, occupancy=0.5), dict(queue_depth=2),
        dict(queue_depth=3, occupancy=1.0), dict(queue_depth=4), dict(queue_depth=6),
        dict(ttft_p95_s=0.2), dict(queue_wait_p95_s=0.2), dict(draining=True),
        dict(anomaly_recent=True), dict(queue_depth=2, prefix_cache=True),
        dict(queue_depth=4, preemptible=1), dict(queue_depth=5, offload=True),
        dict(queue_depth=7, offload=True), dict(queue_depth=4, preemptible=2, draining=True),
        dict(occupancy_mean=0.05), dict(occupancy_mean=0.05, goodput_frac=0.2),
    ]
    return [dict(base, **v) for v in variants]


SLOS = [dict(), dict(ttft_p95_ms=100.0, queue_wait_p95_ms=150.0, spill_queue_depth=2,
                     shed_queue_depth=4),
        dict(spill_queue_depth=2, shed_queue_depth=4, prefix_sticky_depth=3),
        dict(spill_queue_depth=2, shed_queue_depth=4, pressure_queue_depth=6)]


@pytest.mark.parametrize("slo", SLOS)
def test_slo_gate_decides_as_the_jax_gate(slo):
    gate = admission.SLOGate(admission.SLOConfig(**slo))
    jgate = jax_admission.SLOGate(jax_admission.SLOConfig(**slo))
    grid = metric_grid()
    seen = set()
    for a, b in itertools.product(grid, repeat=2):
        metrics = {0: a, 1: b}
        for preferred, deadline in ((None, None), (0, None), (1, None), (0, 0.0), (None, -1.0),
                                    (1, 5.0)):
            got = gate.route(metrics, preferred, deadline_s=deadline)
            assert got == jgate.route(metrics, preferred, deadline_s=deadline), (
                metrics, preferred, deadline)
            seen.add((got.action, got.reason))
        for n in (1, 2, 3):
            assert admission.recommend_replicas(n, [a, b], gate) == \
                jax_admission.recommend_replicas(n, [a, b], jgate)
    actions = {a for a, _ in seen}
    # the default shed depth (64) lies past the grid: only deadlines shed
    assert actions == {"admit", "spill", "shed"} | ({"preempt"} if slo else set())
    reasons = {r for _, r in seen}
    assert {"deadline-expired", "queue_depth", "draining", "anomaly"} <= reasons
    if slo.get("ttft_p95_ms"):
        assert {"slo_ttft_p95", "slo_queue_wait_p95"} <= reasons
    if slo.get("prefix_sticky_depth"):
        assert "prefix-sticky" in reasons
    if slo.get("pressure_queue_depth"):
        assert "pressure-queue" in reasons
    with pytest.raises(ValueError, match="at least one"):
        gate.route({})
    assert admission.recommend_replicas(2, [], gate) == 2


@pytest.mark.parametrize("bad", [dict(spill_queue_depth=0), dict(shed_queue_depth=2),
                                 dict(pressure_queue_depth=10),
                                 dict(prefix_sticky_depth=100)])
def test_slo_config_refuses_what_the_jax_one_refuses(bad):
    with pytest.raises(ValueError) as want:
        jax_admission.SLOConfig(**bad)
    with pytest.raises(ValueError) as got:
        admission.SLOConfig(**bad)
    assert str(got.value) == str(want.value)
