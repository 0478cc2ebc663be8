"""SLO-aware admission: route, spill, preempt, queue or shed, and the
autoscaler's recommendation (``pytorch_distributed_tpu/fleet/admission.py``,
a copy but for ``trace_decision``, which waits for request tracing).

``SLOGate.route`` decides from each candidate replica's live metrics
(``Scheduler.gate_metrics()``) and the session's affinity replica:

- **admit** to the affinity replica while it has headroom;
- **prefix-sticky**: with ``prefix_sticky_depth`` set, stay on an affinity
  replica with a prefix cache that is hot by queue depth alone;
- **spill** to the least-loaded cool replica when the affinity replica is
  hot (queue past ``spill_queue_depth``, a live TTFT or queue-wait p95 past
  its target, draining, or an anomaly);
- **preempt** on the least-loaded replica that has a preemptible chain once
  every replica is past ``shed_queue_depth``;
- **pressure-queue**: with nothing preemptible, an offload replica still
  queues up to ``pressure_queue_depth``;
- **queue** (an admit or spill with the hot signal as its reason) on the
  least-loaded replica when every replica is hot but none past the shed
  bound;
- **shed** as the last resort, and at once for a request whose deadline
  has lapsed (``deadline-expired``).

The defaults never shed: the latency targets are infinite, so every
decision is a function of queue depths and occupancy, which a trace
replayed in the step domain reproduces exactly. ``recommend_replicas``
scales up when every replica is hot and down when the fleet is idle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence

#: Decision.action values
ADMIT, SPILL, SHED = "admit", "spill", "shed"
PREEMPT = "preempt"


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Admission targets. Latency SLOs are wall-clock milliseconds
    checked against the replicas' LIVE p95 series; depth bounds are
    step-domain (deterministic under trace replay)."""

    ttft_p95_ms: float = float("inf")
    queue_wait_p95_ms: float = float("inf")
    #: prefer another replica once the affinity replica queues this deep
    spill_queue_depth: int = 4
    #: reject (with reason) once EVERY replica queues this deep
    shed_queue_depth: int = 64
    #: pressure backstop: when every replica is past the shed
    #: bound and no chain is preemptible RIGHT NOW, an offload-capable
    #: replica may still queue the request up to this depth (None = no
    #: bound — the zero-shed mode: pressure degrades to backpressure,
    #: never to rejects, as long as the pressure tier is on)
    pressure_queue_depth: Optional[int] = None
    #: prefix locality rung: when the session's affinity
    #: replica runs a prefix cache and is hot ONLY by queue depth (not
    #: draining, not an SLO/anomaly breach), stay sticky up to this
    #: deeper bound instead of spilling — the request's shared prefix is
    #: resident THERE, and a spill re-prefills it from token zero on a
    #: cold replica. None = off (spill at spill_queue_depth as before).
    prefix_sticky_depth: Optional[int] = None

    def __post_init__(self):
        if self.spill_queue_depth < 1:
            raise ValueError("spill_queue_depth must be >= 1")
        if self.shed_queue_depth < self.spill_queue_depth:
            raise ValueError(
                "shed_queue_depth must be >= spill_queue_depth "
                f"({self.shed_queue_depth} < {self.spill_queue_depth})"
            )
        if (self.pressure_queue_depth is not None
                and self.pressure_queue_depth < self.shed_queue_depth):
            raise ValueError(
                "pressure_queue_depth must be >= shed_queue_depth "
                f"({self.pressure_queue_depth} < {self.shed_queue_depth})"
            )
        if self.prefix_sticky_depth is not None and not (
            self.spill_queue_depth <= self.prefix_sticky_depth
            <= self.shed_queue_depth
        ):
            raise ValueError(
                "prefix_sticky_depth must lie in [spill_queue_depth, "
                f"shed_queue_depth], got {self.prefix_sticky_depth}"
            )


class Decision(NamedTuple):
    """One routing decision: ``action`` ∈ {admit, spill, preempt, shed},
    ``replica`` the target id (-1 on shed), ``reason`` why the affinity
    replica was left / the request was shed ('' on plain admits). A
    ``preempt`` decision means: park one LRU chain on ``replica`` (the
    router calls ``Scheduler.preempt_lru``) and queue the request
    there."""

    action: str
    replica: int
    reason: str


class SLOGate:
    """Stateless routing policy over live per-replica metrics dicts
    (``Scheduler.metrics()`` shape: ``queue_depth``, ``occupancy``,
    ``ttft_p95_s``, ``queue_wait_p95_s``, ``draining``)."""

    def __init__(self, slo: Optional[SLOConfig] = None):
        self.slo = slo if slo is not None else SLOConfig()

    # ---- per-replica predicates ----

    def hot(self, m: dict) -> Optional[str]:
        """The first SLO signal this replica violates, or None while it
        has headroom. Draining replicas are permanently hot — the gate
        routes around them during scale-down. A replica whose anomaly
        sentinel fired recently (``anomaly_recent``: a
        tick-time/TTFT/queue-depth z-score excursion) is hot too: the
        gate spills around a replica that is *degrading* before its p95
        series has drifted far enough to breach the SLO itself."""
        if m.get("draining"):
            return "draining"
        if m["queue_depth"] >= self.slo.spill_queue_depth:
            return "queue_depth"
        if m.get("ttft_p95_s", 0.0) * 1e3 > self.slo.ttft_p95_ms:
            return "slo_ttft_p95"
        if m.get("queue_wait_p95_s", 0.0) * 1e3 > self.slo.queue_wait_p95_ms:
            return "slo_queue_wait_p95"
        if m.get("anomaly_recent"):
            return "anomaly"
        return None

    def overloaded(self, m: dict) -> bool:
        """Past the point where queueing is honest: one more request
        cannot meet the SLO no matter how the fleet routes it."""
        return (
            bool(m.get("draining"))
            or m["queue_depth"] >= self.slo.shed_queue_depth
        )

    @staticmethod
    def _load_key(m: dict):
        return (m["queue_depth"], m.get("occupancy", 0.0))

    # ---- the routing decision ----

    def route(self, metrics: Dict[int, dict],
              preferred: Optional[int] = None,
              deadline_s: Optional[float] = None) -> Decision:
        """Pick a replica for one request given each candidate replica's
        live metrics (``{replica_id: metrics_dict}``) and the session's
        affinity replica (None for session-less requests).

        ``deadline_s`` is the request's remaining deadline budget
        (seconds; None = no deadline). A request that arrives already
        expired — or will expire before any replica could plausibly
        admit it — is shed HERE with reason ``"deadline-expired"``:
        admission is the first enforcement point of the per-request
        deadline, and an honest immediate expiry beats
        queueing work the client has already abandoned."""
        if not metrics:
            raise ValueError("route() needs at least one candidate replica")
        if deadline_s is not None and deadline_s <= 0:
            return Decision(SHED, -1, "deadline-expired")
        hot = {i: self.hot(m) for i, m in metrics.items()}
        if preferred is not None and hot.get(preferred) is None:
            return Decision(ADMIT, preferred, "")
        # prefix locality rung: the affinity replica's index
        # holds this session's prefix — if it is hot ONLY by queue
        # depth, queue a bit deeper there rather than paying a cold
        # O(prompt) prefill elsewhere. Never overrides draining or a
        # live SLO/anomaly breach, and never exceeds the shed bound.
        if (
            self.slo.prefix_sticky_depth is not None
            and preferred is not None
            and hot.get(preferred) == "queue_depth"
            and metrics[preferred].get("prefix_cache")
            and metrics[preferred]["queue_depth"]
            < self.slo.prefix_sticky_depth
        ):
            return Decision(ADMIT, preferred, "prefix-sticky")
        by_load = sorted(metrics, key=lambda i: self._load_key(metrics[i]))
        cool = [i for i in by_load if hot[i] is None]
        if cool:
            action = SPILL if preferred is not None else ADMIT
            return Decision(action, cool[0], hot.get(preferred) or "")
        if all(self.overloaded(m) for m in metrics.values()):
            # the preempt rung: before shedding, park an
            # idle resident chain on the least-loaded replica that has
            # one — pressure degrades to a cheap preemption, shed stays
            # the last resort
            preemptable = [
                i for i in by_load
                if metrics[i].get("preemptible", 0) > 0
                and not metrics[i].get("draining")
            ]
            if preemptable:
                i = preemptable[0]
                return Decision(PREEMPT, i, hot[i] or "pressure")
            # nothing preemptible RIGHT NOW (protection windows, chains
            # mid-swap): an offload fleet still queues up to the
            # pressure bound — its parked work WILL free capacity
            pressured = [
                i for i in by_load
                if metrics[i].get("offload")
                and not metrics[i].get("draining")
                and (self.slo.pressure_queue_depth is None
                     or metrics[i]["queue_depth"]
                     < self.slo.pressure_queue_depth)
            ]
            if pressured:
                i = pressured[0]
                action = (
                    SPILL if preferred is not None and i != preferred
                    else ADMIT
                )
                return Decision(action, i, "pressure-queue")
            victim = preferred if preferred is not None else by_load[0]
            return Decision(SHED, -1, hot[victim] or "queue_depth")
        # every replica hot, none past the shed bound: queue on the
        # least-loaded that can still take work — backpressure
        for i in by_load:
            if not self.overloaded(metrics[i]):
                action = (
                    SPILL if preferred is not None and i != preferred
                    else ADMIT
                )
                return Decision(action, i, hot[i] or "")
        return Decision(SHED, -1, "queue_depth")  # unreachable guard


def recommend_replicas(
    n_now: int,
    metrics: Sequence[dict],
    gate: SLOGate,
    *,
    low_utilization: float = 0.25,
) -> int:
    """Replica-count recommendation from live fleet metrics.

    Scale **up** when every replica is hot (the gate has nowhere cool
    left to route — more capacity is the only lever). Scale **down**
    when the fleet is provably idle: mean slot occupancy under
    ``low_utilization``, all queues empty, and mean ledger goodput
    (non-compile wall fraction) above 0.5 — a compile-bound fleet is
    warming up, not idle, and shrinking it would re-pay the warmup.
    Otherwise hold. Never recommends below 1.
    """
    if not metrics:
        return n_now
    if all(gate.hot(m) is not None for m in metrics):
        return n_now + 1
    occ = sum(m.get("occupancy_mean", 0.0) for m in metrics) / len(metrics)
    goodput = sum(m.get("goodput_frac", 1.0) for m in metrics) / len(metrics)
    if (
        n_now > 1
        and occ < low_utilization
        and goodput > 0.5
        and all(m["queue_depth"] == 0 for m in metrics)
    ):
        return n_now - 1
    return n_now
