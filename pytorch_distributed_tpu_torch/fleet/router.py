"""The replica router: N schedulers behind one front end, one host loop
(``pytorch_distributed_tpu/fleet/router.py`` ``FleetRouter``:123).

``FleetRouter`` owns ``n_replicas`` ``serving.Scheduler`` replicas in one
process, placed round-robin over ``devices`` (default: every visible
card; ``device="cpu"`` puts them all on the CPU). Replicas on one card
share one copy of the weights. Requests enter through ``submit``:

- **session affinity**: a session's first request pins it to the replica
  the SLO gate picks and later ones follow (with ``prefix_cache=True``
  that is where its prefix is indexed). The table is an LRU of
  ``affinity_cap`` sessions;
- **admission** (``fleet.admission.SLOGate``): admit, spill, preempt,
  queue or shed against each replica's live metrics; a shed rid lands in
  ``rejected`` with the gate's reason and never streams;
- **one host loop**: ``step()`` ticks every live replica once, decode
  replicas first, then the prefill or mixed ones, then the handoff pump.
  With ``async_host=True`` each replica's tick is collected lagged:
  ``collect_tick()`` (its previous tick) then ``dispatch_tick()``, replica
  after replica, so one replica's host work overlaps the card's work for
  the others; a ``serving.HostWorkerPool`` computes the gate's
  percentiles. Per replica, collect(N-1) then dispatch(N) is the
  synchronous order, so the streams and every routing decision are the
  synchronous loop's.

Disaggregation (``disaggregate=True``): the first ``n_prefill`` replicas
run ``prefill_only`` schedulers and the rest decode (``decode_slots``
lanes each). The handoff pump moves each ready request's chain into the
least-loaded decode replica (``PagedEngine.export_chain`` then
``import_chain``; a gather and a scatter on one card, a copy across
cards), after which it decodes as if it had prefilled there.

The failure plane: each replica's health runs ``healthy → suspect → dead
→ draining → rejoining``. An exception out of a tick or the handoff marks
it suspect, ``fail_threshold`` in a row condemn it, and so does a tick
that overran ``tick_deadline_s`` (``resilience.FleetWatchdog`` holds a
heartbeat a replica). A condemned replica's requests are harvested, it
is abandoned with no block left behind, its sessions are unpinned and
its requests re-dispatched to the survivors after a seeded backoff
(``resilience.retry.backoff_delays``), each as its original prompt plus
every token already delivered; past ``redispatch_max_attempts`` a
request fails (``failed``), and a lapsed deadline expires it anywhere on
the way. ``revive(i)`` builds a fresh replica at a dead slot behind
warmup; the survivors capture nothing new.

``retain_results=False`` (the gateway's) drops a rid's results and
placement once it retires, for callers that consume ``step()``'s tokens
as they come. ``on_retire(rid, outcome)`` is called once a request
leaves for good (``complete``, ``cancelled``, ``deadline``, ``failed``).

Not ported (``ROADMAP.md``): the metrics JSONL (request, route, health and
redispatch records), the span tracer, the flight recorder, request
tracing, the dispatch ledger, the block sanitizer and the census
declarations.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch._device import resolve_device
from pytorch_distributed_tpu_torch.fleet.admission import (
    PREEMPT,
    SHED,
    SPILL,
    Decision,
    SLOConfig,
    SLOGate,
    recommend_replicas,
)
from pytorch_distributed_tpu_torch.resilience.retry import backoff_delays
from pytorch_distributed_tpu_torch.resilience.watchdog import FleetWatchdog
from pytorch_distributed_tpu_torch.serving.host_worker import HostWorkerPool
from pytorch_distributed_tpu_torch.serving.scheduler import Scheduler
from pytorch_distributed_tpu_torch.telemetry.latency import LatencySeries, percentiles

logger = logging.getLogger("pytorch_distributed_tpu_torch")

#: the states the router routes to (one failed tick is a warning)
ROUTABLE = ("healthy", "suspect")


def fleet_devices(devices=None, device=None) -> List[torch.device]:
    """The replicas' devices: ``devices`` as given, else ``[device]``, else
    every visible card (raising without one)."""
    if devices is not None and device is not None:
        raise ValueError("pass devices= or device=, not both")
    if devices is not None:
        out = [resolve_device(d) for d in devices]
        if not out:
            raise ValueError("devices= is empty")
        return out
    if device is not None:
        return [resolve_device(device)]
    resolve_device()  # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class FleetRouter:
    """Front end over N replicas.

    ``submit(prompt, max_new, session=...)`` routes (or sheds) one request
    and returns its fleet rid; ``step()`` advances every replica one tick
    and returns ``[(rid, token)]``; ``drain()`` runs the fleet to empty.
    ``metrics()`` rolls up the replicas' counters and percentiles, the
    shed and spill rates, the handoffs and the health plane."""

    def __init__(self, config, params, n_replicas: int = 2, *,
                 disaggregate: bool = False, n_prefill: int = 1,
                 decode_slots: Optional[int] = None,
                 handoffs_per_tick: Optional[int] = None,
                 slo: Optional[SLOConfig] = None, devices=None, device=None,
                 seed: int = 0, async_host: bool = False, host_threads: int = 2,
                 affinity_cap: int = 4096, fail_threshold: int = 2,
                 tick_deadline_s: Optional[float] = None,
                 redispatch_max_attempts: int = 3,
                 redispatch_base_delay_s: float = 0.05,
                 retain_results: bool = True,
                 **scheduler_kwargs):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if disaggregate:
            if n_replicas < 2:
                raise ValueError("disaggregation needs >= 2 replicas")
            if not 1 <= n_prefill < n_replicas:
                raise ValueError(f"n_prefill must be in [1, {n_replicas - 1}], got {n_prefill}")
        if affinity_cap < 1:
            raise ValueError(f"affinity_cap must be >= 1, got {affinity_cap}")
        if fail_threshold < 1:
            raise ValueError(f"fail_threshold must be >= 1, got {fail_threshold}")
        if redispatch_max_attempts < 1:
            raise ValueError(
                f"redispatch_max_attempts must be >= 1, got {redispatch_max_attempts}")
        self._devices = fleet_devices(devices, device)
        self.gate = SLOGate(slo)
        self.async_host = bool(async_host)
        self.host_pool = HostWorkerPool(n_threads=host_threads) if self.async_host else None
        # kept for revive(): a revived slot gets the dead one's geometry,
        # device and seed
        self._config = config
        self._params = params
        self._models: Dict[torch.device, torch.nn.Module] = {}
        self._seed = seed
        self._disaggregate = disaggregate
        self._decode_slots = decode_slots
        self._scheduler_kwargs = scheduler_kwargs
        self.roles: List[str] = [
            ("prefill" if i < n_prefill else "decode") if disaggregate else "mixed"
            for i in range(n_replicas)]
        self.replicas: List[Scheduler] = []
        for i in range(n_replicas):
            self.replicas.append(self._make_replica(i))
        self.disaggregated = disaggregate
        #: at most this many handoffs a step (None: no bound)
        self.handoffs_per_tick = handoffs_per_tick
        #: replicas requests enter through (mixed, or prefill when disaggregated)
        self.entry_group = [i for i, r in enumerate(self.roles) if r != "decode"]
        self.decode_group = [i for i, r in enumerate(self.roles) if r == "decode"]
        self._next_rid = 0
        self.affinity_cap = affinity_cap
        self._affinity: "OrderedDict[int, int]" = OrderedDict()  # session -> replica, LRU
        self._affinity_evictions = 0
        self.placement: Dict[int, int] = {}  # rid -> the replica holding it
        self.rejected: Dict[int, str] = {}  # rid -> shed reason
        self.results: Dict[int, List[int]] = {}  # rid -> delivered tokens
        self.retain_results = bool(retain_results)
        self._retired_pending: List[int] = []
        #: ``on_retire(rid, outcome)``, once a request leaves for good; called
        #: mid-step, before its last token reaches ``results``
        self.on_retire: Optional[Callable[[int, str], None]] = None
        self._results_dropped = 0
        self._spilled = 0
        self._preempt_routes = 0
        self._handoff_count = 0
        self.handoff_lat = LatencySeries("handoff")
        self._start_time: Optional[float] = None
        self._tick = 0
        # the autoscaler's signal means something only under load: sampled
        # as the fleet runs, its high-water mark kept
        self._recommend_peak = len(self.entry_group)
        # ---- the failure plane ----
        self.fail_threshold = fail_threshold
        self.tick_deadline_s = tick_deadline_s
        self.redispatch_max_attempts = redispatch_max_attempts
        self.redispatch_base_delay_s = redispatch_base_delay_s
        #: per-replica health records; they outlive a dead replica's scheduler
        self.health: List[dict] = [
            {"state": "healthy", "consecutive": 0, "failures": 0, "last_error": None,
             "since_tick": 0, "redispatched_away": 0, "deaths": 0}
            for _ in range(n_replicas)]
        #: rid -> the origin facts captured at its first harvest: the
        #: original prompt, budget, session, deadline and attempts
        self._origin: Dict[int, dict] = {}
        #: harvested requests waiting out their backoff: {rid, not_before, src}
        self._pending_redispatch: List[dict] = []
        #: rid -> reason, requests failed after admission (attempts spent)
        self.failed: Dict[int, str] = {}
        self._shed_total = 0
        self._failed_total = 0
        self._redispatched = 0
        self._deadline_expired_redispatch = 0
        self._deadline_sheds = 0
        self._ticking: Optional[int] = None
        # a heartbeat a replica, beaten around its ticks; step() itself
        # re-checks each tick's wall clock, so condemnation never races
        # the watcher's poll
        self.watchdog: Optional[FleetWatchdog] = None
        if tick_deadline_s is not None:
            self.watchdog = FleetWatchdog(tick_deadline_s, on_stall=self._on_stall)
            for i in range(n_replicas):
                self.watchdog.watch(f"replica{i}")

    def _make_replica(self, i: int) -> Scheduler:
        """Replica ``i``'s scheduler from the kept construction inputs
        (``__init__`` and ``revive``), on ``devices[i % len(devices)]``,
        sharing that device's model once one replica has built it."""
        role = self.roles[i]
        dev = self._devices[i % len(self._devices)]
        kw = dict(self._scheduler_kwargs)
        if role == "decode" and self._decode_slots is not None:
            kw["n_slots"] = self._decode_slots
        s = Scheduler(self._config, self._models.get(dev, self._params), replica_id=i,
                      seed=self._seed + i, prefill_only=role == "prefill", device=dev,
                      handoff=self._disaggregate, host_pool=self.host_pool, **kw)
        self._models.setdefault(dev, s.engine.model)
        s.on_retire = self._note_retire
        return s

    # ---- the health plane ----

    def _set_health(self, i: int, state: str, reason: str) -> None:
        rec = self.health[i]
        prev = rec["state"]
        if state == prev:
            return
        rec["state"] = state
        rec["since_tick"] = self._tick
        logger.info("fleet health: replica %d %s -> %s (%s)", i, prev, state, reason)

    def _alive(self, group: List[int]) -> List[int]:
        """The members of ``group`` the router still routes to."""
        return [i for i in group if self.health[i]["state"] in ROUTABLE]

    def _on_stall(self, name: str, stalled_s: float, dump: str) -> None:
        # the watcher thread: only the ticking replica can be wedged; the
        # condemnation itself is _run_tick's
        ticking = self._ticking
        if ticking is None or name != f"replica{ticking}":
            return
        logger.error("fleet watchdog: replica %d tick stalled %.3fs (deadline %.3fs)",
                     ticking, stalled_s, self.tick_deadline_s)

    def _note_success(self, i: int) -> None:
        rec = self.health[i]
        rec["consecutive"] = 0
        if rec["state"] == "suspect":
            self._set_health(i, "healthy", "tick-recovered")

    def _note_failure(self, i: int, exc: BaseException, site: str = "tick") -> None:
        """One failed tick or handoff touch: suspect, or condemned at
        ``fail_threshold`` in a row."""
        rec = self.health[i]
        if rec["state"] in ("dead", "draining"):
            return
        rec["consecutive"] += 1
        rec["failures"] += 1
        rec["last_error"] = f"{type(exc).__name__}: {exc}"
        logger.warning("fleet health: replica %d %s failure %d/%d: %s", i, site,
                       rec["consecutive"], self.fail_threshold, rec["last_error"])
        if rec["consecutive"] >= self.fail_threshold:
            self._condemn(i, f"{site}-failures:{rec['consecutive']}")
        else:
            self._set_health(i, "suspect", rec["last_error"])

    # ---- retention ----

    def _note_retire(self, rid: int, outcome: str) -> None:
        """The schedulers' retire hook. Results are dropped at the end of
        the step: the final token reaches ``results`` after the collect."""
        self._origin.pop(rid, None)
        if not self.retain_results:
            self._retired_pending.append(rid)
        if self.on_retire is not None:
            self.on_retire(rid, outcome)

    def _drop_retired(self) -> None:
        if self.retain_results or not self._retired_pending:
            return
        for rid in self._retired_pending:
            if self.results.pop(rid, None) is not None:
                self._results_dropped += 1
            self.placement.pop(rid, None)
        self._retired_pending.clear()

    #: shed and failed reasons kept when results are not retained
    _REJECT_CAP = 1024

    def _trim_rejects(self) -> None:
        if self.retain_results:
            return
        for table in (self.rejected, self.failed):
            while len(table) > self._REJECT_CAP:
                table.pop(next(iter(table)))

    def live_requests(self) -> int:
        """Every request in flight: each replica's, plus those awaiting
        re-dispatch."""
        return (sum(s.live_requests() for s in self.replicas)
                + len(self._pending_redispatch))

    # ---- condemnation and re-dispatch ----

    def _condemn(self, i: int, reason: str) -> None:
        """Declare replica ``i`` dead: harvest its requests, abandon it (no
        block left behind), unpin its sessions and queue the requests'
        re-dispatch after their backoff."""
        rec = self.health[i]
        if rec["state"] in ("dead", "draining"):
            return
        self._set_health(i, "draining", reason)
        s = self.replicas[i]
        harvested = s.harvest_requests()
        s.abandon()
        now = time.perf_counter()
        for req in harvested:
            rid = req.rid
            if rid not in self._origin:
                # once, at the first death: after a re-dispatch the
                # request's tokens already hold delivered output
                self._origin[rid] = {
                    "prompt": np.asarray(req.tokens[:req.orig_len], dtype=np.int32).copy(),
                    "max_new": req.max_new_tokens, "session": req.session,
                    "deadline": req.deadline, "attempts": 0}
            origin = self._origin[rid]
            self.placement.pop(rid, None)
            if req.deadline <= now:
                self._expire_request(rid)
                continue
            origin["attempts"] += 1
            rec["redispatched_away"] += 1
            if origin["attempts"] > self.redispatch_max_attempts:
                self._fail_request(
                    rid, f"redispatch-attempts-exhausted:{self.redispatch_max_attempts}")
                continue
            delays = backoff_delays(retries=self.redispatch_max_attempts,
                                    base_delay=self.redispatch_base_delay_s, seed=rid)
            delay = delays[min(origin["attempts"] - 1, len(delays) - 1)]
            self._pending_redispatch.append({"rid": rid, "not_before": now + delay, "src": i})
        for sess in [s_ for s_, r in self._affinity.items() if r == i]:
            del self._affinity[sess]
        if self.watchdog is not None:
            self.watchdog.unwatch(f"replica{i}")
        rec["deaths"] += 1
        rec["consecutive"] = 0
        self._set_health(i, "dead", reason)

    def _fail_request(self, rid: int, reason: str) -> None:
        """The attempt cap is spent: ``rid`` fails (it may have streamed
        some tokens; its stream never completes)."""
        self.failed[rid] = reason
        self._failed_total += 1
        self._trim_rejects()
        self._origin.pop(rid, None)
        if not self.retain_results:
            self._retired_pending.append(rid)
        if self.on_retire is not None:
            self.on_retire(rid, "failed")

    def _expire_request(self, rid: int) -> None:
        """The deadline lapsed while the request sat harvested or in its
        backoff."""
        self._deadline_expired_redispatch += 1
        self._origin.pop(rid, None)
        if not self.retain_results:
            self._retired_pending.append(rid)
        if self.on_retire is not None:
            self.on_retire(rid, "deadline")

    def _pump_redispatch(self) -> None:
        """Submit harvested requests to the least-loaded surviving entry
        replica once their backoff has passed: the original prompt plus
        every token already delivered (``results``), for the rest of the
        budget, past the gate (they were admitted once)."""
        if not self._pending_redispatch:
            return
        now = time.perf_counter()
        alive = self._alive(self.entry_group)
        still_waiting: List[dict] = []
        for entry in self._pending_redispatch:
            rid = entry["rid"]
            origin = self._origin.get(rid)
            if origin is None:  # failed or expired since
                continue
            if origin["deadline"] <= now:
                self._expire_request(rid)
                continue
            if not alive or now < entry["not_before"]:
                still_waiting.append(entry)
                continue
            delivered = self.results.get(rid, [])
            remaining = origin["max_new"] - len(delivered)
            if remaining <= 0:
                # every token was delivered before the replica died
                self._origin.pop(rid, None)
                if not self.retain_results:
                    self._retired_pending.append(rid)
                if self.on_retire is not None:
                    self.on_retire(rid, "complete")
                continue
            prompt = origin["prompt"]
            if delivered:
                prompt = np.concatenate([prompt, np.asarray(delivered, dtype=np.int32)])
            target = min(alive, key=lambda j: (len(self.replicas[j].resident)
                                               + len(self.replicas[j].queue)))
            self.replicas[target].submit(prompt, int(remaining), session=origin["session"],
                                         rid=rid, deadline=origin["deadline"])
            self.placement[rid] = target
            self._redispatched += 1
            if origin["session"] is not None:
                self._affinity[origin["session"]] = target
                self._affinity.move_to_end(origin["session"])
        self._pending_redispatch = still_waiting

    def revive(self, i: int, *, warmup: bool = True) -> None:
        """A fresh replica at dead slot ``i`` (the old one's geometry,
        device and seed), every program captured before it takes traffic
        when ``warmup``."""
        rec = self.health[i]
        if rec["state"] != "dead":
            raise RuntimeError(f"revive: replica {i} is {rec['state']}, not dead")
        self._set_health(i, "rejoining", "revive")
        self.replicas[i] = self._make_replica(i)
        if warmup:
            self.replicas[i].warmup(background=False)
        rec["consecutive"] = 0
        rec["last_error"] = None
        if self.watchdog is not None:
            self.watchdog.watch(f"replica{i}")
        self._set_health(i, "healthy", "revived")

    # ---- routing ----

    def _group_metrics(self, group: List[int]) -> Dict[int, dict]:
        return {i: self.replicas[i].gate_metrics() for i in group}

    def submit(self, prompt, max_new_tokens: int, *, session: Optional[int] = None,
               deadline_s: Optional[float] = None) -> int:
        """Route one request; returns its fleet rid. A shed rid never
        streams: ``rejected[rid]`` holds the reason. ``deadline_s`` is a
        budget from now: the gate sheds a lapsed one, and the instant it
        fixes travels with the request through every replica, re-dispatch
        included."""
        rid = self._next_rid
        self._next_rid += 1
        alive = self._alive(self.entry_group)
        preferred = None
        if session is not None:
            preferred = self._affinity.get(session)
            if preferred is not None:
                self._affinity.move_to_end(session)
            if preferred is not None and preferred not in alive:
                preferred = None  # its replica died: re-pin below
        if not alive:
            decision = Decision(SHED, -1, "fleet-unavailable")
        else:
            decision = self.gate.route(self._group_metrics(alive), preferred,
                                       deadline_s=deadline_s)
        if decision.action == SHED and decision.reason == "deadline-expired":
            self._deadline_sheds += 1
        if decision.action == SHED:
            self.rejected[rid] = decision.reason
            self._shed_total += 1
            self._trim_rejects()
            return rid
        target = decision.replica
        if session is not None and session not in self._affinity:
            self._affinity[session] = target
            while len(self._affinity) > self.affinity_cap:
                self._affinity.popitem(last=False)
                self._affinity_evictions += 1
        if decision.action == SPILL:
            self._spilled += 1
        elif decision.action == PREEMPT:
            # park one LRU chain on the target; the request queues there
            # even if the victim went away since the gate read the metrics
            self.replicas[target].preempt_lru(reason=decision.reason or "pressure")
            self._preempt_routes += 1
        self.replicas[target].submit(prompt, max_new_tokens, session=session, rid=rid,
                                     deadline_s=deadline_s)
        self.placement[rid] = target
        return rid

    # ---- the host loop ----

    def _pump_handoffs(self) -> None:
        """Move every ready request's chain prefill → decode, the decode
        replicas tried least-loaded first. A request no decode replica can
        take stays parked, its chain intact, for the next step; under the
        pressure tier one decode chain a pump is preempted to make room."""
        budget = (self.handoffs_per_tick if self.handoffs_per_tick is not None
                  else float("inf"))
        order = sorted(self._alive(self.decode_group),
                       key=lambda i: (len(self.replicas[i].resident),
                                      len(self.replicas[i].queue)))
        preempted_this_pump = False
        for pi in self._alive(self.entry_group):
            ps = self.replicas[pi]
            for rid in ps.ready_rids():
                if budget <= 0:
                    return
                try:
                    # a failure here is the source's: its ready set harvests
                    req, export = ps.peek_ready(rid)
                except Exception as e:  # noqa: BLE001 (the fault boundary)
                    self._note_failure(pi, e, site="handoff_export")
                    break
                t0 = time.perf_counter()
                adopted_by = None
                for di in order:
                    if self.health[di]["state"] not in ROUTABLE:
                        continue  # condemned earlier in this pump
                    try:
                        # a failure here is the target's; the export stays
                        # valid and the next candidate tries it
                        if self.replicas[di].adopt(req, export):
                            adopted_by = di
                            break
                    except Exception as e:  # noqa: BLE001
                        self._note_failure(di, e, site="handoff_import")
                if adopted_by is None:
                    if not preempted_this_pump:
                        for di in order:
                            if not self.replicas[di].offload:
                                continue
                            if self.replicas[di].preempt_lru(
                                    reason="handoff-pressure") is not None:
                                preempted_this_pump = True
                                self._preempt_routes += 1
                                break
                    break
                ps.complete_handoff(rid)
                self.handoff_lat.observe(time.perf_counter() - t0)
                self.placement[rid] = adopted_by
                self._handoff_count += 1
                budget -= 1

    def _run_tick(self, i: int) -> List[Tuple[int, int]]:
        """Tick replica ``i`` under the failure plane: beat its heartbeat,
        count an exception out of the tick, and condemn a tick that took
        ``tick_deadline_s`` or more (its tokens still delivered: they left
        the replica before it was declared dead)."""
        s = self.replicas[i]
        toks: List[Tuple[int, int]] = []
        self._ticking = i
        if self.watchdog is not None:
            self.watchdog.beat(f"replica{i}")
        t0 = time.perf_counter()
        try:
            if self.async_host:
                toks.extend(s.collect_tick())
                s.dispatch_tick()
            else:
                toks.extend(s.step())
        except Exception as e:  # noqa: BLE001 (the fault boundary)
            self._note_failure(i, e, site="tick")
        else:
            wall = time.perf_counter() - t0
            if self.tick_deadline_s is not None and wall >= self.tick_deadline_s:
                self._condemn(i, f"tick-hang:{wall:.3f}s")
            else:
                self._note_success(i)
                if self.watchdog is not None:
                    self.watchdog.beat(f"replica{i}")
        finally:
            self._ticking = None
        return toks

    def step(self) -> List[Tuple[int, int]]:
        """One fleet tick: the re-dispatch pump, each live replica's tick
        (decode replicas first; lagged under ``async_host``), the handoff
        pump. Returns ``[(rid, token)]``."""
        if self._start_time is None:
            self._start_time = time.perf_counter()
        out: List[Tuple[int, int]] = []
        self._pump_redispatch()
        for i in self._alive(self.decode_group + self.entry_group):
            out.extend(self._run_tick(i))
        if self.decode_group:
            self._pump_handoffs()
        for rid, tok in out:
            self.results.setdefault(rid, []).append(tok)
        self._drop_retired()
        self._tick += 1
        if self._tick % 16 == 0:
            self._recommend_peak = max(self._recommend_peak, self.recommend_replicas())
        return out

    @property
    def idle(self) -> bool:
        """Nothing queued, resident, parked, uncollected or awaiting
        re-dispatch anywhere."""
        return (all(s.idle and not s.has_uncollected for s in self.replicas)
                and not self._pending_redispatch)

    def drain(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Step until idle; returns ``{rid: [tokens]}`` of every request
        that streamed (shed rids absent)."""
        for _ in range(max_steps):
            if self.idle:
                if self.host_pool is not None:
                    self.host_pool.flush()
                return dict(self.results)
            self.step()
        stuck = {f"r{i}": s.stuck_rids() for i, s in enumerate(self.replicas) if not s.idle}
        pending = sorted(e["rid"] for e in self._pending_redispatch)
        raise RuntimeError(f"fleet drain did not converge within {max_steps} steps; stuck "
                           f"rids by replica/state: {stuck}; awaiting redispatch: {pending}")

    def cancel(self, rid: int) -> bool:
        """Cancel ``rid`` on whichever replica holds it; False when none
        does (retired, shed or unknown: cancelling is idempotent)."""
        return any(s.cancel(rid) for s in self.replicas)

    def close(self) -> None:
        """Stop the host worker threads (after the work queued on them)."""
        if self.host_pool is not None:
            self.host_pool.close()

    # ---- programs ----

    def registries(self):
        """One ``compilecache.serving_registry`` a replica."""
        from pytorch_distributed_tpu_torch.compilecache import serving_registry

        return [serving_registry(s.engine, extra=(f"replica={s.replica_id}", f"role={role}"))
                for s, role in zip(self.replicas, self.roles)]

    def assert_registry_covers(self) -> None:
        """Every program every replica holds was predicted by its registry."""
        for reg, s in zip(self.registries(), self.replicas):
            reg.assert_covers(s.engine.compiled_program_names())

    def warmup(self) -> None:
        """Capture every replica's programs before traffic."""
        for s in self.replicas:
            s.warmup(background=False)

    # ---- metrics ----

    def recommend_replicas(self) -> int:
        """The autoscaler's recommendation over the entry replicas."""
        return recommend_replicas(len(self.entry_group),
                                  list(self._group_metrics(self.entry_group).values()),
                                  self.gate)

    def metrics(self) -> dict:
        """The fleet's rollup: totals, shed and spill rates, fleet-wide
        latency percentiles (each request is in one replica's series),
        handoffs, the pressure and prefix tiers, the health plane, and
        each replica's key figures (``r{i}_*``)."""
        per = [s.metrics() for s in self.replicas]
        submitted = self._next_rid
        shed = self._shed_total
        placed = submitted - shed
        elapsed = (time.perf_counter() - self._start_time
                   if self._start_time is not None else 0.0)
        tokens_out = sum(m["tokens_out"] for m in per)

        def total(key):
            return sum(m[key] for m in per)

        out: dict = {
            "replicas": len(self.replicas),
            "disaggregated": self.disaggregated,
            "async_host": self.async_host,
            "submitted": submitted,
            "shed": shed,
            "spilled": self._spilled,
            "shed_rate": shed / submitted if submitted else 0.0,
            "spill_rate": self._spilled / placed if placed else 0.0,
            "completed": total("completed"),
            "tokens_out": tokens_out,
            "tokens_per_s": tokens_out / elapsed if elapsed else 0.0,
            "handoffs": self._handoff_count,
            "preempt_routes": self._preempt_routes,
            "preempts": total("preempts"),
            "restores": total("restores"),
            "parked": total("parked"),
            "swap_bytes": total("swap_bytes"),
            "swap_aborts": total("swap_aborts"),
            "preempt_rate": total("preempts") / placed if placed else 0.0,
            "prefix_lookups": total("prefix_lookups"),
            "prefix_hits": total("prefix_hits"),
            "prefix_hit_rate": total("prefix_hits") / max(total("prefix_lookups"), 1),
            "prefix_covered_tokens": total("prefix_covered_tokens"),
            "admitted_prefill_tokens": total("admitted_prefill_tokens"),
            "prefix_cow_copies": total("prefix_cow_copies"),
            "prefix_evictions": total("prefix_evictions"),
            "prefix_shared_blocks": total("prefix_shared_blocks"),
            "affinity_sessions": len(self._affinity),
            "affinity_evictions": self._affinity_evictions,
            "results_dropped": self._results_dropped,
            "live_requests": self.live_requests(),
            "cancelled": total("cancelled"),
            "replicas_healthy": sum(1 for h in self.health if h["state"] in ROUTABLE),
            "replica_deaths": sum(h["deaths"] for h in self.health),
            "redispatched": self._redispatched,
            "redispatch_pending": len(self._pending_redispatch),
            "failed": self._failed_total,
            "deadline_misses": total("deadline_misses"),
            "deadline_sheds": self._deadline_sheds,
            "deadline_expired_redispatch": self._deadline_expired_redispatch,
            "recommended_replicas": self.recommend_replicas(),
            "recommended_replicas_peak": self._recommend_peak,
        }
        out.update(self.handoff_lat.summary("handoff"))
        for name in ("ttft", "token_lat", "queue_wait"):
            vals: List[float] = []
            for s in self.replicas:
                vals.extend(getattr(s, name).values)
            for q, v in percentiles(vals).items():
                out[f"{name}_{q}_s"] = v
        for i, m in enumerate(per):
            for k in ("tokens_out", "completed", "queue_depth", "occupancy_mean", "preempts",
                      "restores"):
                out[f"r{i}_{k}"] = m[k]
            for k in ("ttft_p95_s", "queue_wait_p95_s"):
                if k in m:
                    out[f"r{i}_{k}"] = m[k]
            out[f"r{i}_role"] = self.roles[i]
            out[f"r{i}_health"] = self.health[i]["state"]
        return out
