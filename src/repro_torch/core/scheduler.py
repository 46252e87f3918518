"""Top-level work-distribution decision process (paper Fig. 4 / Sec. 3.2).

The Scheduler receives execution requests from the Library layer and:

  1. on a **new (SCT, workload)** pair — derives a framework configuration
     ("Derive work distribution"): exact KB hit, or scattered-data
     interpolation over collected knowledge; the derived profile is
     persisted (the derivation populates the KB, acting as a cache);
  2. on a **recurrent** pair — checks whether the previous runs were
     unbalanced (lbt detector); if so, either *builds* an SCT profile from
     scratch (Algorithm 1 — only when explicitly enabled and none exists)
     or *adjusts* the current distribution with the adaptive binary search;
  3. dispatches: decomposes the data per the locality-aware plan into the
     per-slot partitions and hands the task group to the executor
     (work queues -> Task Launcher, paper Fig. 2).

The executor is pluggable — :class:`repro_torch.core.executor.ThreadedExecutor`
(real partitioned runs on this host) and
:class:`repro_torch.core.simulator.SimulatedExecutor` share the interface.

Recurrent-graph fast path
-------------------------
The paper's scheduler amortises partitioning decisions across recurrent
executions of the same compound computation.  Two layers implement that
here:

  * **whole-graph plan caching** (:class:`GraphPlanCache`) — a submitted
    :class:`~repro_torch.core.graph.JobGraph` is keyed on its structural
    signature plus the input-array shapes; a hit replays the recorded
    per-node :class:`NodePlan` (profile, slots, shares, concrete
    partitioning), so every node dispatches **without re-entering the
    locked decide phase** (zero decide/plan lock acquisitions).  The
    observe phase still runs: KB ``best_time`` refinement and lbt
    updates apply to pre-planned runs, and an unbalance trigger or any
    device-health movement invalidates the graph level so the next
    submission re-plans per node.
  * **cross-request fusion** — with ``fusion_window > 0``, *identical*
    single-node graphs (same SCT shape signature, same options)
    admitted within the window are coalesced into one wider
    partitioning: their inputs are concatenated along each vector's
    partition dimension, one fused run executes (one decide phase, one
    dispatch, one merge), and each request's
    :class:`~repro_torch.core.graph.GraphHandle` settles from a copied slice
    of the fused outputs.  Only SCTs whose kernels are oblivious to
    partition placement fuse (no SIZE/OFFSET traits, every output
    partitionable, no user merge functions, no host-side reductions),
    so fused results are bit-identical to independently-run requests —
    including under fault-injected repartition, which tiles lost unit
    ranges in domain order.

Failure semantics
-----------------
Device failure is a first-class scheduling signal, tracked by
:class:`~repro_torch.core.faults.DeviceHealth`: every scheduled run records
per-device success/failure from the executor's fault records; a device
crossing the consecutive-failure threshold is *quarantined* — ``_slots``
and ``_per_slot_shares`` rebuild without it, degrading gracefully to
CPU-only or GPU-only execution — and after a probation interval it
re-enters with a small probe share, one clean run away from full
reinstatement.  Statistics of failed runs are *excluded* from
``LoadBalancer.observe`` and from KB ``best_time`` refinement, so fault
noise cannot corrupt learned profiles; a run whose retries are exhausted
surfaces as :class:`~repro_torch.core.faults.ExecutionError` with the per-slot
fault history attached.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.autotuner import TunerParams, build_profile
from repro_torch.core.decomposition import (ConcretePartitioning, DecompositionPlan,
                                            ExecutionSlot, build_plan)
from repro_torch.core.distribution import Distribution
from repro_torch.core.executor import _produced_names, output_spec
from repro_torch.core.faults import DeviceHealth, ExecutionError
from repro_torch.core.graph import (GraphDriver, GraphHandle, JobGraph,
                                    _wrap_node_error)
from repro_torch.core.knowledge_base import (KnowledgeBase, Origin, PlatformConfig,
                                             Profile)
from repro_torch.core.load_balancer import ExecutionStats, LoadBalancer, class_times
from repro_torch.core.platforms import AcceleratorPlatform, HostPlatform
from repro_torch.core.skeletons import SCT
from repro_torch.core.spec import Trait, Workload
from repro_torch.core.telemetry import NULL_TELEMETRY, Telemetry


@dataclasses.dataclass
class ScheduledRun:
    """Outcome of one scheduled execution."""

    outputs: Dict[str, Any]
    stats: ExecutionStats
    profile: Profile
    action: str     # "exact" | "derived" | "built" | "adjusted" | "reused"
                    #   | "preplanned" | "fused"
    resident_handle: Optional[Any] = None   # slot-resident outputs, if kept
    node_plan: Optional["NodePlan"] = None  # the plan this run executed under

    def detach(self) -> "ScheduledRun":
        """Deep-copy the outputs out of the executor's reusable merge
        buffers, so they survive subsequent runs on the same executor
        (the documented output-aliasing footgun).  Returns ``self``."""
        self.outputs = {k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in self.outputs.items()}
        return self


@dataclasses.dataclass(frozen=True)
class NodePlan:
    """Replayable outcome of the decide + plan phases for one node.

    Recorded on every dispatch; a :class:`GraphPlanCache` hit replays
    these verbatim through ``Scheduler.run``'s pre-planned fast path.
    Valid only while the device-health version it was recorded under
    still holds — a stale plan silently falls back to ordinary
    planning."""

    profile: Profile
    slots: Tuple[ExecutionSlot, ...]
    shares: Tuple[float, ...]
    part: ConcretePartitioning
    health_version: int


@dataclasses.dataclass(frozen=True)
class GraphPlan:
    """One whole-graph cache entry: node plans in topological order."""

    node_plans: Tuple[NodePlan, ...]
    health_version: int
    epoch: int                  # plan-cache epoch the plans were recorded in


@dataclasses.dataclass
class _FusionMember:
    """One request riding in a fusion batch (a single-node graph)."""

    arrays: Dict[str, Any]
    handle: GraphHandle
    node: str
    sct: SCT


class _FusionBatch:
    """One open fusion window: identical single-node requests
    accumulating until the window timer fires or ``fusion_max``
    members have joined."""

    def __init__(self, key: Tuple, options: Tuple):
        self.key = key
        self.options = options          # (deadline, retries, retry_backoff)
        self.members: List[_FusionMember] = []
        self.timer: Optional[threading.Timer] = None
        self.closed = False


class GraphPlanCache:
    """Plan / partitioning / graph-plan cache for recurrent dispatches.

    Three levels, mirroring the costs on the dispatch path:

      * decomposition plans, keyed by ``(sct_id, input shapes)`` — the
        expensive ``build_plan`` constraint derivation;
      * concrete partitionings, keyed by the full
        ``(sct_id, input shapes, slot signature, shares)`` tuple — the
        quantised largest-remainder allocation;
      * whole-graph plans (:class:`GraphPlan`), keyed by
        ``(JobGraph.signature(), input shapes/dtypes)`` — the complete
        topo-ordered decide+plan outcome of one clean graph execution,
        replayed on recurrent submissions so not a single node
        re-enters the locked decide phase.

    The slot signature covers device identity, class and per-kernel wgs,
    and the share vector is part of the key, so any slot-set or
    distribution change self-invalidates by missing.  ``invalidate`` is
    additionally called *explicitly* by the Scheduler whenever the
    device-health version moves (quarantine / probation / reinstatement)
    or a run adjusts the distribution (``adjusted`` / ``built``
    actions), so stale entries are dropped rather than merely bypassed;
    graph-level entries are dropped on the same signals (plus an lbt
    trigger observed on a pre-planned run), and each entry additionally
    carries the device-health version it was recorded under.

    Thread-safe: lookups and mutations serialise on an internal lock
    (plan construction itself runs outside it — it is pure).
    """

    def __init__(self, *, enabled: bool = True, capacity: int = 64):
        self.enabled = enabled
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.graph_hits = 0
        self.graph_misses = 0
        self.telemetry: Telemetry = NULL_TELEMETRY
        self._lock = threading.Lock()
        self._plans: Dict[Tuple, DecompositionPlan] = {}
        self._parts: Dict[Tuple, ConcretePartitioning] = {}
        self._graphs: Dict[Tuple, GraphPlan] = {}

    # -- key components -----------------------------------------------------
    @staticmethod
    def shapes_sig(shapes: Dict[str, Tuple[int, ...]]) -> Tuple:
        return tuple(sorted((k, tuple(int(d) for d in v))
                            for k, v in shapes.items()))

    @staticmethod
    def slot_sig(slots: Sequence[ExecutionSlot]) -> Tuple:
        return tuple((s.device, s.device_type, tuple(sorted(s.wgs.items())))
                     for s in slots)

    @staticmethod
    def share_sig(shares: Sequence[float]) -> Tuple:
        return tuple(round(float(s), 12) for s in shares)

    # -- cache operations ----------------------------------------------------
    def partition(self, sct: SCT, shapes: Dict[str, Tuple[int, ...]],
                  slots: Sequence[ExecutionSlot], shares: Sequence[float]
                  ) -> Tuple[ConcretePartitioning, bool]:
        """Cached equivalent of ``build_plan(...).partition(...)``.

        Returns ``(partitioning, hit)``; with caching disabled this is
        exactly the uncached dispatch path.
        """
        if not self.enabled:
            return build_plan(sct, shapes).partition(slots, shares), False
        key = (sct.unique_id(), self.shapes_sig(shapes),
               self.slot_sig(slots), self.share_sig(shares))
        with self._lock:
            part = self._parts.get(key)
            if part is not None:
                self.hits += 1
                return part, True
            self.misses += 1
        plan = self.plan_for(sct, shapes)
        part = plan.partition(slots, shares)
        with self._lock:
            self._put(self._parts, key, part)
        return part, False

    def plan_for(self, sct: SCT,
                 shapes: Dict[str, Tuple[int, ...]]) -> DecompositionPlan:
        """Cached ``build_plan`` (no partitioning) — shared by the
        dispatch path and cross-request fusion's concatenated-input
        planning.  Does not touch the hit/miss counters."""
        if not self.enabled:
            return build_plan(sct, shapes)
        pkey = (sct.unique_id(), self.shapes_sig(shapes))
        with self._lock:
            plan = self._plans.get(pkey)
        if plan is None:
            plan = build_plan(sct, shapes)
            with self._lock:
                self._put(self._plans, pkey, plan)
        return plan

    # -- graph level ---------------------------------------------------------
    def graph_get(self, key: Tuple,
                  health_version: int) -> Optional[GraphPlan]:
        """Whole-graph lookup; drops (and misses on) entries recorded
        under a different device-health version."""
        if not self.enabled:
            return None
        with self._lock:
            gp = self._graphs.get(key)
            if gp is not None and gp.health_version != health_version:
                del self._graphs[key]
                gp = None
            if gp is not None:
                self.graph_hits += 1
            else:
                self.graph_misses += 1
            return gp

    def graph_put(self, key: Tuple, plan: GraphPlan) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._put(self._graphs, key, plan)

    def credit_graph_hit(self) -> None:
        """Count one pre-planned node dispatch as a plan-cache hit.

        Keeps ``hit_rate`` consistent with the per-run
        ``plan_cache_{hits,misses}_total`` metrics: every scheduled run
        increments exactly one of the two, whichever level served it."""
        with self._lock:
            self.hits += 1

    def _put(self, store: Dict, key: Tuple, value) -> None:
        if len(store) >= self.capacity:        # FIFO bound: drop the oldest
            store.pop(next(iter(store)))
        store[key] = value

    def invalidate(self, reason: str = "") -> None:
        """Drop every cached plan/partitioning/graph plan (slot set or
        shares moved)."""
        with self._lock:
            self.invalidations += 1
            self._plans.clear()
            self._parts.clear()
            had_graphs = bool(self._graphs)
            self._graphs.clear()
        self.telemetry.metrics.counter("plan_cache_invalidations_total").inc()
        if had_graphs:
            self.telemetry.metrics.counter(
                "graph_plan_cache_invalidations_total").inc()
        self.telemetry.events.emit("plan_cache.invalidated", reason=reason)

    def invalidate_graphs(self, reason: str = "") -> None:
        """Drop the graph level only (e.g. lbt trigger: the recorded
        distribution is stale, but per-node plans keyed on explicit
        shares remain valid)."""
        with self._lock:
            if not self._graphs:
                return
            self._graphs.clear()
        self.telemetry.metrics.counter(
            "graph_plan_cache_invalidations_total").inc()
        self.telemetry.events.emit("plan_cache.graphs_invalidated",
                                   reason=reason)

    @property
    def epoch(self) -> int:
        """Monotone invalidation epoch: a recorded plan is only stored
        if the epoch did not move while its graph was in flight."""
        return self.invalidations

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def counters(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "invalidations": self.invalidations,
                "hit_rate": self.hit_rate,
                "graph_hits": self.graph_hits,
                "graph_misses": self.graph_misses}


#: Backwards-compatible alias — the two-level cache grew a graph level.
PlanCache = GraphPlanCache


class Scheduler:
    def __init__(self, *, host: HostPlatform, accel: AcceleratorPlatform,
                 executor, kb: Optional[KnowledgeBase] = None,
                 balancer: Optional[LoadBalancer] = None,
                 allow_profile_build: bool = False,
                 tuner_params: TunerParams = TunerParams(),
                 default_share_a: float = 0.8,
                 health: Optional[DeviceHealth] = None,
                 plan_cache: bool = True,
                 telemetry: Optional[Telemetry] = None,
                 max_inflight: int = 4,
                 graph_workers: int = 8,
                 fusion_window: float = 0.0,
                 fusion_max: int = 8):
        self.host = host
        self.accel = accel
        self.executor = executor
        self.kb = kb if kb is not None else KnowledgeBase()
        self.balancer = balancer if balancer is not None else LoadBalancer()
        self.allow_profile_build = allow_profile_build
        self.tuner_params = tuner_params
        self.default_share_a = default_share_a
        self.health = health if health is not None else DeviceHealth()
        self.plan_cache = PlanCache(enabled=plan_cache)
        self._health_seen = self.health.version
        self._last_key: Optional[Tuple[str, str]] = None
        self._current: Optional[Profile] = None
        self._last_slots: List[ExecutionSlot] = []
        self._last_class_times: Tuple[float, float] = (0.0, 0.0)
        self._counts = {"runs": 0, "failed_runs": 0, "retries": 0,
                        "resident_handoffs": 0, "graphs": 0,
                        "decide_locks": 0, "plan_locks": 0,
                        "fused_requests": 0, "fused_batches": 0}
        # decision/observation state is shared by concurrent graph nodes;
        # RLock because the autotuner evaluator re-enters _dispatch
        self._lock = threading.RLock()
        # the plan phase has its own lock: concurrent nodes planning
        # never queue behind another node's decide/observe phase, and a
        # pre-planned dispatch acquires neither lock
        self._plan_lock = threading.Lock()
        # graph admission: FIFO queue, at most max_inflight graphs live
        self.max_inflight = max_inflight
        self.graph_workers = graph_workers
        self._graph_lock = threading.Lock()
        self._admission: "collections.deque[GraphDriver]" = \
            collections.deque()
        self._running: set = set()
        self._graph_seq = 0
        self._graph_pool_obj: Optional[cf.ThreadPoolExecutor] = None
        self._virtual_busy: Dict[str, float] = {}   # virtual-clock queues
        # cross-request fusion (admission-side; off unless a window is set)
        self.fusion_window = float(fusion_window)
        self.fusion_max = int(fusion_max)
        self._fusion_lock = threading.Lock()
        self._fusion_batches: Dict[Tuple, _FusionBatch] = {}
        self._fusion_sct_ok: Dict[str, bool] = {}   # static eligibility memo
        self._closed = False
        self.telemetry = NULL_TELEMETRY
        self.attach_telemetry(telemetry or NULL_TELEMETRY)

    def attach_telemetry(self, telemetry: Telemetry) -> None:
        """Share one telemetry bundle across the whole pipeline.

        Propagated to the plan cache, the executor, the device-health
        tracker and the load balancer, so spans, metrics and events
        from every layer land in a single trace/registry."""
        self.telemetry = telemetry
        self.plan_cache.telemetry = telemetry
        self.health.telemetry = telemetry
        self.balancer.telemetry = telemetry
        if hasattr(self.executor, "telemetry"):
            self.executor.telemetry = telemetry

    # ------------------------------------------------------------------
    def run(self, sct: SCT, arrays: Dict[str, Any],
            workload: Optional[Workload] = None, *,
            _resident=None, _keep_resident: bool = False,
            _plan: Optional[NodePlan] = None) -> ScheduledRun:
        """One scheduled execution.  Thread-safe: the decision and
        observation phases serialise on the scheduler lock; the execute
        phase runs unlocked, so independent graph nodes overlap on the
        executor's per-device work queues.

        ``_plan`` (internal — a :class:`NodePlan` from a
        :class:`GraphPlanCache` hit) replays a recorded decision
        verbatim: both the locked decide phase and the locked plan
        phase are skipped entirely.  A stale plan (the device-health
        version moved since it was recorded) falls back to ordinary
        planning.  The observation phase runs either way, so KB
        ``best_time`` refinement and lbt updates see pre-planned runs
        too."""
        plan: Optional[NodePlan] = None
        if (_plan is not None and self.plan_cache.enabled
                and _plan.health_version == self.health.version):
            plan = _plan
        key: Optional[Tuple[str, str]] = None
        if plan is None:
            shapes = _resident.shapes() if _resident is not None else None
            workload = workload or infer_workload(sct, arrays, shapes=shapes)
            key = (sct.unique_id(), workload.key())

        tel = self.telemetry
        wl = str(workload.key()) if workload is not None else "preplanned"
        with tel.tracer.span("run", sct=sct.unique_id(),
                             workload=wl) as run_span:
            if plan is None:
                with self._lock:        # decision phase (Fig. 4)
                    self._counts["decide_locks"] += 1
                    if key != self._last_key or self._current is None:
                        profile, action = self._derive(sct, workload)
                    else:
                        profile, action = self._recurrent(sct, workload)
                    self._last_key, self._current = key, profile
                    run_span.note(action=action)
                    tel.metrics.counter("scheduler_actions_total",
                                        action=action).inc()

                    # explicit plan-cache invalidation: distribution
                    # adjusted, profile rebuilt, or the device-health state
                    # (quarantine / probation / reinstatement) moved since
                    # the entries were created
                    if action in ("adjusted", "built"):
                        self.plan_cache.invalidate("share adjustment")
                    if self.health.version != self._health_seen:
                        self.plan_cache.invalidate("device-health change")
                        self._health_seen = self.health.version

                    self.health.tick()
            else:
                # pre-planned fast path: zero decide/plan lock round trips
                profile, action = plan.profile, "preplanned"
                self.plan_cache.credit_graph_hit()
                run_span.note(action=action)
                tel.metrics.counter("scheduler_actions_total",
                                    action=action).inc()
                self.health.tick()      # DeviceHealth has its own lock
            try:
                outputs, stats, slots, resident_handle, node_plan = \
                    self._dispatch(
                        sct, arrays, profile, resident=_resident,
                        keep_resident=_keep_resident, plan=plan)
            except ExecutionError as e:
                # terminal failure: still feed the health tracker, so repeat
                # offenders get quarantined even when no run ever completes
                # — and never touch the balancer / KB / _last_slots, so a
                # failed run cannot pollute learned state
                with self._lock:
                    for base in {r.device_base for r in e.records}:
                        self.health.record_failure(base)
                    self._counts["runs"] += 1
                    self._counts["failed_runs"] += 1
                tel.metrics.counter("runs_total", status="error").inc()
                tel.events.emit("run.error", level="error",
                                message=str(e), sct=sct.unique_id(),
                                attempts=e.attempts)
                raise
            with self._lock:        # observation phase (Monitor)
                self._last_slots = list(slots)
                self._observe_health(stats)
                self._record_run_metrics(sct, stats, slots)

                # update detector; persist best-known configurations.
                # Failed runs are excluded — their times mix real compute
                # with retry noise and would corrupt the lbt detector and
                # KB profiles.
                if stats.ok:
                    trigger = self.balancer.observe(stats)
                    if not trigger:
                        self.balancer.balanced_again()
                    else:
                        # unbalance detected: recorded whole-graph plans
                        # embed the now-suspect distribution — drop them
                        # so the next submission re-plans per node
                        self.plan_cache.invalidate_graphs("lbt trigger")
                    self._last_class_times = (stats.time_a, stats.time_b)
                    if stats.total < profile.best_time:
                        profile = dataclasses.replace(profile,
                                                      best_time=stats.total)
                        self.kb.store(profile)
                        if key is not None and self._last_key == key:
                            self._current = profile
            return ScheduledRun(outputs=outputs, stats=stats,
                                profile=profile, action=action,
                                resident_handle=resident_handle,
                                node_plan=node_plan)

    def _record_run_metrics(self, sct: SCT, stats: ExecutionStats,
                            slots: Sequence[ExecutionSlot]) -> None:
        """Fold one completed run into counters / metrics / events."""
        tel = self.telemetry
        self._counts["runs"] += 1
        self._counts["retries"] += stats.retries
        if not stats.ok:
            self._counts["failed_runs"] += 1
        if stats.resident:
            self._counts["resident_handoffs"] += 1
        tel.metrics.counter("runs_total",
                            status="ok" if stats.ok else "faulted").inc()
        if stats.retries:
            tel.metrics.counter("retries_total").inc(stats.retries)
            tel.metrics.counter("repartitions_total").inc(stats.retries)
        tel.metrics.counter(
            "plan_cache_hits_total" if stats.plan_cache_hit
            else "plan_cache_misses_total").inc()
        if stats.resident:
            tel.metrics.counter("resident_handoffs_total").inc()
        tel.metrics.counter("merge_bytes_total").inc(stats.merge_bytes)
        tel.metrics.histogram("class_makespan_seconds",
                              cls="a").observe(stats.time_a)
        tel.metrics.histogram("class_makespan_seconds",
                              cls="b").observe(stats.time_b)
        tel.metrics.histogram("overhead_seconds").observe(
            stats.overhead_seconds)
        for slot, t in zip(slots, stats.times):
            tel.metrics.counter("device_busy_seconds_total",
                                device=slot.device.split("/")[0]).inc(t)

    def counters(self) -> Dict[str, float]:
        """One namespaced counter dict across the whole pipeline.

        Folds the plan-cache numbers together with scheduler run/retry
        counts, executor pool reuse and resident handoffs (re-exported
        through :meth:`Session.counters`)."""
        out: Dict[str, float] = {
            f"plan_cache.{k}": v
            for k, v in self.plan_cache.counters().items()}
        with self._lock:
            for k, v in self._counts.items():
                out[f"scheduler.{k}"] = v
        ex = self.executor
        out["executor.pools_created"] = getattr(ex, "pools_created", 0)
        out["executor.pool_reuses"] = getattr(ex, "pool_reuses", 0)
        out["health.quarantined"] = len(self.health.quarantined())
        out["balancer.balance_ops"] = self.balancer.balance_ops
        out["balancer.unbalanced_runs"] = self.balancer.unbalanced_runs
        return out

    def run_chain(self, scts: Sequence[SCT], arrays: Dict[str, Any]
                  ) -> List[ScheduledRun]:
        """Run a compound SCT chain with partitioned residency.

        Each step's slot-local outputs are handed straight to the next
        step (``ResidentPartition``), skipping the merge→re-split round
        trip as long as consecutive steps share the domain decomposition;
        on any mismatch — or on an executor without residency support —
        the handle materialises and the step runs on the ordinary merged
        path.  The final step always merges, so the last
        :class:`ScheduledRun` carries the chain's outputs.  Intermediate
        results that stayed resident are *not* merged back into the
        caller's environment (that is the optimisation).
        """
        supports = bool(getattr(self.executor, "supports_residency", False))
        env = dict(arrays)
        resident = None
        runs: List[ScheduledRun] = []
        for i, sct in enumerate(scts):
            keep = supports and i < len(scts) - 1
            r = self.run(sct, env, _resident=resident,
                         _keep_resident=keep)
            resident = r.resident_handle if keep else None
            if r.outputs:               # merged (final or fallback) results
                env.update(r.outputs)
            runs.append(r)
        return runs

    # -- graph pipeline -------------------------------------------------------
    def submit(self, graph: JobGraph, arrays: Dict[str, Any], *,
               deadline: Optional[float] = None, retries: int = 0,
               retry_backoff: float = 0.05) -> GraphHandle:
        """Admit one JobGraph for execution; returns its handle.

        On the threaded executor the graph enters a FIFO admission queue
        (at most ``max_inflight`` graphs execute at once) and its
        dependency-free nodes start on the node pool immediately after
        admission; nodes on disjoint device slots genuinely overlap.  On
        a virtual-clock executor (``SimulatedExecutor``) the graph runs
        inline, deterministically, on the simulated timeline — the
        handle is already settled when this returns.

        ``deadline`` / ``retries`` / ``retry_backoff`` apply per node,
        with the whole-graph ``deadline`` budget shared across nodes.

        Recurrent submissions take two fast paths: a
        :class:`GraphPlanCache` hit pre-plans every node up front (zero
        decide/plan lock acquisitions while the graph runs), and —
        with ``fusion_window > 0`` — identical single-node graphs
        admitted within the window coalesce into one fused run (module
        docstring).  Both settle the returned handle exactly as the
        ordinary path does."""
        graph.validate()
        tel = self.telemetry
        virtual = bool(getattr(self.executor, "virtual_clock", False))
        if not virtual:
            fused = self._try_fuse(graph, arrays, deadline=deadline,
                                   retries=retries,
                                   retry_backoff=retry_backoff)
            if fused is not None:
                return fused
        with self._graph_lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self._graph_seq += 1
            rid = f"g{self._graph_seq}"
        handle = GraphHandle(graph, rid)
        preplanned, plan_key, plan_epoch = \
            self._graph_plan_lookup(graph, arrays)
        driver = GraphDriver(self, handle, arrays, deadline=deadline,
                             retries=retries, retry_backoff=retry_backoff,
                             preplanned=preplanned, plan_key=plan_key,
                             plan_epoch=plan_epoch)
        with self._lock:
            self._counts["graphs"] += 1
        tel.metrics.counter("graph_nodes_total").inc(len(graph))
        tel.events.emit("graph.submitted", request=rid, nodes=len(graph))
        if virtual:
            driver.run_virtual()
            return handle
        with self._graph_lock:
            self._admission.append(driver)
            started = self._pump_locked()
        for d in started:
            d.start()
        return handle

    # -- whole-graph plan cache ----------------------------------------------
    def _graph_plan_lookup(self, graph: JobGraph, arrays: Dict[str, Any]
                           ) -> Tuple[Optional[List[NodePlan]],
                                      Optional[Tuple], int]:
        """(pre-planned node plans, miss key to record under, epoch)."""
        pc = self.plan_cache
        if not pc.enabled:
            return None, None, 0
        key = (graph.signature(), _array_sig(arrays))
        gp = pc.graph_get(key, self.health.version)
        tel = self.telemetry
        if gp is not None:
            tel.metrics.counter("graph_plan_cache_hits_total").inc()
            tel.events.emit("graph_plan_cache.hit", nodes=len(graph))
            return list(gp.node_plans), None, gp.epoch
        tel.metrics.counter("graph_plan_cache_misses_total").inc()
        return None, key, pc.epoch

    def _graph_plan_record(self, driver: GraphDriver) -> None:
        """Record a cleanly completed graph's per-node plans (miss path;
        called by ``GraphDriver._finalize``).

        Skipped when anything moved while the graph was in flight — a
        plan-cache invalidation (distribution adjustment), a
        device-health transition, or any node that faulted/retried:
        recording those would replay a decision the scheduler has
        already walked away from."""
        key = getattr(driver, "plan_key", None)
        pc = self.plan_cache
        if key is None or not pc.enabled or pc.epoch != driver.plan_epoch:
            return
        hv = self.health.version
        plans: List[NodePlan] = []
        for name in driver.graph.topo_order():
            run = driver.handle.runs.get(name)
            np_ = getattr(run, "node_plan", None)
            if np_ is None or not run.stats.ok or run.stats.retries:
                return
            if np_.health_version != hv:
                return
            plans.append(np_)
        pc.graph_put(key, GraphPlan(node_plans=tuple(plans),
                                    health_version=hv,
                                    epoch=driver.plan_epoch))

    # -- cross-request fusion ------------------------------------------------
    def _try_fuse(self, graph: JobGraph, arrays: Dict[str, Any], *,
                  deadline: Optional[float], retries: int,
                  retry_backoff: float) -> Optional[GraphHandle]:
        """Admission-side fusion of identical single-node graphs.

        Returns a handle when the request joined a fusion batch, else
        ``None`` (ordinary admission).  The handle settles when its
        batch flushes — after ``fusion_window`` seconds, or immediately
        once ``fusion_max`` members have joined."""
        if self.fusion_window <= 0 or len(graph) != 1:
            return None
        node = graph.nodes[0]
        options = (deadline, int(retries), float(retry_backoff))
        key = self._fusion_key(node.sct, arrays, options)
        if key is None:
            return None
        with self._graph_lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            self._graph_seq += 1
            rid = f"g{self._graph_seq}"
        handle = GraphHandle(graph, rid)
        with self._lock:
            self._counts["graphs"] += 1
        tel = self.telemetry
        tel.metrics.counter("graph_nodes_total").inc(1)
        tel.events.emit("graph.submitted", request=rid, nodes=1)
        flush: Optional[_FusionBatch] = None
        with self._fusion_lock:
            batch = self._fusion_batches.get(key)
            if batch is None:
                batch = _FusionBatch(key, options)
                self._fusion_batches[key] = batch
                timer = threading.Timer(self.fusion_window,
                                        self._flush_batch, args=(batch,))
                timer.daemon = True
                batch.timer = timer
                timer.start()
            batch.members.append(_FusionMember(arrays=dict(arrays),
                                               handle=handle,
                                               node=node.name,
                                               sct=node.sct))
            if len(batch.members) >= self.fusion_max:
                flush = self._close_batch_locked(batch)
        if flush is not None:
            self._enqueue_fused(flush)
        return handle

    def _fusion_key(self, sct: SCT, arrays: Dict[str, Any],
                    options: Tuple) -> Optional[Tuple]:
        """Fusion identity of a request, or ``None`` when it must not
        fuse.  Covers the SCT (structural id), every vector's
        shape+dtype, every scalar's *value* (scalars broadcast across
        the fused domain, so differing values must not coalesce) and
        the request options."""
        sid = sct.unique_id()
        ok = self._fusion_sct_ok.get(sid)
        if ok is None:
            ok = self._fusion_eligible(sct)
            self._fusion_sct_ok[sid] = ok
        if not ok:
            return None
        names = set()
        parts: List[Tuple] = []
        for a in sct.free_inputs():
            names.add(a.name)
            v = arrays.get(a.name)
            if a.kind == "scalar":
                try:
                    parts.append((a.name, "s", float(v)))
                except (TypeError, ValueError):
                    return None
                continue
            if not a.partitionable:
                return None     # COPY input: replicated, values unproven
            if v is None or getattr(v, "ndim", 0) < 1:
                return None
            parts.append((a.name, "v",
                          tuple(int(d) for d in v.shape),
                          str(getattr(v, "dtype", ""))))
        if any(k not in names for k in arrays):
            return None         # undeclared extra inputs: safe path
        return (sid, tuple(parts), options)

    def _fusion_eligible(self, sct: SCT) -> bool:
        """Static fusibility of an SCT: every kernel oblivious to
        partition placement, every output partitionable.

        SIZE/OFFSET-trait scalars see different values under a fused
        (wider) domain; non-PARTITION outputs, host-side reductions and
        user merge functions combine globally (possibly non-linearly).
        Any of these would break the output-slicing guarantee, so such
        SCTs never fuse."""
        for spec in sct.kernel_specs():
            for a in spec.inputs:
                if a.trait is not Trait.NONE:
                    return False
            for a in spec.outputs:
                if not a.partitionable:
                    return False
        from repro_torch.core.skeletons import MapReduce
        stack: List[SCT] = [sct]
        while stack:
            n = stack.pop()
            if isinstance(n, MapReduce) and n.host_side_reduction:
                return False
            stack.extend(n.children())
        merges = getattr(self.executor, "merges", None) or {}
        if merges:
            if any(name in merges for name in _produced_names(sct)):
                return False
        return True

    def _close_batch_locked(self, batch: _FusionBatch) -> _FusionBatch:
        """Caller holds ``_fusion_lock``."""
        batch.closed = True
        if batch.timer is not None:
            batch.timer.cancel()
        self._fusion_batches.pop(batch.key, None)
        return batch

    def _flush_batch(self, batch: _FusionBatch) -> None:
        """Window expired (timer thread): move the batch to admission."""
        with self._fusion_lock:
            if batch.closed:
                return
            self._close_batch_locked(batch)
        self._enqueue_fused(batch)

    def _flush_open_batches(self) -> None:
        """Flush every open batch immediately (drain path)."""
        with self._fusion_lock:
            open_ = [b for b in self._fusion_batches.values()
                     if not b.closed]
            for b in open_:
                self._close_batch_locked(b)
        for b in open_:
            self._enqueue_fused(b)

    def _enqueue_fused(self, batch: _FusionBatch) -> None:
        driver = _FusedDriver(self, batch)
        with self._graph_lock:
            self._admission.append(driver)
            started = self._pump_locked()
        for d in started:
            d.start()

    def _run_fused(self, batch: _FusionBatch) -> None:
        """Execute one flushed batch: one fused run (one decide phase,
        one dispatch, one merge), each member settled from a copied
        slice of the fused outputs.  Falls back to per-member runs when
        the batch has a single member or concatenation fails."""
        members = batch.members
        deadline, retries, backoff = batch.options
        tel = self.telemetry
        epoch = time.perf_counter()

        def now_us() -> float:
            return (time.perf_counter() - epoch) * 1e6

        fused = self._fuse_arrays(members) if len(members) > 1 else None
        if fused is None:
            for m in members:
                start = now_us()
                try:
                    run = self._request_with_retries(
                        m.sct, m.arrays, deadline=deadline,
                        retries=retries, backoff=backoff)
                except BaseException as e:
                    self._settle_member(m, error=e, span=(start, now_us()))
                else:
                    self._settle_member(m, run=run, span=(start, now_us()))
            return
        fused_arrays, slicers = fused
        with self._lock:
            self._counts["fused_batches"] += 1
            self._counts["fused_requests"] += len(members)
        tel.metrics.counter("fused_batches_total").inc()
        tel.metrics.counter("fused_requests_total").inc(len(members))
        tel.events.emit("graph.fused", batch=len(members),
                        requests=[m.handle.request_id for m in members])
        start = now_us()
        try:
            run = self._request_with_retries(
                members[0].sct, fused_arrays, deadline=deadline,
                retries=retries, backoff=backoff)
        except BaseException as e:
            end = now_us()
            for m in members:
                self._settle_member(m, error=e, span=(start, end))
            return
        end = now_us()
        for i, m in enumerate(members):
            outs: Dict[str, Any] = {}
            for oname, arr in run.outputs.items():
                sl = slicers.get(oname)
                if sl is None or not isinstance(arr, torch.Tensor):
                    outs[oname] = arr
                    continue
                axis, per = sl
                idx = [slice(None)] * arr.ndim
                idx[axis] = slice(i * per, (i + 1) * per)
                outs[oname] = arr[tuple(idx)].clone()
            sub = ScheduledRun(outputs=outs, stats=run.stats,
                               profile=run.profile, action="fused")
            self._settle_member(m, run=sub, span=(start, end))

    def _fuse_arrays(self, members: List[_FusionMember]
                     ) -> Optional[Tuple[Dict[str, Any],
                                         Dict[str, Tuple[int, int]]]]:
        """Concatenate member inputs along each vector's partition dim.

        Returns ``(fused arrays, output slicers)`` or ``None`` when a
        plan constraint fails (the caller falls back to individual
        runs).  ``slicers[name] = (axis, extent-per-member)`` for every
        produced output; eligibility already guaranteed every output
        partitionable, so slicing the fused result along its partition
        dim reproduces each member's independent output."""
        sct = members[0].sct
        first = members[0].arrays
        shapes = {k: tuple(getattr(v, "shape", ()))
                  for k, v in first.items()}
        try:
            plan = self.plan_cache.plan_for(sct, shapes)
        except Exception:
            return None
        units = plan.domain_units
        if units <= 0:
            return None
        fused: Dict[str, Any] = {}
        for a in sct.free_inputs():
            if a.kind == "scalar":
                if a.name in first:
                    fused[a.name] = first[a.name]
                continue
            vp = plan.vectors.get(a.name)
            if vp is None or vp.copy:
                return None
            try:
                fused[a.name] = torch.cat(
                    [torch.as_tensor(m.arrays[a.name]) for m in members],
                    dim=vp.partition_dim)
            except (RuntimeError, TypeError, ValueError):
                return None
        slicers: Dict[str, Tuple[int, int]] = {}
        for oname in _produced_names(sct):
            spec = output_spec(sct, oname)
            if spec is None or not spec.partitionable:
                return None     # unreachable: eligibility filtered these
            slicers[oname] = (spec.partition_dim, units * spec.epu)
        return fused, slicers

    def _request_with_retries(self, sct: SCT, arrays: Dict[str, Any], *,
                              deadline: Optional[float], retries: int,
                              backoff: float) -> ScheduledRun:
        """Per-request retry loop around :meth:`run` (fused path) —
        same deadline-capped exponential backoff as ``GraphDriver``."""
        t0 = time.monotonic()
        last: Optional[ExecutionError] = None
        for k in range(retries + 1):
            if deadline is not None and time.monotonic() - t0 > deadline:
                raise ExecutionError(
                    f"request deadline {deadline}s exceeded after "
                    f"{k} attempts", getattr(last, "records", []), k)
            try:
                return self.run(sct, arrays)
            except ExecutionError as e:
                last = e
                if k == retries or not getattr(e, "retryable", True):
                    raise
                pause = backoff * (2 ** k)
                if deadline is not None:
                    remaining = deadline - (time.monotonic() - t0)
                    if remaining <= 0:
                        raise ExecutionError(
                            f"request deadline {deadline}s exceeded after "
                            f"{k + 1} attempts", e.records, k + 1)
                    pause = min(pause, remaining)
                if pause > 0:
                    time.sleep(pause)
        raise last  # pragma: no cover — loop always returns or raises

    def _settle_member(self, member: _FusionMember, *,
                       run: Optional[ScheduledRun] = None,
                       error: Optional[BaseException] = None,
                       span: Tuple[float, float] = (0.0, 0.0)) -> None:
        """Settle one fused request's (single-node) handle."""
        handle, name = member.handle, member.node
        tel = self.telemetry
        if error is not None:
            with handle._lock:
                handle._state[name] = "failed"
                handle._spans[name] = span
            tel.metrics.counter("graph_nodes_failed_total").inc()
            tel.metrics.counter("graphs_total", status="error").inc()
            tel.events.emit("graph.node_failed", level="error",
                            request=handle.request_id, node=name,
                            message=str(error))
            handle._finish(_wrap_node_error(name, error))
            return
        handle.runs[name] = run
        with handle._lock:
            handle._state[name] = "done"
            handle._spans[name] = span
        tel.metrics.counter("graphs_total", status="ok").inc()
        tel.events.emit("graph.done", request=handle.request_id, failed=0)
        handle._finish(None)

    def _pump_locked(self) -> List[GraphDriver]:
        """Admit queued graphs up to ``max_inflight``; caller holds
        ``_graph_lock`` and must ``start()`` the returned drivers."""
        started: List[GraphDriver] = []
        while self._admission and len(self._running) < self.max_inflight:
            d = self._admission.popleft()
            self._running.add(d)
            started.append(d)
        return started

    def _graph_done(self, driver: GraphDriver) -> None:
        """Completion callback from a GraphDriver: admit the next graph."""
        with self._graph_lock:
            self._running.discard(driver)
            started = self._pump_locked()
        for d in started:
            d.start()

    def _graph_pool(self) -> cf.ThreadPoolExecutor:
        """Lazily created node pool shared by every admitted graph."""
        with self._graph_lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if self._graph_pool_obj is None:
                self._graph_pool_obj = cf.ThreadPoolExecutor(
                    max_workers=self.graph_workers,
                    thread_name_prefix="graph-node")
            return self._graph_pool_obj

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted graph settles (or ``timeout``
        seconds elapse); returns True when fully drained.  Open fusion
        batches flush immediately rather than waiting out their
        window."""
        t0 = time.monotonic()
        while True:
            self._flush_open_batches()
            with self._graph_lock:
                live = list(self._running) + list(self._admission)
            if not live:
                return True
            if timeout is not None and time.monotonic() - t0 > timeout:
                return False
            live[0].handle.wait(0.05)

    def close(self) -> None:
        """Drain in-flight graphs, stop admission, release the node pool
        and the executor's resources.  Idempotent."""
        self.drain()
        with self._graph_lock:
            self._closed = True
            pool, self._graph_pool_obj = self._graph_pool_obj, None
        if pool is not None:
            pool.shutdown(wait=True)
        close = getattr(self.executor, "close", None)
        if close is not None:
            close()

    def _observe_health(self, stats) -> None:
        """Feed per-device success/failure of one run into the tracker."""
        failed = {r.device_base for r in stats.failures}
        participated = {s.device.split("/")[0] for s in self._last_slots}
        for base in participated - failed:
            self.health.record_success(base)
        for base in failed:
            self.health.record_failure(base)

    # ------------------------------------------------------------------
    def _derive(self, sct: SCT, workload: Workload) -> Tuple[Profile, str]:
        exact = self.kb.exact(sct.unique_id(), workload)
        if exact is not None:
            return exact, "exact"
        derived = self.kb.derive(sct.unique_id(), workload)
        if derived is not None:
            self.kb.store(derived)
            return derived, "derived"
        # empty KB: assume-good default, to be refined online (paper: the KB
        # is assumed sufficient; adjustments correct over-optimism)
        p = Profile(sct_id=sct.unique_id(), workload=workload,
                    share_a=self.default_share_a, config=PlatformConfig(),
                    best_time=math.inf, origin=Origin.DERIVED)
        self.kb.store(p)
        return p, "derived"

    def _recurrent(self, sct: SCT, workload: Workload) -> Tuple[Profile, str]:
        assert self._current is not None
        unbalanced = self.balancer.lbt >= self.balancer.trigger
        if not unbalanced:
            return self._current, "reused"
        have_built = (self._current.origin is Origin.BUILT)
        if self.allow_profile_build and not have_built:
            result = build_profile(
                sct.unique_id(), workload, host=self.host, accel=self.accel,
                evaluate=self._make_evaluator(sct, workload),
                params=self.tuner_params, kb=self.kb, sct=sct)
            self.balancer.reset_search()
            self.balancer.lbt = 0.0
            return result.profile, "built"
        # Adjust workload distribution (adaptive binary search) from the
        # last observed per-class makespans (scheduler-owned state: the
        # executor's last_* fields are not stable under concurrent nodes)
        last = self._last_class_times
        cur = Distribution(a=self._current.share_a, b=1 - self._current.share_a)
        new = self.balancer.adjust(cur, last[0], last[1])
        adjusted = dataclasses.replace(self._current, share_a=new.a,
                                       best_time=math.inf)
        return adjusted, "adjusted"

    # ------------------------------------------------------------------
    def _dispatch(self, sct: SCT, arrays: Dict[str, Any], profile: Profile,
                  *, resident=None, keep_resident: bool = False,
                  plan: Optional[NodePlan] = None
                  ) -> Tuple[Dict[str, Any], ExecutionStats,
                             List[ExecutionSlot], Any, NodePlan]:
        """Plan + execute one run; returns (outputs, stats, slots,
        resident handle, node plan).  The plan phase (slot generation,
        plan cache) serialises on the dedicated plan lock — not the
        decide/observe lock, so a node planning never queues behind
        another node's observation; execution does not lock at all.  A
        pre-resolved ``plan`` skips the phase (and the lock) entirely."""
        t0 = time.perf_counter()
        if plan is not None:
            slots, part = list(plan.slots), plan.part
            cache_hit = True
            node_plan = plan
        else:
            with self._plan_lock:
                self._counts["plan_locks"] += 1
                with self.telemetry.tracer.span("plan") as plan_span:
                    shapes = {k: tuple(getattr(v, "shape", ()))
                              for k, v in arrays.items()}
                    if resident is not None:
                        # slot-resident vectors are inputs too: plan over
                        # their global (merged) shapes without
                        # materialising them
                        shapes = {**resident.shapes(), **shapes}
                    slots = self._slots(profile)
                    shares = self._per_slot_shares(profile, slots)
                    part, cache_hit = self.plan_cache.partition(sct, shapes,
                                                                slots, shares)
                    plan_span.note(cache_hit=cache_hit, slots=len(slots))
            node_plan = NodePlan(profile=profile, slots=tuple(slots),
                                 shares=tuple(float(s) for s in shares),
                                 part=part,
                                 health_version=self.health.version)
        plan_seconds = time.perf_counter() - t0

        kwargs: Dict[str, Any] = {}
        if getattr(self.executor, "supports_residency", False):
            kwargs = {"resident": resident, "keep_resident": keep_resident}
        execute_result = getattr(self.executor, "execute_result", None)
        if execute_result is not None:
            # per-call result object: safe under concurrent graph nodes
            res = execute_result(sct, part, arrays, profile, **kwargs)
            outputs, times = res.outputs, res.times
            failures, retries = res.failures, res.retries
            timing = dict(res.timing or {})
            merge_bytes = res.merge_bytes
            resident_out = res.resident
        else:
            # legacy duck-typed executor: observe through last_* fields
            outputs, times = self.executor.execute(sct, part, arrays,
                                                   profile, **kwargs)
            failures = list(getattr(self.executor, "last_failures", []))
            retries = int(getattr(self.executor, "last_retries", 0))
            timing = dict(getattr(self.executor, "last_timing", {}) or {})
            merge_bytes = int(getattr(self.executor, "last_merge_bytes", 0))
            resident_out = getattr(self.executor, "last_resident", None)
        n_a = sum(1 for s in slots if s.device_type != "cpu")
        ta, tb = class_times(times, n_a)
        stats = ExecutionStats(
            times=list(times), share_a=profile.share_a, time_a=ta, time_b=tb,
            failures=failures,
            retries=retries,
            plan_seconds=plan_seconds,
            pool_seconds=float(timing.get("pool", 0.0)),
            dispatch_seconds=float(timing.get("dispatch", 0.0)),
            compute_seconds=float(timing.get("compute", 0.0)),
            merge_seconds=float(timing.get("merge", 0.0)),
            merge_bytes=merge_bytes,
            plan_cache_hit=cache_hit,
            resident=resident_out is not None)
        return outputs, stats, list(slots), resident_out, node_plan

    def _usable_accel_devices(self):
        return [d for d in self.accel.devices if self.health.usable(d.name)]

    def _slots(self, profile: Profile) -> List[ExecutionSlot]:
        """Accelerator slots first (class a), then host fission slots.

        Quarantined devices are excluded — the run degrades gracefully to
        CPU-only or GPU-only; a device due for probation re-enters here
        (with a probe-sized share, see :meth:`_per_slot_shares`).
        """
        self.host.configure(profile.config.fission_level)
        self.accel.configure(profile.config.overlap)
        slots: List[ExecutionSlot] = []
        for d in self._usable_accel_devices():
            for o in range(self.accel.overlap):
                slots.append(ExecutionSlot(device=f"{d.name}/q{o}",
                                           device_type=d.kind,
                                           wgs=dict(profile.config.wgs)))
        if self.health.usable(self.host.device.name):
            for i in range(self.host.parallelism):
                slots.append(ExecutionSlot(
                    device=f"{self.host.device.name}/f{i}",
                    device_type="cpu", wgs=dict(profile.config.wgs)))
        if not slots:
            raise ExecutionError(
                "all devices quarantined: no execution slots available "
                f"(quarantined: {sorted(self.health.quarantined())})")
        return slots

    def _per_slot_shares(self, profile: Profile,
                         slots: Sequence[ExecutionSlot]) -> List[float]:
        n_a = sum(1 for s in slots if s.device_type != "cpu")
        n_b = len(slots) - n_a
        accel_devs = self._usable_accel_devices()
        # restrict calibration scores to the devices actually in the slots
        by_name = dict(zip((d.name for d in self.accel.devices),
                           self.accel.calibrate()))
        ratios_a = [by_name[d.name] for d in accel_devs]
        tot_r = sum(ratios_a)
        if tot_r > 0:
            ratios_a = [r / tot_r for r in ratios_a]
        if not n_a:
            dist = Distribution(a=0.0, b=1.0)       # degraded: CPU-only
        elif not n_b:
            dist = Distribution(a=1.0, b=0.0)       # degraded: GPU-only
        else:
            dist = Distribution(a=profile.share_a, b=1 - profile.share_a)
        shares: List[float] = []
        if n_a:
            per_dev = [dist.a * r for r in ratios_a]     # static intra-class
            for i, d in enumerate(accel_devs):
                if self.health.is_probing(d.name):       # probation: tiny share
                    per_dev[i] = min(per_dev[i], self.health.probe_share)
            per_queue = []
            for r in per_dev:
                per_queue.extend([r / self.accel.overlap] * self.accel.overlap)
            shares.extend(per_queue)
        if n_b:
            b = dist.b / n_b
            if self.health.is_probing(self.host.device.name):
                b = min(b, self.health.probe_share / n_b)
            shares.extend([b] * n_b)
        # normalise tiny float drift (and probe-share rescaling)
        t = sum(shares)
        if t <= 0:
            # every participating device capped to a zero share (e.g. all
            # probing with probe_share=0): fall back to uniform shares
            # instead of dividing by zero
            return [1.0 / len(shares)] * len(shares)
        return [s / t for s in shares]

    def _make_evaluator(self, sct: SCT, workload: Workload):
        """Evaluator closure for Algorithm 1 over the live executor."""
        def evaluate(cfg: PlatformConfig, dist: Distribution):
            p = Profile(sct_id=sct.unique_id(), workload=workload,
                        share_a=dist.a, config=cfg, best_time=math.inf,
                        origin=Origin.BUILT)
            arrays = self.executor.synthesise_arrays(sct, workload)
            _, stats, _, _, _ = self._dispatch(sct, arrays, p)
            # per-class makespans recorded at dispatch time — one source
            # of truth shared with the balancer and the health tracker
            return stats.total, stats.time_a, stats.time_b
        return evaluate


class _FusedDriver:
    """Admission-queue unit for one flushed fusion batch.

    Occupies one ``max_inflight`` slot (the batch is a single decide +
    dispatch + merge), runs on the shared graph pool, and settles every
    member's handle.  Duck-typed against :class:`GraphDriver` where the
    admission machinery needs it (``handle``, ``start``)."""

    def __init__(self, scheduler: Scheduler, batch: _FusionBatch):
        self.sched = scheduler
        self.batch = batch
        self.handle = batch.members[0].handle   # drain()'s wait probe

    def start(self) -> None:
        self.sched._graph_pool().submit(self._main)

    def _main(self) -> None:
        try:
            self.sched._run_fused(self.batch)
        except BaseException as e:      # defensive: settle, never wedge
            for m in self.batch.members:
                if not m.handle.done():
                    self.sched._settle_member(m, error=e)
        finally:
            self.sched._graph_done(self)


def _array_sig(arrays: Dict[str, Any]) -> Tuple:
    """Shape/dtype identity of submit-time inputs, for whole-graph plan
    keys (values excluded — the cache stores plans, not results)."""
    sig = []
    for k in sorted(arrays):
        v = arrays[k]
        sig.append((k, tuple(int(d) for d in getattr(v, "shape", ())),
                    str(getattr(v, "dtype", type(v).__name__))))
    return tuple(sig)


def infer_workload(sct: SCT, arrays: Dict[str, Any],
                   shapes: Optional[Dict[str, Tuple[int, ...]]] = None
                   ) -> Workload:
    """Workload characterisation from the request arguments (Sec. 3.2.1).

    ``shapes`` supplies global shapes for inputs that are not present in
    ``arrays`` as host arrays — slot-resident vectors on the chained
    path (itemsize defaults to 4 for those, matching the float32
    kernels used throughout).
    """
    for a in sct.free_inputs():
        v = arrays.get(a.name)
        if v is not None and hasattr(v, "shape") and getattr(v, "ndim", 0) >= 1:
            itemsize = getattr(getattr(v, "dtype", None), "itemsize", 4)
            return Workload(tuple(int(d) for d in v.shape), itemsize)
        if shapes and len(shapes.get(a.name, ())) >= 1:
            return Workload(tuple(int(d) for d in shapes[a.name]), 4)
    raise ValueError("cannot characterise workload: no vector argument")
