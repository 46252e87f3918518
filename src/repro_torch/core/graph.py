"""JobGraph IR + concurrent graph execution (paper Fig. 2 work queues).

The paper's runtime decouples *describing* a compound computation from
*dispatching* it: the task launcher feeds per-device work queues, and a
compound computation is a general multi-kernel composition — not merely
a linear chain.  This module is that decoupling for the reproduction:

  * :class:`JobGraph` — the intermediate representation.  Nodes bind an
    SCT to named inputs; edges carry data dependencies and residency
    intent.  Construction is append-only (a node may only depend on
    nodes added before it), so a ``JobGraph`` is acyclic by
    construction and insertion order is always a valid topological
    order.  A linear chain (:meth:`JobGraph.from_chain`) is the
    degenerate case.
  * :class:`GraphHandle` — the asynchronous completion handle returned
    by ``Scheduler.submit`` / ``Session.submit``: per-node state,
    per-node :class:`~repro_torch.core.scheduler.ScheduledRun` results,
    per-node execution spans, and a blocking :meth:`GraphHandle.result`.
  * :class:`GraphDriver` — the execution engine.  On the threaded
    executor, nodes whose dependencies are satisfied are submitted to
    the scheduler's node pool as soon as they become ready, so
    *independent* nodes genuinely overlap (their segments land in
    disjoint per-device work queues).  On a virtual-clock executor
    (:class:`~repro_torch.core.simulator.SimulatedExecutor`) the driver runs
    nodes deterministically in topological order on the simulated
    timeline, modelling per-device work-queue contention, so fan-out /
    fan-in overlap is testable bit-for-bit without hardware.

Residency intent travels along graph edges: a node whose single
successor is its sole consumer (a *chain edge*) keeps its outputs
slot-resident (:class:`~repro_torch.core.executor.ResidentPartition`) and the
successor consumes them slot-locally — the ``run_chain`` optimisation
generalised to DAGs.  Fan-out and fan-in edges merge (the safe path),
so graph execution is never less correct than sequential execution.

Failure semantics: a node whose retries are exhausted is *contained* —
its descendants are marked ``skipped``, independent branches run to
completion, and :meth:`GraphHandle.result` raises a single
:class:`~repro_torch.core.faults.ExecutionError` identifying the first failed
node in topological order (with the per-slot fault records attached).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

from repro_torch.core.faults import ExecutionError
from repro_torch.core.skeletons import SCT


class GraphError(ValueError):
    """Malformed JobGraph: unknown dependency, duplicate node, empty graph."""


@dataclasses.dataclass
class JobNode:
    """One unit of graph work: an SCT bound to its dependency edges.

    ``residency`` is the node's residency intent for its outgoing edge:
    ``None`` (auto — keep resident on chain edges), ``False`` (always
    merge), ``True`` (request residency; still only honoured on a chain
    edge over a residency-capable executor, since fan-out consumers need
    the merged arrays).
    """

    name: str
    sct: SCT
    deps: Tuple[str, ...] = ()
    residency: Optional[bool] = None


class JobGraph:
    """Append-only DAG of SCT executions.

    ``add`` may only reference already-added nodes in ``after``, which
    makes cycles unrepresentable and keeps insertion order a valid
    topological order — the scheduling layers rely on both properties.
    """

    def __init__(self) -> None:
        self._nodes: Dict[str, JobNode] = {}
        self._succ: Dict[str, List[str]] = {}

    # -- construction --------------------------------------------------------
    def add(self, sct: SCT, *, name: Optional[str] = None,
            after: Iterable[str] = (),
            residency: Optional[bool] = None) -> str:
        """Add one node; returns its name (auto-derived from the SCT)."""
        if isinstance(after, str):
            after = (after,)
        deps = tuple(dict.fromkeys(after))
        for d in deps:
            if d not in self._nodes:
                raise GraphError(
                    f"unknown dependency {d!r}: nodes may only depend on "
                    "previously added nodes")
        if name is None:
            base = getattr(sct, "name", None) or "node"
            name = base
            i = len(self._nodes)
            while name in self._nodes:
                name = f"{base}.{i}"
                i += 1
        elif name in self._nodes:
            raise GraphError(f"duplicate node name {name!r}")
        self._nodes[name] = JobNode(name=name, sct=sct, deps=deps,
                                    residency=residency)
        self._succ[name] = []
        for d in deps:
            self._succ[d].append(name)
        return name

    def add_chain(self, scts: Sequence[SCT], *,
                  after: Iterable[str] = ()) -> List[str]:
        """Add a linear chain of nodes; returns their names in order."""
        names: List[str] = []
        prev: Iterable[str] = after
        for sct in scts:
            n = self.add(sct, after=prev)
            names.append(n)
            prev = (n,)
        return names

    @classmethod
    def from_chain(cls, scts: Sequence[SCT]) -> "JobGraph":
        """A linear chain — the degenerate JobGraph ``run_chain`` maps to."""
        g = cls()
        g.add_chain(list(scts))
        return g

    def validate(self) -> None:
        if not self._nodes:
            raise GraphError("empty graph: nothing to execute")

    # -- structure -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, name: str) -> bool:
        return name in self._nodes

    def __iter__(self) -> Iterator[str]:
        return iter(self._nodes)

    def names(self) -> List[str]:
        return list(self._nodes)

    @property
    def nodes(self) -> List[JobNode]:
        return list(self._nodes.values())

    def node(self, name: str) -> JobNode:
        try:
            return self._nodes[name]
        except KeyError:
            raise GraphError(f"unknown node {name!r}") from None

    def deps(self, name: str) -> Tuple[str, ...]:
        return self.node(name).deps

    def successors(self, name: str) -> List[str]:
        self.node(name)
        return list(self._succ[name])

    def in_degree(self, name: str) -> int:
        return len(self.deps(name))

    def out_degree(self, name: str) -> int:
        return len(self.successors(name))

    def roots(self) -> List[str]:
        return [n for n in self._nodes if not self._nodes[n].deps]

    def sinks(self) -> List[str]:
        return [n for n in self._nodes if not self._succ[n]]

    def topo_order(self) -> List[str]:
        # append-only construction: insertion order is topological
        return list(self._nodes)

    def signature(self) -> Tuple:
        """Structural identity of the graph, for whole-graph plan caching.

        Two graphs share a signature when they bind the same SCTs (by
        ``unique_id``) over the same dependency structure with the same
        residency intents — node *names* are labels and do not
        participate.  Together with the shapes of the submit-time input
        arrays this keys the scheduler's
        :class:`~repro_torch.core.scheduler.GraphPlanCache`.
        """
        pos = {n: i for i, n in enumerate(self._nodes)}
        return tuple((node.sct.unique_id(),
                      tuple(pos[d] for d in node.deps),
                      node.residency)
                     for node in self._nodes.values())

    def ancestors(self, name: str) -> List[str]:
        """Transitive dependencies of ``name``, in topological order."""
        seen = set()
        stack = list(self.deps(name))
        while stack:
            d = stack.pop()
            if d not in seen:
                seen.add(d)
                stack.extend(self.deps(d))
        return [n for n in self._nodes if n in seen]

    def is_chain_edge(self, u: str, v: str) -> bool:
        """True when v is u's only successor and u is v's only dependency."""
        return self.successors(u) == [v] and self.deps(v) == (u,)


# ---------------------------------------------------------------------------
# Completion handle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GraphResult:
    """Settled outcome of one graph execution.

    ``outputs`` merges the sink nodes' outputs (topological order, later
    sinks win on name clashes); ``runs`` maps node name to its
    :class:`~repro_torch.core.scheduler.ScheduledRun`; ``spans`` maps node
    name to its ``(start_us, end_us)`` execution window — wall-clock
    microseconds relative to submission on the threaded executor,
    virtual simulated-time microseconds on the simulator.
    """

    outputs: Dict[str, Any]
    runs: Dict[str, Any]
    spans: Dict[str, Tuple[float, float]]
    order: List[str]


class GraphHandle:
    """Asynchronous handle for one submitted JobGraph.

    Node states progress ``pending -> queued -> running -> done``;
    terminal failures mark the node ``failed`` and every descendant
    ``skipped``.  ``result`` blocks for completion and raises the
    aggregate :class:`~repro_torch.core.faults.ExecutionError` when any node
    failed (independent branches still ran to completion and their runs
    stay accessible via :attr:`runs`).
    """

    def __init__(self, graph: JobGraph, request_id: str):
        self.graph = graph
        self.request_id = request_id
        self.runs: Dict[str, Any] = {}
        self.error: Optional[ExecutionError] = None
        self._state: Dict[str, str] = {n: "pending" for n in graph.names()}
        self._spans: Dict[str, Tuple[float, float]] = {}
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._callbacks: List[Callable[["GraphHandle"], None]] = []

    # -- completion ----------------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> GraphResult:
        if not self._done.wait(timeout):
            raise cf.TimeoutError(
                f"graph {self.request_id!r} did not complete "
                f"within {timeout}s")
        if self.error is not None:
            raise self.error
        return GraphResult(outputs=self.outputs(), runs=dict(self.runs),
                           spans=self.spans(),
                           order=self.graph.topo_order())

    def add_done_callback(self,
                          fn: Callable[["GraphHandle"], None]) -> None:
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    # -- introspection -------------------------------------------------------
    def status(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._state)

    def spans(self) -> Dict[str, Tuple[float, float]]:
        with self._lock:
            return dict(self._spans)

    def outputs(self) -> Dict[str, Any]:
        """Merged outputs of the graph's sink nodes (topological order)."""
        out: Dict[str, Any] = {}
        for name in self.graph.topo_order():
            if not self.graph.successors(name):
                r = self.runs.get(name)
                if r is not None and r.outputs:
                    out.update(r.outputs)
        return out

    # -- driver-side mutators ------------------------------------------------
    def _mark(self, name: str, state: str) -> None:
        with self._lock:
            self._state[name] = state

    def _finish(self, error: Optional[ExecutionError]) -> None:
        with self._lock:
            self.error = error
            callbacks, self._callbacks = self._callbacks, []
            self._done.set()
        for cb in callbacks:
            try:
                cb(self)
            except Exception:
                pass        # a callback must never wedge graph completion


def _wrap_node_error(name: str, exc: BaseException) -> ExecutionError:
    """Terminal node failure -> graph-level error with node identity."""
    if isinstance(exc, ExecutionError):
        err = ExecutionError(f"graph node {name!r}: {exc}", (),
                             exc.attempts)
        err.records = list(exc.records)
    else:
        err = ExecutionError(
            f"graph node {name!r}: {type(exc).__name__}: {exc}")
    err.node = name  # type: ignore[attr-defined]
    return err


# ---------------------------------------------------------------------------
# Execution driver
# ---------------------------------------------------------------------------

class GraphDriver:
    """Executes one admitted JobGraph over a Scheduler.

    Contract with the scheduler: ``sched.run(sct, env, _resident=...,
    _keep_resident=...)`` is the (thread-safe) node primitive;
    ``sched._graph_pool()`` provides the node thread pool;
    ``sched._graph_done(driver)`` reports completion back to the
    admission queue; ``sched._virtual_busy`` is the shared per-device
    availability map for the virtual-clock path; ``sched._last_slots``
    names the slots of the most recent dispatch (only read on the
    single-threaded virtual path).

    Request options mirror ``Session.run``: ``retries`` terminal-error
    retries per node with exponential backoff, ``deadline`` a whole-
    graph budget in seconds.  Each backoff pause is capped by the
    remaining deadline and a node raises immediately when none remains
    — sleeping past the request deadline is a bug, not a retry.

    Whole-graph plan caching: ``preplanned`` (a topo-ordered list of
    :class:`~repro_torch.core.scheduler.NodePlan`, from a
    ``GraphPlanCache`` hit at submit time) routes every node through
    the scheduler's pre-planned dispatch — no decide-phase lock round
    trip.  On a miss, ``plan_key`` identifies the entry to record: when
    every node completes cleanly (no faults/retries, no distribution
    adjustment, no device-health movement) the driver hands its
    per-node plans back via ``Scheduler._graph_plan_record``.
    """

    def __init__(self, scheduler, handle: GraphHandle,
                 arrays: Dict[str, Any], *,
                 deadline: Optional[float] = None, retries: int = 0,
                 retry_backoff: float = 0.05,
                 preplanned: Optional[List[Any]] = None,
                 plan_key: Optional[Tuple] = None,
                 plan_epoch: int = 0):
        self.sched = scheduler
        self.handle = handle
        self.graph = handle.graph
        self.arrays = dict(arrays)
        self.deadline = deadline
        self.retries = int(retries)
        self.retry_backoff = retry_backoff
        self.preplanned = preplanned
        self.plan_key = plan_key
        self.plan_epoch = plan_epoch
        self._t0 = time.monotonic()
        self._epoch = time.perf_counter()
        self._lock = threading.Lock()
        self._order = self.graph.topo_order()
        self._pos = {n: i for i, n in enumerate(self._order)}
        self._waiting = {n: len(self.graph.deps(n))
                         for n in self.graph.names()}
        self._outputs: Dict[str, Dict[str, Any]] = {}
        self._residents: Dict[str, Any] = {}
        self._errors: Dict[str, BaseException] = {}
        self._settled = 0
        self._n = len(self.graph)

    # -- node primitive (shared by both modes) -------------------------------
    def _keep_resident(self, name: str) -> bool:
        """Residency intent of ``name``'s outgoing edge (chain edges only)."""
        if not getattr(self.sched.executor, "supports_residency", False):
            return False
        node = self.graph.node(name)
        if node.residency is False:
            return False
        succs = self.graph.successors(name)
        return len(succs) == 1 and self.graph.deps(succs[0]) == (name,)

    def _node_env(self, name: str) -> Tuple[Dict[str, Any], Any]:
        """(environment, resident handle) for one ready node.

        The environment layers the graph's input arrays with the merged
        outputs of every *ancestor* (topological order — parallel
        branches never see each other's outputs).  A chain-edge
        dependency that stayed slot-resident is consumed through the
        resident handle instead.
        """
        with self._lock:
            env = dict(self.arrays)
            for anc in self.graph.ancestors(name):
                out = self._outputs.get(anc)
                if out:
                    env.update(out)
            resident = None
            for d in self.graph.deps(name):
                r = self._residents.pop(d, None)
                if r is not None:
                    resident = r
        return env, resident

    def _run_node(self, name: str):
        """One node with per-node retry/deadline semantics; returns the
        ScheduledRun or raises the terminal ExecutionError."""
        node = self.graph.node(name)
        keep = self._keep_resident(name)
        env, resident = self._node_env(name)
        plan = (self.preplanned[self._pos[name]]
                if self.preplanned is not None else None)
        tel = self.sched.telemetry
        last: Optional[ExecutionError] = None
        for k in range(self.retries + 1):
            if self.deadline is not None and \
                    time.monotonic() - self._t0 > self.deadline:
                raise ExecutionError(
                    f"request deadline {self.deadline}s exceeded after "
                    f"{k} attempts", getattr(last, "records", []), k)
            try:
                with tel.tracer.span("node", request=self.handle.request_id,
                                     node=name, retry=k):
                    return self.sched.run(node.sct, env, _resident=resident,
                                          _keep_resident=keep, _plan=plan)
            except ExecutionError as e:
                last = e
                if k == self.retries or not getattr(e, "retryable", True):
                    raise
                pause = self.retry_backoff * (2 ** k)
                if self.deadline is not None:
                    remaining = self.deadline - (time.monotonic() - self._t0)
                    if remaining <= 0:
                        raise ExecutionError(
                            f"request deadline {self.deadline}s exceeded "
                            f"after {k + 1} attempts", e.records, k + 1)
                    pause = min(pause, remaining)
                if pause > 0:
                    time.sleep(pause)
        raise last  # pragma: no cover — loop always returns or raises

    # -- threaded (concurrent) mode ------------------------------------------
    def start(self) -> None:
        """Admit the graph: schedule every dependency-free node."""
        tel = self.sched.telemetry
        tel.events.emit("graph.admitted", request=self.handle.request_id,
                        nodes=self._n)
        roots = self.graph.roots()
        for name in roots:
            self._dispatch_node(name)
        if not roots:  # pragma: no cover — validate() rejects empty graphs
            self._finalize()

    def _dispatch_node(self, name: str) -> None:
        self.handle._mark(name, "queued")
        self.sched._graph_pool().submit(self._node_main, name)

    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def _node_main(self, name: str) -> None:
        self.handle._mark(name, "running")
        start_us = self._now_us()
        try:
            run = self._run_node(name)
        except BaseException as e:
            with self.handle._lock:
                self.handle._spans[name] = (start_us, self._now_us())
            self._node_failed(name, e)
            return
        with self.handle._lock:
            self.handle._spans[name] = (start_us, self._now_us())
        self._node_done(name, run)

    def _node_done(self, name: str, run) -> None:
        to_submit: List[str] = []
        with self._lock:
            self.handle.runs[name] = run
            resident = getattr(run, "resident_handle", None)
            if resident is not None:
                self._residents[name] = resident
            if run.outputs:
                self._outputs[name] = run.outputs
            with self.handle._lock:
                self.handle._state[name] = "done"
            self._settled += 1
            for s in self.graph.successors(name):
                self._waiting[s] -= 1
                if self._waiting[s] == 0 and \
                        self.handle._state[s] == "pending":
                    to_submit.append(s)
            finished = self._settled == self._n
        for s in to_submit:
            self._dispatch_node(s)
        if finished:
            self._finalize()

    def _node_failed(self, name: str, exc: BaseException) -> None:
        tel = self.sched.telemetry
        tel.metrics.counter("graph_nodes_failed_total").inc()
        tel.events.emit("graph.node_failed", level="error",
                        request=self.handle.request_id, node=name,
                        message=str(exc))
        with self._lock:
            with self.handle._lock:
                self.handle._state[name] = "failed"
            self._errors[name] = exc
            self._settled += 1
            # containment: descendants are skipped, siblings keep running
            stack = list(self.graph.successors(name))
            while stack:
                s = stack.pop()
                if self.handle._state[s] == "pending":
                    with self.handle._lock:
                        self.handle._state[s] = "skipped"
                    self._settled += 1
                    stack.extend(self.graph.successors(s))
            finished = self._settled == self._n
        if finished:
            self._finalize()

    def _finalize(self) -> None:
        error: Optional[ExecutionError] = None
        for name in self.graph.topo_order():    # deterministic: first in topo
            exc = self._errors.get(name)
            if exc is not None:
                error = _wrap_node_error(name, exc)
                break
        if error is None:
            record = getattr(self.sched, "_graph_plan_record", None)
            if record is not None:
                record(self)
        tel = self.sched.telemetry
        tel.metrics.counter(
            "graphs_total",
            status="error" if error is not None else "ok").inc()
        tel.events.emit("graph.done", request=self.handle.request_id,
                        failed=sum(1 for s in self.handle.status().values()
                                   if s in ("failed", "skipped")))
        self.handle._finish(error)
        self.sched._graph_done(self)

    # -- virtual-clock (simulator) mode --------------------------------------
    def run_virtual(self) -> None:
        """Deterministic graph execution on the simulated timeline.

        Nodes run in topological order; each node becomes *ready* when
        its dependencies end, and each of its slots starts when both the
        node is ready and the slot's device work queue is free — the
        per-device queue model of the threaded executor, replayed in
        virtual time.  Device availability (``sched._virtual_busy``, in
        virtual µs) is shared across submissions, so multi-request
        admission contends realistically.  ``GraphHandle.spans()`` is
        the authoritative node timeline; the simulator's own slot trace
        records each node at its ready time (pure dataflow) and may
        start earlier than the queue-adjusted span.
        """
        ex = self.sched.executor
        busy: Dict[str, float] = self.sched._virtual_busy
        t0v = float(getattr(ex, "vclock_us", 0.0))
        end_us: Dict[str, float] = {}
        for name in self.graph.topo_order():
            deps = self.graph.deps(name)
            if any(self.handle._state[d] != "done" for d in deps):
                self.handle._mark(name, "skipped")
                self._settled += 1
                continue
            ready = max([end_us[d] for d in deps] + [t0v])
            ex.vclock_us = ready
            self.handle._mark(name, "running")
            try:
                run = self._run_node(name)
            except BaseException as e:
                fin = float(ex.vclock_us)
                self.handle._spans[name] = (ready, fin)
                self.handle._state[name] = "failed"
                self._errors[name] = e
                self._settled += 1
                end_us[name] = fin
                self.sched.telemetry.events.emit(
                    "graph.node_failed", level="error",
                    request=self.handle.request_id, node=name,
                    message=str(e))
                continue
            slots = list(getattr(self.sched, "_last_slots", []))
            starts: List[float] = []
            ends: List[float] = []
            for slot, t in zip(slots, run.stats.times):
                if t <= 0:
                    continue        # zero-share slot: no queue occupancy
                s = max(ready, busy.get(slot.device, t0v))
                e_us = s + t * 1e6
                busy[slot.device] = e_us
                starts.append(s)
                ends.append(e_us)
            start_us = min(starts) if starts else ready
            fin_us = max(ends) if ends else float(ex.vclock_us)
            ex.vclock_us = max(fin_us, float(ex.vclock_us))
            self.handle._spans[name] = (start_us, fin_us)
            end_us[name] = fin_us
            self.handle.runs[name] = run
            if run.outputs:
                self._outputs[name] = run.outputs
            self.handle._state[name] = "done"
            self._settled += 1
        self._finalize()
