"""Observability layer: structured tracing, metrics, event log.

The paper's scheduler is a *feedback* system — per-device times feed the
lbt detector, the adaptive binary search and the knowledge base — so
every interesting decision (plan-cache miss, repartition retry,
quarantine, balance operation) happens deep inside the run loop where
``ExecutionStats`` alone cannot explain it.  This module provides the
three standard observability primitives, dependency-free:

:class:`Tracer`
    Nested spans with monotonic timestamps and structured attributes.
    Span enter/exit append Chrome-trace ``B``/``E`` events (per-thread
    ordering makes the pairs nest correctly by construction);
    :meth:`Tracer.record` adds pre-timed spans from a *virtual* clock —
    the :class:`~repro_torch.core.simulator.SimulatedExecutor` uses it to lay
    its analytic per-slot times on a deterministic timeline.  The
    buffer exports as Chrome/Perfetto ``trace.json``
    (``chrome://tracing`` / https://ui.perfetto.dev).

:class:`MetricsRegistry`
    Counters, gauges and histograms with optional labels, a
    Prometheus-style text dump (:meth:`~MetricsRegistry.to_prometheus`)
    and a JSON :meth:`~MetricsRegistry.snapshot`.  The recurrent-graph
    fast path reports through ``graph_plan_cache_{hits,misses,
    invalidations}_total`` and cross-request fusion through
    ``fused_requests_total`` / ``fused_batches_total``, alongside the
    per-run ``scheduler_actions_total`` labels ``action="preplanned"``
    and ``action="fused"`` (see the scheduler module docstring for the
    semantics of both paths).

:class:`EventLog`
    Bounded ring buffer of structured events with pluggable sinks and a
    stdlib-``logging`` bridge.  Warning-and-above events are forwarded
    to ``logging`` even when telemetry is disabled, so operational
    signals (device quarantine) are never silently dropped.

:class:`Telemetry` bundles the three and is what the Scheduler,
executors, :class:`~repro_torch.core.faults.DeviceHealth` and
:class:`~repro_torch.core.load_balancer.LoadBalancer` share (see
``Scheduler(telemetry=...)`` / ``Session(telemetry=...)``).

Cost discipline: telemetry is **off by default** and the disabled path
must be negligible — ``NULL_TELEMETRY`` hands out shared no-op span /
metric singletons whose enter/exit/inc are empty methods (no
allocation, no locks, no clock reads); ``tests/test_telemetry.py``
enforces a per-span cost bound with a microbenchmark.

Determinism: all timestamps come from the injectable ``clock``
(default ``time.perf_counter``); with a counting clock and the seeded
simulator the full event stream is reproducible bit-for-bit.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import logging
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

LOGGER_NAME = "repro.telemetry"

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR,
           "critical": logging.CRITICAL}


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op span: zero-allocation context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **attrs) -> None:
        """No-op counterpart of :meth:`_Span.note`."""


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span; ``with tracer.span(...)`` emits a B/E event pair."""

    __slots__ = ("_tracer", "name", "attrs", "_late")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._late: Optional[Dict[str, Any]] = None

    def note(self, **attrs) -> None:
        """Attach attributes discovered mid-span (exported on the E event)."""
        if self._late is None:
            self._late = {}
        self._late.update(attrs)

    def __enter__(self) -> "_Span":
        self._tracer._emit("B", self.name, self.attrs)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        late = self._late
        if exc_type is not None:
            late = dict(late or {})
            late["error"] = exc_type.__name__
        self._tracer._emit("E", self.name, late)
        return False


class Tracer:
    """Chrome-trace span recorder (B/E pairs + instants + virtual spans)."""

    enabled = True

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 capacity: int = 100_000):
        self.clock = clock
        self.capacity = capacity
        self.dropped = 0
        self._epoch = clock()
        self._events: List[Dict[str, Any]] = []
        self._tids: Dict[int, int] = {}
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """A point-in-time marker (Chrome phase ``i``)."""
        ev = {"name": name, "ph": "i", "ts": self._ts(), "pid": 0,
              "tid": self._tid(), "s": "t"}
        if attrs:
            ev["args"] = attrs
        self._append(ev)

    def record(self, name: str, start_us: float, duration_us: float,
               *, tid: int = 0, **attrs) -> None:
        """Add a pre-timed span (virtual timeline, e.g. simulated slots).

        ``start_us`` / ``duration_us`` are microseconds on the caller's
        own timeline; exported as a Chrome complete (``X``) event.
        """
        ev = {"name": name, "ph": "X", "ts": float(start_us),
              "dur": max(float(duration_us), 0.0), "pid": 0, "tid": tid}
        if attrs:
            ev["args"] = attrs
        self._append(ev)

    # -- internals -----------------------------------------------------------
    def _ts(self) -> float:
        return (self.clock() - self._epoch) * 1e6      # microseconds

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _emit(self, ph: str, name: str,
              attrs: Optional[Dict[str, Any]]) -> None:
        ev: Dict[str, Any] = {"name": name, "ph": ph, "ts": self._ts(),
                              "pid": 0, "tid": self._tid()}
        if attrs:
            ev["args"] = attrs
        self._append(ev)

    def _append(self, ev: Dict[str, Any]) -> None:
        # bound the buffer: drop new events past capacity (keeping the
        # prefix preserves already-matched B/E pairs)
        if len(self._events) >= self.capacity:
            self.dropped += 1
            return
        self._events.append(ev)

    # -- export --------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def clear(self) -> None:
        self._events = []
        self.dropped = 0

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome/Perfetto ``trace.json`` object.

        Spans still open at export time are closed with a synthetic E
        event so the file always validates (matched B/E pairs)."""
        events = list(self._events)
        stacks: Dict[Tuple[int, int], List[Dict[str, Any]]] = {}
        for e in events:
            key = (e["pid"], e["tid"])
            if e["ph"] == "B":
                stacks.setdefault(key, []).append(e)
            elif e["ph"] == "E" and stacks.get(key):
                stacks[key].pop()
        now = self._ts()
        for key, open_spans in stacks.items():
            for b in reversed(open_spans):
                events.append({"name": b["name"], "ph": "E",
                               "ts": max(now, b["ts"]), "pid": key[0],
                               "tid": key[1],
                               "args": {"unterminated": True}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


class _NullTracer(Tracer):
    """Disabled tracer: every operation is a no-op returning singletons."""

    enabled = False

    def __init__(self):
        super().__init__(clock=lambda: 0.0, capacity=0)

    def span(self, name: str, **attrs) -> _NullSpan:   # type: ignore[override]
        return _NULL_SPAN

    def instant(self, name: str, **attrs) -> None:
        pass

    def record(self, name: str, start_us: float, duration_us: float,
               *, tid: int = 0, **attrs) -> None:
        pass


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

#: default histogram buckets (seconds-oriented, log-spaced)
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 60.0)


class Counter:
    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def snapshot(self):
        return self.value


class Gauge:
    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def snapshot(self):
        return self.value


class Histogram:
    __slots__ = ("buckets", "counts", "count", "sum")
    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)    # +inf tail
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def snapshot(self):
        return {"count": self.count, "sum": self.sum,
                "buckets": {str(b): c for b, c in
                            zip(self.buckets + ("+Inf",),
                                _cumulative(self.counts))}}


def _cumulative(counts: Sequence[int]) -> List[int]:
    out, acc = [], 0
    for c in counts:
        acc += c
        out.append(acc)
    return out


class _NullMetric:
    """Shared no-op counter/gauge/histogram for disabled telemetry."""

    __slots__ = ()
    kind = "null"
    value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def snapshot(self):
        return 0.0


_NULL_METRIC = _NullMetric()


class MetricsRegistry:
    """Named counters / gauges / histograms with optional labels.

    A metric series is identified by ``(name, sorted label items)``;
    lookups get-or-create, so instrumentation sites never need
    registration boilerplate:

        registry.counter("retries_total").inc()
        registry.counter("device_busy_seconds_total", device="gpu0").inc(t)
    """

    enabled = True

    def __init__(self):
        self._series: "collections.OrderedDict[Tuple[str, Tuple], Any]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()

    def _get(self, name: str, labels: Dict[str, Any], factory):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        m = self._series.get(key)
        if m is None:
            with self._lock:
                m = self._series.setdefault(key, factory())
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(name, labels, lambda: Histogram(buckets))

    # -- export --------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-serialisable dump: ``name{k=v,...} -> value`` flat map."""
        out: Dict[str, Any] = {}
        for (name, labels), metric in self._series.items():
            key = name
            if labels:
                key += "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
            out[key] = metric.snapshot()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (untyped label escaping)."""
        lines: List[str] = []
        typed: set = set()
        for (name, labels), metric in self._series.items():
            pname = name.replace(".", "_").replace("-", "_")
            if pname not in typed:
                lines.append(f"# TYPE {pname} {metric.kind}")
                typed.add(pname)
            lab = ""
            if labels:
                lab = "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"
            if isinstance(metric, Histogram):
                cum = _cumulative(metric.counts)
                for b, c in zip(metric.buckets + ("+Inf",), cum):
                    extra = f'le="{b}"'
                    blab = ("{" + ",".join(f'{k}="{v}"' for k, v in labels)
                            + ("," if labels else "") + extra + "}") \
                        if labels else "{" + extra + "}"
                    lines.append(f"{pname}_bucket{blab} {c}")
                lines.append(f"{pname}_sum{lab} {metric.sum}")
                lines.append(f"{pname}_count{lab} {metric.count}")
            else:
                lines.append(f"{pname}{lab} {metric.snapshot()}")
        return "\n".join(lines) + ("\n" if lines else "")


class _NullMetricsRegistry(MetricsRegistry):
    enabled = False

    def counter(self, name: str, **labels):    # type: ignore[override]
        return _NULL_METRIC

    def gauge(self, name: str, **labels):      # type: ignore[override]
        return _NULL_METRIC

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS,
                  **labels):                   # type: ignore[override]
        return _NULL_METRIC


# ---------------------------------------------------------------------------
# Event log
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Event:
    """One structured event (fault, health transition, balancer op, ...)."""

    seq: int
    ts: float                    # seconds on the telemetry clock
    kind: str                    # e.g. "health.quarantined"
    level: str                   # "debug" | "info" | "warning" | "error"
    message: str = ""
    fields: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {"seq": self.seq, "ts": self.ts, "kind": self.kind,
                "level": self.level, "message": self.message,
                **self.fields}


class EventLog:
    """Bounded ring buffer of :class:`Event` with sinks + logging bridge.

    ``sink`` callables receive every event (exceptions are contained so
    a broken sink cannot fail the run loop).  With ``bridge=True``
    every event is forwarded to the stdlib logger ``repro.telemetry``
    at its own level; a *disabled* log still bridges warning-and-above
    events — operational signals like device quarantine must reach the
    operator even with telemetry off.
    """

    enabled = True

    def __init__(self, *, capacity: int = 1024,
                 sink: Optional[Callable[[Event], None]] = None,
                 bridge: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 logger: Optional[logging.Logger] = None):
        self.capacity = capacity
        self.bridge = bridge
        self.clock = clock
        self._epoch = clock()
        self._logger = logger or logging.getLogger(LOGGER_NAME)
        self._buffer: "collections.deque[Event]" = \
            collections.deque(maxlen=capacity)
        self._sinks: List[Callable[[Event], None]] = [sink] if sink else []
        self._seq = 0
        self._lock = threading.Lock()

    def add_sink(self, sink: Callable[[Event], None]) -> None:
        self._sinks.append(sink)

    def emit(self, kind: str, *, level: str = "info", message: str = "",
             **fields) -> Optional[Event]:
        if not self.enabled:
            if self.bridge and _LEVELS.get(level, 0) >= logging.WARNING:
                self._logger.log(_LEVELS[level], "%s %s%s", kind, message,
                                 f" {fields}" if fields else "")
            return None
        with self._lock:
            seq = self._seq
            self._seq += 1
        ev = Event(seq=seq, ts=self.clock() - self._epoch, kind=kind,
                   level=level, message=message, fields=fields)
        self._buffer.append(ev)
        for sink in self._sinks:
            try:
                sink(ev)
            except Exception:           # a broken sink must not fail runs
                logging.getLogger(LOGGER_NAME).exception(
                    "telemetry sink raised")
        if self.bridge:
            self._logger.log(_LEVELS.get(level, logging.INFO),
                             "%s %s%s", kind, message,
                             f" {fields}" if fields else "")
        return ev

    def records(self, kind: Optional[str] = None) -> List[Event]:
        evs = list(self._buffer)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind
                   or e.kind.startswith(kind + ".")]
        return evs

    def __len__(self) -> int:
        return len(self._buffer)


class _NullEventLog(EventLog):
    """Disabled event log: buffers nothing, still bridges warnings."""

    enabled = False

    def __init__(self):
        super().__init__(capacity=0, clock=lambda: 0.0)


# ---------------------------------------------------------------------------
# Facade
# ---------------------------------------------------------------------------

class Telemetry:
    """Tracer + metrics + event log bundle shared across the pipeline.

    ``Telemetry()`` is the enabled collector; :data:`NULL_TELEMETRY`
    (also ``Telemetry.disabled()``) is the shared off-by-default
    instance whose operations are no-ops (except warning-level event
    bridging, see :class:`EventLog`).
    """

    def __init__(self, *, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter,
                 span_capacity: int = 100_000, event_capacity: int = 1024,
                 sink: Optional[Callable[[Event], None]] = None,
                 log_bridge: bool = True):
        self.enabled = enabled
        if enabled:
            self.tracer: Tracer = Tracer(clock=clock,
                                         capacity=span_capacity)
            self.metrics: MetricsRegistry = MetricsRegistry()
            self.events: EventLog = EventLog(capacity=event_capacity,
                                             sink=sink, bridge=log_bridge,
                                             clock=clock)
        else:
            self.tracer = _NullTracer()
            self.metrics = _NullMetricsRegistry()
            self.events = _NullEventLog()

    @staticmethod
    def disabled() -> "Telemetry":
        return NULL_TELEMETRY

    # -- export --------------------------------------------------------------
    def export_trace(self, path: str) -> Dict[str, Any]:
        """Write the Chrome ``trace.json`` to ``path``; returns the object.

        Load it in ``chrome://tracing`` or https://ui.perfetto.dev."""
        trace = self.tracer.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return trace

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-serialisable blob: metrics + recent events."""
        return {"metrics": self.metrics.snapshot(),
                "events": [e.as_dict() for e in self.events.records()]}


#: the shared disabled instance — the default for every instrumented class
NULL_TELEMETRY = Telemetry(enabled=False)


# ---------------------------------------------------------------------------
# Chrome-trace validation (tests + CI smoke job)
# ---------------------------------------------------------------------------

_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


def validate_chrome_trace(trace: Any) -> List[str]:
    """Validate a Chrome trace object; returns a list of problems.

    Checks the containership schema (``traceEvents`` list of event
    objects with name/ph/ts/pid/tid), numeric timestamps, ``dur`` on
    complete (``X``) events, and — per ``(pid, tid)`` track — that
    every ``B`` has a matching same-name ``E`` in nesting order.
    """
    errors: List[str] = []
    if not isinstance(trace, dict):
        return ["trace is not a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    stacks: Dict[Tuple[Any, Any], List[Tuple[str, float]]] = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            errors.append(f"event {i}: not an object")
            continue
        missing = [k for k in _REQUIRED_KEYS if k not in e]
        if missing:
            errors.append(f"event {i}: missing keys {missing}")
            continue
        if not isinstance(e["ts"], (int, float)) or e["ts"] < 0:
            errors.append(f"event {i}: bad ts {e['ts']!r}")
        ph = e["ph"]
        key = (e["pid"], e["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append((e["name"], e["ts"]))
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                errors.append(f"event {i}: E '{e['name']}' with no open B "
                              f"on track {key}")
                continue
            name, ts = stack.pop()
            if name != e["name"]:
                errors.append(f"event {i}: E '{e['name']}' closes B "
                              f"'{name}' (mismatched nesting)")
            if isinstance(e["ts"], (int, float)) and e["ts"] < ts:
                errors.append(f"event {i}: E before its B "
                              f"({e['ts']} < {ts})")
        elif ph == "X":
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                errors.append(f"event {i}: X event without numeric dur")
        elif ph not in ("i", "I", "M", "C"):
            errors.append(f"event {i}: unknown phase {ph!r}")
    for key, stack in stacks.items():
        for name, _ in stack:
            errors.append(f"unmatched B '{name}' on track {key}")
    return errors


def metrics_block(telemetry: Telemetry) -> Dict[str, Any]:
    """Schema-stable metrics block for embedding in BENCH_*.json files."""
    return {"schema": "repro.metrics/v1",
            "enabled": telemetry.enabled,
            "metrics": telemetry.metrics.snapshot()}
