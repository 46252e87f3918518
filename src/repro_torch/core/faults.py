"""Fault-tolerance layer: error taxonomy, injection, health tracking.

The paper's scheduler adapts to *slow* devices (the lbt detector and the
adaptive binary search of Sec. 3.3) but assumes every execution slot
always completes.  Production heterogeneous runtimes (EngineCL's device
dropout handling; Kothapalli et al.'s cross-device-class fallback) must
treat device *failure* and *stalls* as first-class scheduling signals.
This module provides the shared vocabulary:

Error taxonomy
  * :class:`SlotFailure`     — one execution slot raised; recoverable by
    re-partitioning its slice across the surviving slots.
  * :class:`SlotTimeout`     — a slot exceeded its watchdog deadline
    (derived from ``profile.best_time``); treated like a crash, but the
    device is additionally suspected of being hung.
  * :class:`PartitionLost`   — a slice could not be recovered because no
    surviving slot can take it (all peers dead or quarantined).
  * :class:`ExecutionError`  — terminal: retries exhausted (or no
    capacity left).  Carries the per-slot :class:`FaultRecord` history.

Determinism
  :class:`FaultInjector` produces crashes/stalls from a seeded counter —
  per-slot crash probability, stall injection, and exact Nth-call
  triggers — so pod-scale failure policies are testable bit-for-bit on
  both the threaded executor and the simulator.

Health
  :class:`DeviceHealth` tracks consecutive per-device failures; devices
  that cross the quarantine threshold are excluded from slot generation
  until a probationary probe run succeeds (graceful degradation down to
  CPU-only or GPU-only execution).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.telemetry import NULL_TELEMETRY


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FaultRecord:
    """One observed slot-level fault (crash / timeout / lost partition)."""

    slot: int                   # index of the slot within the partitioning
    device: str                 # e.g. "gpu0/q1", "cpu/f3"
    device_type: str            # "cpu" | "gpu" | "tpu"
    kind: str                   # "crash" | "timeout" | "lost" | "device"
    attempt: int                # 0-based retry round the fault occurred in
    message: str = ""
    seconds: float = 0.0        # elapsed before the fault was observed

    @property
    def device_base(self) -> str:
        """Physical device name without the queue/fission suffix."""
        return self.device.split("/")[0]

    def __str__(self) -> str:
        return (f"[attempt {self.attempt}] slot {self.slot} "
                f"({self.device}, {self.device_type}): {self.kind}"
                + (f" — {self.message}" if self.message else ""))


class SlotFailure(RuntimeError):
    """A single execution slot failed; the run may still be recovered."""

    def __init__(self, record: FaultRecord):
        super().__init__(str(record))
        self.record = record


class SlotTimeout(SlotFailure):
    """A slot exceeded its watchdog deadline (hung device / stalled queue)."""


class PartitionLost(SlotFailure):
    """A lost slice has no surviving slot able to adopt it."""


class ExecutionError(RuntimeError):
    """Terminal failure of a scheduled run: retries exhausted.

    ``records`` is the full per-slot fault history across attempts, so
    callers (and ``Future.get``) can report *which* device failed rather
    than a bare pool exception.
    """

    def __init__(self, message: str,
                 records: Sequence[FaultRecord] = (),
                 attempts: int = 0):
        self.records = list(records)
        self.attempts = attempts
        detail = "; ".join(str(r) for r in self.records)
        super().__init__(message + (f" [{detail}]" if detail else ""))


class DeviceFault(ExecutionError):
    """An accelerator slot failed on the device itself (a CUDA error).

    A CUDA error is sticky for the whole context, so the run is aborted
    rather than contained: the failed range is not re-split onto other
    slots, and request-level retries do not re-run it on that context."""

    retryable = False


class InjectedFault(RuntimeError):
    """Raised inside a slot by the fault injector (crash simulation)."""


# ---------------------------------------------------------------------------
# Deterministic fault injection
# ---------------------------------------------------------------------------

class FaultInjector:
    """Seeded, deterministic fault source shared by both executors.

    Faults are decided per *slot execution* (one call of a slot's work
    function).  Three trigger mechanisms compose:

      * ``crash_prob`` / ``stall_prob`` — i.i.d. per-execution draws from
        a seeded ``numpy`` Generator (bit-for-bit reproducible);
      * ``device_crash_prob`` — per-device overrides, matched against the
        slot's physical device name (``"gpu0/q1"`` matches ``"gpu0"``);
      * ``crash_on_call`` / ``stall_on_call`` — exact Nth-call triggers:
        device name -> collection of 1-based call indices that fault.
        The per-device call counter survives retries, so "fail call 1"
        kills only the first attempt and lets the retry pass.

    ``stall_seconds`` is how long an injected stall blocks (real
    executor) or how much simulated time it adds (simulator) — size it
    above the watchdog deadline to exercise :class:`SlotTimeout`.
    """

    def __init__(self, *, seed: int = 0, crash_prob: float = 0.0,
                 stall_prob: float = 0.0, stall_seconds: float = 1.0,
                 device_crash_prob: Optional[Dict[str, float]] = None,
                 crash_on_call: Optional[Dict[str, Sequence[int]]] = None,
                 stall_on_call: Optional[Dict[str, Sequence[int]]] = None):
        self.rng = np.random.default_rng(seed)
        self.crash_prob = crash_prob
        self.stall_prob = stall_prob
        self.stall_seconds = stall_seconds
        self.device_crash_prob = dict(device_crash_prob or {})
        self.crash_on_call = {k: set(v) for k, v in
                              (crash_on_call or {}).items()}
        self.stall_on_call = {k: set(v) for k, v in
                              (stall_on_call or {}).items()}
        self.calls: Dict[str, int] = {}
        self.injected: List[Tuple[str, str, int]] = []   # (kind, device, call)
        self._lock = threading.Lock()   # slots run concurrently (threaded
        #                                 executor); counters must not race

    @staticmethod
    def _base(device: str) -> str:
        return device.split("/")[0]

    def decide(self, device: str) -> Optional[str]:
        """Fault decision for one slot execution: None|'crash'|'stall'.

        Nth-call triggers are deterministic under any executor; the
        probability draws are additionally bit-for-bit reproducible on the
        (single-threaded) simulator, where the call order is fixed.
        """
        with self._lock:
            return self._decide_locked(device)

    def _decide_locked(self, device: str) -> Optional[str]:
        base = self._base(device)
        n = self.calls.get(base, 0) + 1
        self.calls[base] = n
        kind: Optional[str] = None
        if n in self.crash_on_call.get(base, ()) or \
                n in self.crash_on_call.get(device, ()):
            kind = "crash"
        elif n in self.stall_on_call.get(base, ()) or \
                n in self.stall_on_call.get(device, ()):
            kind = "stall"
        else:
            p_crash = self.device_crash_prob.get(
                base, self.device_crash_prob.get(device, self.crash_prob))
            draw = float(self.rng.random())
            if draw < p_crash:
                kind = "crash"
            elif self.stall_prob and draw < p_crash + self.stall_prob:
                kind = "stall"
        if kind:
            self.injected.append((kind, device, n))
        return kind


# ---------------------------------------------------------------------------
# Retry / repartition policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Retry ladder shared by the threaded executor and the simulator.

    ``watchdog_multiple`` scales ``profile.best_time`` into a per-slot
    deadline (a slot taking > multiple x best-known time is declared
    hung).  When no best time is known yet, ``default_deadline`` applies
    (``None`` disables the watchdog for that run).  ``max_attempts``
    bounds the re-partition/retry rounds before :class:`ExecutionError`.
    """

    max_attempts: int = 3
    watchdog_multiple: float = 8.0
    min_deadline: float = 0.25          # floor — best_time can be tiny
    default_deadline: Optional[float] = None

    def deadline(self, best_time: float) -> Optional[float]:
        if best_time is not None and math.isfinite(best_time) \
                and best_time > 0:
            return max(self.watchdog_multiple * best_time, self.min_deadline)
        return self.default_deadline


def split_units(units: int, n_ways: int) -> List[int]:
    """Largest-remainder even split of a lost slice's domain units."""
    if n_ways <= 0:
        raise ValueError("no surviving slots to split across")
    base, rem = divmod(units, n_ways)
    return [base + (1 if i < rem else 0) for i in range(n_ways)]


# ---------------------------------------------------------------------------
# Device health tracking (Scheduler side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _HealthEntry:
    consecutive_failures: int = 0
    quarantined_at: int = -1            # run index; -1 = healthy
    total_failures: int = 0
    total_successes: int = 0


class DeviceHealth:
    """Consecutive-failure quarantine with probationary reinstatement.

    A device accumulating ``quarantine_after`` consecutive slot faults is
    quarantined: the Scheduler rebuilds ``_slots`` without it (graceful
    degradation to CPU-only or GPU-only).  After ``probe_after`` further
    scheduled runs the device becomes *probationary*: it re-enters the
    slot list with a capped share (``probe_share``); one clean run fully
    reinstates it, another fault re-quarantines it and restarts the
    probation clock.  Failed-run statistics never feed the load balancer
    or the KB, so fault noise cannot corrupt learned profiles.
    """

    def __init__(self, *, quarantine_after: int = 2, probe_after: int = 3,
                 probe_share: float = 0.05):
        self.quarantine_after = quarantine_after
        self.probe_after = probe_after
        self.probe_share = probe_share
        self.runs = 0                   # scheduled-run clock
        self.version = 0                # bumped on quarantine/reinstatement
        self.telemetry = NULL_TELEMETRY
        self._entries: Dict[str, _HealthEntry] = {}
        # concurrent graph nodes observe health from multiple threads;
        # RLock keeps the read-modify-write transitions atomic
        self._lock = threading.RLock()

    def _entry(self, device: str) -> _HealthEntry:
        return self._entries.setdefault(device, _HealthEntry())

    # -- observation ---------------------------------------------------------
    def tick(self) -> None:
        """Advance the run clock (one scheduled execution)."""
        with self._lock:
            self.runs += 1

    def record_failure(self, device: str) -> bool:
        """Register one slot fault; True if the device is now quarantined.

        A quarantine transition is never silent: it is emitted as a
        warning-level event through the telemetry logging bridge (which
        forwards to the ``repro.telemetry`` stdlib logger even when
        telemetry is disabled), carrying the device identity and the
        consecutive-failure count that tripped the threshold."""
        with self._lock:
            e = self._entry(device)
            e.consecutive_failures += 1
            e.total_failures += 1
            self.telemetry.metrics.counter("device_failures_total",
                                           device=device).inc()
            if e.consecutive_failures >= self.quarantine_after:
                if e.quarantined_at < 0:
                    self.version += 1   # slot set changed: plans go stale
                    self.telemetry.metrics.counter("quarantines_total").inc()
                    self.telemetry.events.emit(
                        "health.quarantined", level="warning",
                        message=f"device {device} quarantined after "
                                f"{e.consecutive_failures} "
                                "consecutive failures",
                        device=device,
                        consecutive_failures=e.consecutive_failures,
                        run=self.runs)
                e.quarantined_at = self.runs
                return True
            return False

    def record_success(self, device: str) -> None:
        with self._lock:
            e = self._entry(device)
            was_quarantined = e.quarantined_at >= 0
            e.consecutive_failures = 0
            e.total_successes += 1
            if was_quarantined:
                self.version += 1       # reinstatement: slot set changed
                self.telemetry.metrics.counter("reinstatements_total").inc()
                self.telemetry.events.emit(
                    "health.reinstated", level="warning",
                    message=f"device {device} reinstated after a clean "
                            "probe run",
                    device=device, run=self.runs,
                    total_failures=e.total_failures)
            e.quarantined_at = -1       # clean probe run -> reinstated

    # -- queries -------------------------------------------------------------
    def is_quarantined(self, device: str) -> bool:
        with self._lock:
            e = self._entries.get(device)
            return bool(e and e.quarantined_at >= 0)

    def is_probing(self, device: str) -> bool:
        """Quarantined device due for a probationary probe run."""
        with self._lock:
            e = self._entries.get(device)
            return bool(e and e.quarantined_at >= 0
                        and self.runs - e.quarantined_at >= self.probe_after)

    def usable(self, device: str) -> bool:
        """Device may receive work this run (healthy or probing)."""
        with self._lock:
            return not self.is_quarantined(device) or self.is_probing(device)

    def quarantined(self) -> Set[str]:
        with self._lock:
            return {d for d, e in self._entries.items()
                    if e.quarantined_at >= 0}

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {d: {"consecutive_failures": e.consecutive_failures,
                        "total_failures": e.total_failures,
                        "total_successes": e.total_successes,
                        "quarantined": int(e.quarantined_at >= 0)}
                    for d, e in self._entries.items()}
