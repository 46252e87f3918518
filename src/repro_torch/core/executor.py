"""Task launcher / executor — real partitioned execution on a CPU + GPU host.

The Scheduler produces a :class:`ConcretePartitioning`; the executor turns
it into a group of tasks (one per execution slot, paper Fig. 2/3), places
them in per-slot work queues (one worker thread per slot device), runs the
SCT over each partition, and merges the partial results:

  * partitionable outputs — assembled along their partition dimension
    (the partitions tile the domain, paper Sec. 3.1);
  * COPY / replicated outputs — taken from the first slot;
  * reduced outputs — combined with the kernel-declared or user-supplied
    *merging function* (paper Sec. 3.4; MERGE_ADD & friends).

``Size`` / ``Offset`` traits are bound per-slot through the environment's
``__partition__`` entry.

Devices
-------
Host fission slots (``device_type == "cpu"``) run the SCT on CPU tensors
that are views of the caller's arrays.  Accelerator slots run on CUDA
unless the executor was built with ``device="cpu"`` (then they run on the
host too, as threads, like the fission slots); without a CUDA device and
without that request, the constructor raises — nothing falls back to the
CPU.  On CUDA, each ``gpuN/qK`` work queue owns one ``torch.cuda.Stream``
on ``cuda:N`` (the paper's GPU multi-buffering: one queue's copies overlap
another's kernels).  For each segment its worker, inside that stream:

  1. copies the segment's inputs host→device with ``non_blocking=True``
     from pinned memory (a caller's pinned tensor directly, anything else
     through a pinned staging buffer);
  2. runs the SCT body, whose kernels launch on the current stream;
  3. copies each output device→host straight into its slice of the
     pinned merge buffer, where the output's shape is known;
  4. synchronises the stream before reporting the segment done.

Host-side public data are CPU tensors; numpy arrays given at the edges
are wrapped with :func:`from_numpy` (no copy).

Locality / zero-copy pipeline
-----------------------------
Recurrent runs of the same (SCT, workload) are the serving-loop regime the
paper's data-locality results target, so the hot path amortises every
per-dispatch cost:

  * **persistent worker pool** — created once, reused across runs and
    retry attempts, torn down by :meth:`ThreadedExecutor.close` (called
    from ``Session.shutdown``).  The pool is only re-created after a
    watchdog timeout, since a hung thread can never be reclaimed.
  * **zero-copy segment environments** — per-slot input slices are tensor
    views into the caller's arrays, never copies (accelerator slots copy
    their slice to the card, and only their slice).
  * **in-place merge** — partitionable outputs are written by each slot
    directly into a preallocated, shape-keyed output buffer (pinned host
    memory when a card is used) that is reused across runs; the merge
    phase then copies zero bytes.  The
    first run of a new output shape falls back to one packing copy while
    the buffer is learned.  *Consequence*: the arrays returned by one
    ``execute`` are overwritten by the next run on the same executor —
    callers that retain outputs across runs must copy them (or construct
    the executor with ``reuse_buffers=False``).
  * **partitioned residency** — ``execute(..., keep_resident=True)``
    skips the merge entirely and hands back a :class:`ResidentPartition`
    whose slot-local outputs feed the next SCT's slot-local inputs
    (``execute(..., resident=...)``), eliminating the merge→re-split
    round trip between the kernels of a compound chain (the paper's
    inter-kernel locality rule).  Whenever the next run's partitioning
    differs — other slots/shares, other partition dims or epu, or a
    fault-repartitioned layout — the handle transparently *materialises*
    (full merge) and the run proceeds on the safe path.  On a card the
    handle keeps accelerator-slot outputs in device memory between chain
    steps (the paper's "persist data on the device" rule); a consumer on
    another stream waits on the producer's event and records its stream
    on the tensor.

Merge precedence (per output name): 1. a user-supplied merge function in
``ThreadedExecutor.merges`` — honoured even when the output is also
partitionable; 2. in-place assembly along the partition dim for
partitionable outputs; 3. first slot's value for COPY / scalar outputs.
Direct slot writes assume deterministic kernels (a timed-out slot retried
elsewhere re-produces the same bytes); merged results are bit-identical
to the historical ``torch.cat`` merge.

Failure semantics
-----------------
Execution is tracked per *segment* — a contiguous domain-unit range bound
to one slot (initially one segment per slot).  A slot that raises is
contained: its exception becomes a :class:`~repro_torch.core.faults.FaultRecord`
instead of crashing the run, the slot is considered dead for the rest of
the request, and its segment is re-split across the surviving slots and
retried (bounded by :class:`~repro_torch.core.faults.FaultPolicy.max_attempts`).
A per-slot watchdog deadline — ``watchdog_multiple x profile.best_time``
— declares stalled slots hung (:class:`~repro_torch.core.faults.SlotTimeout`
semantics; note a hung *thread* cannot be killed in Python, only
abandoned — the persistent pool and the output buffers are retired after
a timeout so an abandoned thread can never touch a later run's state).
When retries are exhausted or no slot survives, a terminal
:class:`~repro_torch.core.faults.ExecutionError` carries the full per-slot
fault history.  Because retried segments tile the lost unit range in
domain order, merged outputs are bit-identical to the fault-free result
for concatenated outputs, and identical for associative merge functions.

Containment covers Python-level faults: injected crashes and stalls, and
exceptions raised by a body on a host slot.  A failure of an accelerator
slot on CUDA that was not injected — a kernel that faulted or was
refused, an illegal address, a wrapper that rejected its inputs — is a
*device fault*: a CUDA error is sticky for the whole context, so the run
aborts with :class:`~repro_torch.core.faults.DeviceFault` (an
``ExecutionError``) and is neither re-split onto other slots nor retried
on that context.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import functools
import math

import numpy as np
import torch

from repro_torch.core.decomposition import ConcretePartitioning
from repro_torch.core.faults import (DeviceFault, ExecutionError,
                                     FaultInjector, FaultPolicy, FaultRecord,
                                     InjectedFault, split_units)
from repro_torch.core.graph import GraphHandle, GraphResult, JobGraph
from repro_torch.core.knowledge_base import Profile
from repro_torch.core.platforms import cuda_index
from repro_torch.core.skeletons import SCT, PartitionInfo
from repro_torch.core.spec import ArgSpec, MergeFn, Transfer, Workload
from repro_torch.core.telemetry import NULL_TELEMETRY, Telemetry


def from_numpy(value: Any) -> Any:
    """The port's form of a reference input: a numpy array becomes a CPU
    tensor sharing its memory, a dict is mapped over its values, anything
    else (scalars, tensors) is returned as it is."""
    if isinstance(value, dict):
        return {k: from_numpy(v) for k, v in value.items()}
    if isinstance(value, np.ndarray):
        return torch.from_numpy(value)
    return value


def resolve_device(device: Optional[str]) -> torch.device:
    """Where accelerator slots run: CUDA unless ``"cpu"`` is asked for.

    Raises when CUDA is wanted (explicitly or by default) and no CUDA
    device is present — there is no silent fallback to the CPU."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "accelerator slots run on CUDA and no CUDA device is available; "
            "pass device='cpu' to run them on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def output_spec(sct: SCT, name: str) -> Optional[ArgSpec]:
    for leaf in sct.leaves():
        for a in leaf.spec.outputs:
            if a.name == name:
                return a
    return None


@dataclasses.dataclass
class ExecResult:
    """Everything one ``execute`` call produced, as a per-call value.

    Concurrent graph nodes share one executor, so per-call results must
    travel with the call instead of through mutable ``last_*`` fields
    (which remain, updated by :meth:`ThreadedExecutor.execute`, for
    sequential callers and older integrations).
    """

    outputs: Dict[str, Any]
    times: List[float]                      # per-slot busy seconds
    failures: List[FaultRecord]
    retries: int
    timing: Dict[str, float]                # pool/compute/merge/dispatch
    merge_bytes: int
    direct_bytes: int
    resident: Optional["ResidentPartition"]
    n_a: int                                # accelerator-class slot count


@dataclasses.dataclass
class _SlotResult:
    outputs: Dict[str, Any]
    seconds: float
    written: frozenset = frozenset()    # outputs direct-written to buffers
    event: Optional[Any] = None         # CUDA event after the slot's work


@dataclasses.dataclass
class _Segment:
    """A contiguous domain-unit range assigned to one execution slot."""

    slot: int                   # index into part.slots
    start: int                  # domain-unit offset of the range
    units: int                  # domain units in the range


@dataclasses.dataclass
class _OutputTarget:
    """Preallocated destination for one partitionable output."""

    buffer: torch.Tensor
    axis: int
    epu: int


@dataclasses.dataclass
class ResidentPartition:
    """Slot-resident outputs of one SCT run over a concrete partitioning.

    Holds one environment per realised segment, restricted to produced
    (and inherited) vector names, so a back-to-back run over the *same*
    domain decomposition can consume them slot-locally without the
    merge→re-split round trip.  ``meta`` records each resident vector's
    ``(partition_dim, epu)``; ``extras`` carries non-partitionable
    results (reduced / COPY / user-merged outputs and values carried
    forward from earlier chain steps) as whole arrays.

    ``compatible`` gates the zero-copy handoff; on any mismatch the
    consumer calls :meth:`materialize` and falls back to the full-merge
    path, so chaining is never less correct than merging.

    Accelerator-slot values stay in device memory; ``events[i]`` is the
    CUDA event recorded on segment ``i``'s stream after it produced them
    (``None`` for host segments), which a consumer on another stream
    waits on.
    """

    part: ConcretePartitioning
    layout: Tuple[Tuple[int, int], ...]     # realised (start, units) ranges
    envs: List[Dict[str, Any]]              # slot-local tensors per segment
    meta: Dict[str, Tuple[int, int]]        # name -> (axis, epu)
    extras: Dict[str, Any]                  # whole-array results
    executor: "ThreadedExecutor"
    sct: SCT
    events: List[Optional[Any]] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self._index = {rng: i for i, rng in enumerate(self.layout)}

    # -- zero-copy handoff --------------------------------------------------
    def compatible(self, part: ConcretePartitioning) -> bool:
        """True when ``part`` can consume the resident data slot-locally."""
        if not self.part.same_layout(part):
            return False
        if self.layout != part.layout():
            return False                    # fault-repartitioned realisation
        for name, (axis, epu) in self.meta.items():
            vp = part.plan.vectors.get(name)
            if vp is None:
                continue                    # next SCT does not touch it
            if vp.copy or vp.partition_dim != axis or vp.epu != epu:
                return False
        return True

    def segment_env(self, start: int, units: int
                    ) -> Tuple[Dict[str, Any], Optional[Any]]:
        """Slot-local resident values covering one segment range, and the
        producer's CUDA event (``None`` for a host producer).

        Exact layout matches return the stored environment; sub-ranges —
        the fault path re-splits a lost segment across survivors — are
        served as views into the covering segment's tensors, so retries
        stay zero-copy and bit-identical."""
        i = self._index.get((start, units))
        if i is not None:
            return self.envs[i], self._event(i)
        for (s0, u0), j in self._index.items():
            if s0 <= start and start + units <= s0 + u0:
                out: Dict[str, Any] = {}
                for name, v in self.envs[j].items():
                    axis, epu = self.meta[name]
                    off = (start - s0) * epu
                    idx = [slice(None)] * v.ndim
                    idx[axis] = slice(off, off + units * epu)
                    out[name] = v[tuple(idx)]
                return out, self._event(j)
        return {}, None

    def _event(self, i: int) -> Optional[Any]:
        return self.events[i] if i < len(self.events) else None

    # -- introspection ------------------------------------------------------
    def names(self) -> List[str]:
        seen = dict.fromkeys(self.meta)
        seen.update(dict.fromkeys(self.extras))
        return list(seen)

    def shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Global (merged) shapes of every resident vector."""
        out: Dict[str, Tuple[int, ...]] = {}
        for name, (axis, _) in self.meta.items():
            parts = [e[name] for e in self.envs if name in e]
            if not parts:
                continue
            shape = list(parts[0].shape)
            shape[axis] = sum(int(p.shape[axis]) for p in parts)
            out[name] = tuple(shape)
        for name, v in self.extras.items():
            if hasattr(v, "shape"):
                out[name] = tuple(v.shape)
        return out

    # -- safe fallback ------------------------------------------------------
    def materialize(self) -> Dict[str, Any]:
        """Full merge of the resident outputs into host tensors (the safe
        fallback; device-resident parts are copied device→host)."""
        merged, _ = self.materialize_counted()
        return merged

    def materialize_counted(self) -> Tuple[Dict[str, Any], int]:
        # assemble along each vector's own recorded axis (never via the
        # current SCT's specs — carried vectors may not appear in them)
        merged: Dict[str, Any] = {}
        nbytes = 0
        for name, (axis, _) in self.meta.items():
            parts = [e[name] for e in self.envs if name in e]
            if not parts:
                continue
            out = torch.cat([_tensor(p).cpu() for p in parts], dim=axis)
            merged[name] = out
            nbytes += _nbytes(out)
        merged.update(self.extras)
        return merged, nbytes


class ThreadedExecutor:
    """Executes SCT partitions on host threads and CUDA streams, and times
    each slot.

    ``device`` is where accelerator slots run: ``None`` (CUDA, raising
    when there is none), ``"cuda"``/``"cuda:N"``, or ``"cpu"`` (host
    threads, as the fission slots).  A slot named ``gpuN/qK`` runs on
    ``cuda:N`` in its own stream.

    ``injector`` (optional) deterministically injects crashes/stalls for
    fault-tolerance experiments; ``policy`` bounds the retry ladder and
    derives the watchdog deadline (see module docstring).

    ``persistent_pool`` / ``inplace_merge`` / ``reuse_buffers`` gate the
    locality optimisations; all default on.  Disabling them restores the
    historical per-attempt pool and ``torch.cat`` merge — useful as
    the baseline leg of ``benchmarks/locality.py`` and for callers that
    must retain outputs across runs without copying.
    """

    supports_residency = True

    def __init__(self, *, merges: Optional[Dict[str, MergeFn]] = None,
                 max_workers: Optional[int] = None,
                 injector: Optional[FaultInjector] = None,
                 policy: FaultPolicy = FaultPolicy(),
                 persistent_pool: bool = True,
                 inplace_merge: bool = True,
                 reuse_buffers: bool = True,
                 telemetry: Optional[Telemetry] = None,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self.telemetry = telemetry or NULL_TELEMETRY
        self.merges = dict(merges or {})
        self.max_workers = max_workers
        self.injector = injector
        self.policy = policy
        self.persistent_pool = persistent_pool
        self.inplace_merge = inplace_merge
        self.reuse_buffers = reuse_buffers
        self._last_times: List[float] = []
        self._last_n_a: int = 0
        self.last_failures: List[FaultRecord] = []
        self.last_retries: int = 0
        self.last_timing: Dict[str, float] = {}
        self.last_merge_bytes: int = 0
        self.last_direct_bytes: int = 0
        self.last_resident: Optional[ResidentPartition] = None
        self.pools_created: int = 0
        self.pool_reuses: int = 0
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._pool_size: int = 0
        self._queues: Dict[str, cf.ThreadPoolExecutor] = {}
        self._queue_lock = threading.Lock()
        self._buf_lock = threading.Lock()
        self._inuse: set = set()            # id() of buffers leased to a run
        self._buffers: Dict[Tuple[str, Tuple[int, ...], str],
                            torch.Tensor] = {}
        self._out_shapes: Dict[Tuple[str, str],
                               Tuple[Tuple[int, ...], torch.dtype]] = {}
        self._streams: Dict[str, Any] = {}  # accelerator queue -> stream

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Tear down pools / work queues and drop reusable buffers.

        Idempotent: a second ``close`` (double ``Session.shutdown``, a
        context-manager exit after an explicit shutdown) is a no-op."""
        self._retire_pool()
        self._retire_queues()
        with self._buf_lock:
            self._buffers = {}
            self._inuse = set()
        self._out_shapes = {}
        with self._queue_lock:
            streams, self._streams = list(self._streams.values()), {}
        for s in streams:
            s.synchronize()

    def _retire_pool(self) -> None:
        if self._pool is not None:
            # abandon hung threads instead of joining them (a stalled slot
            # must not block shutdown or the retry round)
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
            self._pool_size = 0

    def _retire_queues(self, devices: Optional[Sequence[str]] = None) -> None:
        """Retire all per-device work queues, or just the given devices
        (a hung slot taints only its own device's queue)."""
        with self._queue_lock:
            names = list(self._queues) if devices is None \
                else [d for d in devices if d in self._queues]
            doomed = [self._queues.pop(d) for d in names]
        for q in doomed:
            q.shutdown(wait=False, cancel_futures=True)

    def _acquire_pool(self, n: int) -> cf.ThreadPoolExecutor:
        with self.telemetry.tracer.span("pool", workers=n) as sp:
            if self._pool is not None and self._pool_size < n:
                self._retire_pool()
            if self._pool is None:
                self._pool = cf.ThreadPoolExecutor(max_workers=n)
                self._pool_size = n
                self.pools_created += 1
                self.telemetry.metrics.counter("pools_created_total").inc()
                sp.note(created=True)
            else:
                self.pool_reuses += 1
                self.telemetry.metrics.counter("pool_reuses_total").inc()
        return self._pool

    def _acquire_queues(self, devices: Sequence[str]
                        ) -> Dict[str, cf.ThreadPoolExecutor]:
        """Per-device work queues (paper Fig. 2): one single-worker pool
        per execution-slot device, shared by every concurrent run.  Two
        segments bound to the same device serialise in its queue;
        segments on disjoint devices genuinely overlap — including
        segments of *different* graph nodes."""
        with self.telemetry.tracer.span("pool", workers=len(devices)) as sp:
            created = False
            with self._queue_lock:
                for d in devices:
                    if d not in self._queues:
                        self._queues[d] = cf.ThreadPoolExecutor(
                            max_workers=1,
                            thread_name_prefix=f"wq-{d.replace('/', '-')}")
                        created = True
                qmap = {d: self._queues[d] for d in devices}
            if created:
                self.pools_created += 1
                self.telemetry.metrics.counter("pools_created_total").inc()
                sp.note(created=True)
            else:
                self.pool_reuses += 1
                self.telemetry.metrics.counter("pool_reuses_total").inc()
        return qmap

    # -- Scheduler interface -------------------------------------------------
    def execute(self, sct: SCT, part: ConcretePartitioning,
                arrays: Dict[str, Any], profile: Profile, *,
                resident: Optional[ResidentPartition] = None,
                keep_resident: bool = False
                ) -> Tuple[Dict[str, Any], List[float]]:
        """Sequential-caller facade: runs and publishes the ``last_*``
        observation fields (not safe under concurrent callers — those go
        through :meth:`execute_result`)."""
        res = self.execute_result(sct, part, arrays, profile,
                                  resident=resident,
                                  keep_resident=keep_resident)
        self._last_times = res.times
        self._last_n_a = res.n_a
        self.last_failures = res.failures
        self.last_retries = res.retries
        self.last_timing = res.timing
        self.last_merge_bytes = res.merge_bytes
        self.last_direct_bytes = res.direct_bytes
        self.last_resident = res.resident
        return res.outputs, res.times

    def execute_result(self, sct: SCT, part: ConcretePartitioning,
                       arrays: Dict[str, Any], profile: Profile, *,
                       resident: Optional[ResidentPartition] = None,
                       keep_resident: bool = False) -> ExecResult:
        """Execute one partitioned run and return a per-call result.

        Thread-safe: concurrent graph nodes share the per-device work
        queues and the buffer pool (leased per call), and nothing about
        this call is observed through shared mutable state."""
        with self.telemetry.tracer.span(
                "dispatch", sct=sct.unique_id(), slots=len(part.slots),
                keep_resident=keep_resident) as sp:
            res = self._execute(
                sct, part, arrays, profile, resident=resident,
                keep_resident=keep_resident)
            sp.note(retries=res.retries,
                    merge_bytes=res.merge_bytes,
                    resident=res.resident is not None)
            return res

    def _execute(self, sct: SCT, part: ConcretePartitioning,
                 arrays: Dict[str, Any], profile: Profile, *,
                 resident: Optional[ResidentPartition] = None,
                 keep_resident: bool = False) -> ExecResult:
        leases: List[torch.Tensor] = []   # buffers leased to this call
        try:
            return self._execute_leased(sct, part, arrays, profile, leases,
                                        resident=resident,
                                        keep_resident=keep_resident)
        finally:
            # end of the run releases its buffer leases: the *next* run may
            # overwrite the returned arrays (the documented aliasing
            # contract), but a *concurrent* run never shares them
            if leases:
                with self._buf_lock:
                    for b in leases:
                        self._inuse.discard(id(b))

    def _execute_leased(self, sct: SCT, part: ConcretePartitioning,
                        arrays: Dict[str, Any], profile: Profile,
                        leases: List[torch.Tensor], *,
                        resident: Optional[ResidentPartition] = None,
                        keep_resident: bool = False) -> ExecResult:
        t_run0 = time.perf_counter()
        arrays = from_numpy(arrays)
        pool_sec = [0.0]                # mutable: charged by _run_attempt
        merge_bytes = 0
        deadline = self.policy.deadline(getattr(profile, "best_time", None))

        inherited_extras: Dict[str, Any] = {}
        if resident is not None:
            if resident.compatible(part):
                inherited_extras.update(resident.extras)
            else:
                # safe fallback: partition dims / shares / layout differ
                materialized, nbytes = resident.materialize_counted()
                merge_bytes += nbytes
                inherited_extras.update(materialized)
                arrays = {**arrays, **materialized}
                resident = None

        segments = [_Segment(slot=j, start=s, units=u)
                    for j, (s, u) in enumerate(part.layout())]

        targets: Dict[str, _OutputTarget] = {}
        if self.inplace_merge and not keep_resident:
            targets = self._output_targets(sct, part, leases)

        records: List[FaultRecord] = []
        retries = 0
        dead: set = set()
        done: List[Tuple[_Segment, _SlotResult]] = []
        per_slot_seconds = [0.0] * len(part.slots)

        tel = self.telemetry
        attempts_seconds = 0.0
        pending = segments
        for attempt in range(self.policy.max_attempts):
            t_a0 = time.perf_counter()
            with tel.tracer.span("attempt", attempt=attempt,
                                 segments=len(pending)) as att_span:
                outcomes = self._run_attempt(sct, part, arrays, pending,
                                             deadline, attempt, resident,
                                             targets, pool_sec)
                attempts_seconds += time.perf_counter() - t_a0
                failed: List[_Segment] = []
                for seg, res in zip(pending, outcomes):
                    per_slot_seconds[seg.slot] += res.seconds
                    if isinstance(res, FaultRecord):
                        records.append(res)
                        dead.add(seg.slot)
                        failed.append(seg)
                        tel.metrics.counter("faults_total",
                                            kind=res.kind).inc()
                        tel.events.emit(
                            "fault", level="warning", message=res.message,
                            device=res.device, fault_kind=res.kind,
                            attempt=res.attempt, slot=res.slot)
                    else:
                        done.append((seg, res))
                att_span.note(faults=len(failed))
            if any(r.kind == "device" for r in records):
                # sticky CUDA context: abort, never re-split or retry
                raise DeviceFault(
                    "device fault on an accelerator slot: the run is "
                    "aborted and not retried on this CUDA context",
                    records, attempt + 1)
            lost = [s for s in failed if s.units > 0]
            if not lost:
                break
            alive = [j for j in range(len(part.slots)) if j not in dead]
            if not alive:
                raise ExecutionError(
                    "partition lost: no surviving execution slot can adopt "
                    f"{sum(s.units for s in lost)} domain units",
                    records, attempt + 1)
            if attempt == self.policy.max_attempts - 1:
                raise ExecutionError(
                    f"retries exhausted after {self.policy.max_attempts} "
                    "attempts", records, attempt + 1)
            # re-split each lost range across the surviving slots, in
            # domain order, so the merged result stays bit-identical
            pending = []
            for seg in lost:
                counts = split_units(seg.units, len(alive))
                start = seg.start
                for j, u in zip(alive, counts):
                    if u:
                        pending.append(_Segment(slot=j, start=start, units=u))
                        start += u
            retries += 1
            tel.events.emit("retry.repartition",
                            lost_units=sum(s.units for s in lost),
                            survivors=len(alive), attempt=attempt)

        if any(r.kind == "timeout" for r in records):
            # an abandoned hung thread may still write into the current
            # buffers — retire them so later runs get untainted memory
            with self._buf_lock:
                self._buffers = {}
            tel.events.emit("buffers.dropped", level="warning",
                            message="output buffers retired after a slot "
                                    "timeout (hung-thread containment)")

        done.sort(key=lambda sr: sr[0].start)
        clean = retries == 0 and not records
        t_m0 = time.perf_counter()
        resident_out: Optional[ResidentPartition] = None
        direct_bytes = 0
        if keep_resident and clean:
            with tel.tracer.span("resident-handoff", segments=len(done)):
                resident_out = self._make_resident(
                    sct, part, done, resident, inherited_extras)
            outputs: Dict[str, Any] = {}
        else:
            with tel.tracer.span("merge") as merge_span:
                outputs, copied, direct_bytes = self._merge(
                    sct, part, done, targets, leases)
                merge_span.note(merge_bytes=copied)
            merge_bytes += copied
            if inherited_extras and keep_resident:
                # chain fallback: surface carried values with the merge
                outputs = {**inherited_extras, **outputs}
        merge_seconds = time.perf_counter() - t_m0

        times = per_slot_seconds
        total = time.perf_counter() - t_run0
        compute = max(attempts_seconds - pool_sec[0], 0.0)
        timing = {
            "pool": pool_sec[0],
            "compute": compute,
            "merge": merge_seconds,
            "dispatch": max(total - attempts_seconds - merge_seconds, 0.0),
        }
        return ExecResult(
            outputs=outputs, times=times, failures=records, retries=retries,
            timing=timing, merge_bytes=merge_bytes,
            direct_bytes=direct_bytes, resident=resident_out,
            n_a=sum(1 for s in part.slots if s.device_type != "cpu"))

    def _run_attempt(self, sct: SCT, part: ConcretePartitioning,
                     arrays: Dict[str, Any], segments: Sequence[_Segment],
                     deadline: Optional[float], attempt: int,
                     resident: Optional[ResidentPartition] = None,
                     targets: Optional[Dict[str, _OutputTarget]] = None,
                     pool_sec: Optional[List[float]] = None
                     ) -> List[Union[_SlotResult, FaultRecord]]:
        """Run one round of segments concurrently, containing all faults."""
        targets = targets or {}
        pool_sec = pool_sec if pool_sec is not None else [0.0]

        def work(seg: _Segment) -> Union[_SlotResult, FaultRecord]:
            slot = part.slots[seg.slot]
            on_card = self._on_card(slot.device_type)
            t0 = time.perf_counter()
            with self.telemetry.tracer.span(
                    "slot", device=slot.device, units=seg.units,
                    offset=seg.start, attempt=attempt) as sp:
                try:
                    if self.injector is not None:
                        kind = self.injector.decide(slot.device)
                        if kind == "crash":
                            raise InjectedFault(
                                f"injected crash on {slot.device}")
                        if kind == "stall":
                            time.sleep(self.injector.stall_seconds)
                    if on_card:
                        out_env, written, event = self._run_on_card(
                            sct, part, arrays, seg, resident, targets,
                            slot.device)
                    else:
                        env = self._segment_env(part, arrays, seg, resident)
                        out_env = sct.apply(env)
                        written = self._direct_write(out_env, seg, targets)
                        event = None
                    return _SlotResult(out_env, time.perf_counter() - t0,
                                       written, event)
                except Exception as e:   # containment: never crosses the slot
                    sp.note(fault=type(e).__name__)
                    device_fault = on_card and not isinstance(e, InjectedFault)
                    return FaultRecord(
                        slot=seg.slot, device=slot.device,
                        device_type=slot.device_type,
                        kind="device" if device_fault else "crash",
                        attempt=attempt,
                        message=f"{type(e).__name__}: {e}",
                        seconds=time.perf_counter() - t0)

        if deadline is None and len(segments) == 1:
            return [work(segments[0])]

        # three dispatch modes: per-device work queues (default), one
        # shared persistent pool (explicit max_workers), per-run pool
        # (persistent_pool=False, the historical baseline)
        use_queues = self.persistent_pool and self.max_workers is None
        t0 = time.perf_counter()
        pool: Optional[cf.ThreadPoolExecutor] = None
        if use_queues:
            qmap = self._acquire_queues(
                list(dict.fromkeys(part.slots[seg.slot].device
                                   for seg in segments)))
        elif self.persistent_pool:
            pool = self._acquire_pool(self.max_workers)
        else:
            pool = cf.ThreadPoolExecutor(
                max_workers=self.max_workers or max(len(segments), 1))
        pool_sec[0] += time.perf_counter() - t0
        hung: set = set()
        try:
            if use_queues:
                futs = {qmap[part.slots[seg.slot].device].submit(work, seg): i
                        for i, seg in enumerate(segments)}
            else:
                futs = {pool.submit(work, seg): i
                        for i, seg in enumerate(segments)}
            done_f, hung = cf.wait(futs, timeout=deadline)
            outcomes: List[Union[_SlotResult, FaultRecord]] = \
                [None] * len(segments)  # type: ignore[list-item]
            for f in done_f:
                outcomes[futs[f]] = f.result()
            for f in hung:
                seg = segments[futs[f]]
                slot = part.slots[seg.slot]
                f.cancel()
                outcomes[futs[f]] = FaultRecord(
                    slot=seg.slot, device=slot.device,
                    device_type=slot.device_type, kind="timeout",
                    attempt=attempt,
                    message=f"watchdog: no completion within {deadline:.3f}s",
                    seconds=float(deadline or 0.0))
            return outcomes
        finally:
            # abandon hung threads instead of joining them (a stalled
            # slot must not block the retry round); a tainted persistent
            # pool / device queue is recreated on next acquisition
            if use_queues:
                if hung:
                    self._retire_queues(
                        {part.slots[segments[futs[f]].slot].device
                         for f in hung})
            elif not self.persistent_pool:
                pool.shutdown(wait=False, cancel_futures=True)
            elif hung:
                self._retire_pool()

    def _segment_env(self, part: ConcretePartitioning, arrays: Dict[str, Any],
                     seg: _Segment,
                     resident: Optional[ResidentPartition] = None,
                     device: Optional[torch.device] = None
                     ) -> Dict[str, Any]:
        """Per-segment environment: slice every partitionable vector to the
        segment's unit range (each slice a zero-copy view, with its own
        epu); replicate the rest.  Resident slot-local values, when
        given, shadow both and skip the slicing entirely.

        With a CUDA ``device`` (an accelerator slot, called inside its
        stream) every tensor is moved there: host slices are copied
        host→device asynchronously, resident tensors already on the card
        are used in place.  Without one (a host slot) resident tensors on
        a card are copied back to the host."""
        plan = part.plan
        env: Dict[str, Any] = {}
        res_env: Optional[Dict[str, Any]] = None
        res_event = None
        source = arrays
        if resident is not None:
            res_env, res_event = resident.segment_env(seg.start, seg.units)
            if resident.extras:
                source = {**arrays, **resident.extras}
        for name, arr in source.items():
            if res_env is not None and name in res_env:
                continue
            vp = plan.vectors.get(name)
            if vp is None:
                env[name] = arr     # no vector of this SCT: never moved
                continue
            if not vp.copy:
                off = seg.start * vp.epu
                size = seg.units * vp.epu
                idx = [slice(None)] * arr.ndim
                idx[vp.partition_dim] = slice(off, off + size)
                arr = arr[tuple(idx)]       # view, not a copy
            env[name] = _to_device(arr, device)
        if res_env:
            if device is not None and res_event is not None:
                # the producer ran on another stream (or this one): order
                # this stream after it, and keep the allocator from
                # reusing the memory while this stream still reads it
                torch.cuda.current_stream().wait_event(res_event)
            for name, v in res_env.items():
                if name not in plan.vectors:
                    env[name] = v   # carried along, not read here
                elif device is not None and isinstance(v, torch.Tensor) \
                        and v.device == device:
                    v.record_stream(torch.cuda.current_stream())
                    env[name] = v
                else:
                    env[name] = _to_device(v, device)
        witness = next((v for v in plan.vectors.values() if not v.copy), None)
        if witness is not None:
            env["__partition__"] = PartitionInfo(
                size=seg.units * witness.epu,
                offset=seg.start * witness.epu)
        return env

    # -- accelerator slots -----------------------------------------------------
    def _on_card(self, device_type: str) -> bool:
        return device_type != "cpu" and self.device.type == "cuda"

    def _stream(self, slot_device: str):
        """The CUDA stream owned by one accelerator work queue."""
        with self._queue_lock:
            s = self._streams.get(slot_device)
            if s is None:
                index = cuda_index(slot_device.split("/")[0])
                s = torch.cuda.Stream(device=index)
                self._streams[slot_device] = s
            return s

    def _run_on_card(self, sct: SCT, part: ConcretePartitioning,
                     arrays: Dict[str, Any], seg: _Segment,
                     resident: Optional[ResidentPartition],
                     targets: Dict[str, _OutputTarget], slot_device: str):
        """One segment on an accelerator slot, inside its queue's stream:
        inputs host→device, the body's kernels, outputs device→host into
        the pinned merge buffers, then a stream synchronise."""
        stream = self._stream(slot_device)
        with torch.cuda.stream(stream):
            env = self._segment_env(part, arrays, seg, resident,
                                    device=stream.device)
            out_env = sct.apply(env)
            written = self._direct_write(out_env, seg, targets)
            event = torch.cuda.Event()
            event.record(stream)
        stream.synchronize()
        return out_env, written, event

    def last_class_times(self) -> Tuple[float, float]:
        n_a = self._last_n_a
        t = self._last_times
        ta = max(t[:n_a]) if n_a else 0.0
        tb = max(t[n_a:]) if len(t) > n_a else 0.0
        return ta, tb

    def synthesise_arrays(self, sct: SCT, workload: Workload
                          ) -> Dict[str, Any]:
        """Random tensors matching a workload (Algorithm 1 evaluations),
        from a generator seeded with 0."""
        gen = torch.Generator().manual_seed(0)
        out: Dict[str, Any] = {}
        for a in sct.free_inputs():
            if a.kind == "scalar":
                out[a.name] = 1.0
            else:
                out[a.name] = torch.randn(workload.dims, generator=gen,
                                          dtype=torch.float32)
        return out

    # -- output buffers / direct slot writes ----------------------------------
    def _axis_epu(self, sct: SCT, part: ConcretePartitioning,
                  name: str) -> Optional[Tuple[int, int]]:
        """(partition_dim, epu) of a partitionable output, else None."""
        vp = part.plan.vectors.get(name)
        if vp is not None:
            return None if vp.copy else (vp.partition_dim, vp.epu)
        spec = output_spec(sct, name)
        if spec is not None and spec.partitionable:
            return (spec.partition_dim, spec.epu)
        return None

    def _get_buffer(self, name: str, shape: Tuple[int, ...],
                    dtype: torch.dtype, leases: List[torch.Tensor]
                    ) -> torch.Tensor:
        """Lease a reusable output buffer to the calling run.

        A buffer leased to a still-running concurrent call is never
        handed out again; the requester gets a fresh allocation instead
        (stored as the new cached buffer).  Leases are released at the
        end of ``_execute`` — preserving the sequential aliasing
        contract (the next run may overwrite returned arrays) while
        overlapping runs stay isolated."""
        key = (name, tuple(shape), str(dtype))
        with self._buf_lock:
            buf = self._buffers.get(key)
            if buf is not None and id(buf) in self._inuse:
                buf = None              # leased to a concurrent run
            if buf is None:
                buf = torch.empty(shape, dtype=dtype, pin_memory=self._pin)
                if self.reuse_buffers:
                    self._buffers[key] = buf
            if self.reuse_buffers:
                self._inuse.add(id(buf))
                leases.append(buf)
        return buf

    def _output_targets(self, sct: SCT, part: ConcretePartitioning,
                        leases: List[torch.Tensor]
                        ) -> Dict[str, _OutputTarget]:
        """Preallocated destinations for outputs whose shape is known.

        Shapes are learned from the first run of each (SCT, output); from
        then on slots write their partition directly into the shared
        buffer and the merge phase copies zero bytes."""
        targets: Dict[str, _OutputTarget] = {}
        sid = sct.unique_id()
        for name in _produced_names(sct):
            if name in self.merges:
                continue        # user merge fn takes precedence: no buffer
            ae = self._axis_epu(sct, part, name)
            if ae is None:
                continue
            axis, epu = ae
            known = self._out_shapes.get((sid, name))
            if known is None:
                continue
            shape, dtype = known
            if axis >= len(shape) or \
                    shape[axis] != part.plan.domain_units * epu:
                continue        # workload changed: re-learn on this run
            targets[name] = _OutputTarget(
                buffer=self._get_buffer(name, shape, dtype, leases),
                axis=axis, epu=epu)
        return targets

    def _direct_write(self, out_env: Dict[str, Any], seg: _Segment,
                      targets: Dict[str, _OutputTarget]) -> frozenset:
        """Write this segment's partitionable outputs straight into the
        preallocated buffers (zero-copy merge); returns the names written.
        A CUDA output is copied device→host asynchronously on the current
        stream, which the slot synchronises before it reports done."""
        if not targets:
            return frozenset()
        written = set()
        for name, tg in targets.items():
            v = out_env.get(name)
            if v is None or getattr(v, "ndim", 0) < 1:
                continue
            v = _tensor(v)
            expect = seg.units * tg.epu
            if v.shape[tg.axis] != expect:
                continue        # kernel reshaped the output: merge-path copy
            idx = [slice(None)] * tg.buffer.ndim
            off = seg.start * tg.epu
            idx[tg.axis] = slice(off, off + expect)
            dst = tg.buffer[tuple(idx)]
            if v.shape != dst.shape:
                continue
            dst.copy_(v, non_blocking=v.is_cuda)   # one copy into place
            written.add(name)
        return frozenset(written)

    # -- merging ---------------------------------------------------------------
    def _merge(self, sct: SCT, part: ConcretePartitioning,
               done: Sequence[Tuple[_Segment, _SlotResult]],
               targets: Optional[Dict[str, _OutputTarget]] = None,
               leases: Optional[List[torch.Tensor]] = None
               ) -> Tuple[Dict[str, Any], int, int]:
        """Merge per-segment outputs; returns
        (outputs, bytes copied, bytes direct-written).

        Precedence per output name (documented contract):
          1. a user-supplied merge function (``self.merges``) — honoured
             even when the output is also partitionable;
          2. in-place assembly along the partition dim (or, with
             ``inplace_merge=False``, the historical ``torch.cat``)
             for partitionable array outputs;
          3. the first slot's value (COPY / replicated / scalar outputs).
        """
        targets = targets or {}
        leases = leases if leases is not None else []
        merged: Dict[str, Any] = {}
        bytes_copied = 0
        direct_bytes = 0
        sid = sct.unique_id()
        for name in _produced_names(sct):
            pieces = [(seg, res) for seg, res in done if name in res.outputs]
            if not pieces:
                continue
            parts = [res.outputs[name] for _, res in pieces]
            if name in self.merges:
                merged[name] = self.merges[name](parts)
                continue
            ae = self._axis_epu(sct, part, name)
            if ae is None or not all(getattr(p, "ndim", 0) >= 1
                                     for p in parts):
                merged[name] = parts[0]
                continue
            axis, _ = ae
            if not self.inplace_merge:
                merged[name] = torch.cat([_tensor(p).cpu() for p in parts],
                                         dim=axis)
                bytes_copied += _nbytes(merged[name])
                continue
            out, copied, direct = self._assemble(
                name, axis, pieces, targets.get(name), leases)
            merged[name] = out
            bytes_copied += copied
            direct_bytes += direct
            self._out_shapes[(sid, name)] = (tuple(out.shape), out.dtype)
        return merged, bytes_copied, direct_bytes

    def _assemble(self, name: str, axis: int,
                  pieces: Sequence[Tuple[_Segment, _SlotResult]],
                  target: Optional[_OutputTarget],
                  leases: List[torch.Tensor]
                  ) -> Tuple[torch.Tensor, int, int]:
        """In-place assembly of one partitionable output.

        Returns (array, bytes copied here, bytes already direct-written).
        Segments that wrote into the target buffer during compute are
        skipped; anything else is packed with a single conversion+copy
        per part (no conversion round trip, no concat temporary)."""
        parts = [_tensor(res.outputs[name]) for _, res in pieces]
        sizes = [int(p.shape[axis]) for p in parts]
        if target is not None:
            expected = all(
                s == seg.units * target.epu
                for s, (seg, _) in zip(sizes, pieces))
            if expected and target.buffer.shape[axis] == sum(sizes):
                copied = direct = 0
                for (seg, res), p, s in zip(pieces, parts, sizes):
                    off = seg.start * target.epu
                    idx = [slice(None)] * target.buffer.ndim
                    idx[axis] = slice(off, off + s)
                    n = s * int(math.prod(target.buffer.shape)
                                // max(target.buffer.shape[axis], 1)
                                ) * target.buffer.element_size()
                    if name in res.written:
                        direct += n
                        continue
                    target.buffer[tuple(idx)].copy_(p)
                    copied += n
                return target.buffer, copied, direct
        # no (usable) target: learn the shape, pack into a reusable buffer
        first = parts[0]
        shape = list(first.shape)
        shape[axis] = sum(sizes)
        dtype = functools.reduce(torch.promote_types,
                                 [p.dtype for p in parts])
        buf = self._get_buffer(name, tuple(shape), dtype, leases)
        off = 0
        copied = 0
        for p, s in zip(parts, sizes):
            idx = [slice(None)] * buf.ndim
            idx[axis] = slice(off, off + s)
            buf[tuple(idx)].copy_(p)
            copied += _nbytes(buf[tuple(idx)])
            off += s
        return buf, copied, 0

    # -- residency -------------------------------------------------------------
    def _make_resident(self, sct: SCT, part: ConcretePartitioning,
                       done: Sequence[Tuple[_Segment, _SlotResult]],
                       prev: Optional[ResidentPartition],
                       inherited_extras: Dict[str, Any]) -> ResidentPartition:
        """Package a clean run's slot-local outputs as a resident handle.

        Vectors produced by *earlier* chain steps but not re-produced here
        are carried forward — slot-locally when ``prev`` is compatible
        (the layouts are identical by construction), as whole arrays via
        ``extras`` otherwise — so any later step can still consume them.
        """
        produced = _produced_names(sct)
        meta: Dict[str, Tuple[int, int]] = {}
        extras: Dict[str, Any] = {
            k: v for k, v in inherited_extras.items() if k not in produced}
        for name in produced:
            if name in self.merges:
                parts = [res.outputs[name] for _, res in done
                         if name in res.outputs]
                if parts:
                    extras[name] = self.merges[name](parts)
                continue
            ae = self._axis_epu(sct, part, name)
            if ae is not None and all(
                    getattr(res.outputs.get(name), "ndim", 0) >= 1
                    for _, res in done if name in res.outputs):
                meta[name] = ae
            else:
                parts = [res.outputs[name] for _, res in done
                         if name in res.outputs]
                if parts:
                    extras[name] = parts[0]
        envs: List[Dict[str, Any]] = []
        events = [res.event for _, res in done]
        for i, (seg, res) in enumerate(done):
            env = {n: res.outputs[n] for n in meta if n in res.outputs}
            if prev is not None:
                for n, ae in prev.meta.items():
                    if n in produced or n in env:
                        continue
                    carried = prev.envs[i].get(n) if i < len(prev.envs) \
                        else None
                    if carried is not None:
                        env[n] = carried
                        meta.setdefault(n, ae)
            envs.append(env)
        layout = tuple((seg.start, seg.units) for seg, _ in done)
        return ResidentPartition(part=part, layout=layout, envs=envs,
                                 meta=meta, extras=extras,
                                 executor=self, sct=sct, events=events)


def _tensor(value: Any) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(value)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_device(value: Any, device: Optional[torch.device]) -> Any:
    """``value`` on ``device``: host tensors go host→device asynchronously
    on the current stream from pinned memory (a pinned staging copy when
    the caller's tensor is pageable); ``device=None`` means the host."""
    if not isinstance(value, torch.Tensor):
        return value
    if device is None:
        return value.cpu() if value.is_cuda else value
    if value.device == device:
        return value
    if not value.is_cuda and not value.is_pinned():
        staged = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
        staged.copy_(value)
        value = staged
    return value.to(device, non_blocking=True)


def _produced_names(sct: SCT) -> List[str]:
    names: List[str] = []
    for leaf in sct.leaves():
        for a in leaf.spec.outputs:
            if a.name not in names:
                names.append(a.name)
    # include function-reduction outputs of MapReduce nodes
    from repro_torch.core.skeletons import MapReduce
    stack = [sct]
    while stack:
        n = stack.pop()
        if isinstance(n, MapReduce) and n.host_side_reduction:
            src = n.map_stage.output_names()
            if len(src) == 1:
                dst = n.out_name or f"{src[0]}_reduced"
                if dst not in names:
                    names.append(dst)
        stack.extend(n.children())
    return names


class Future:
    """Marrow's asynchronous execution handle (paper Table 1).

    ``get`` re-raises executor failures as
    :class:`~repro_torch.core.faults.ExecutionError` with the failing slot /
    device identity attached, instead of a bare pool exception.
    """

    def __init__(self, inner: cf.Future, deadline: Optional[float] = None):
        self._inner = inner
        self._deadline = deadline

    def get(self, timeout: Optional[float] = None):
        timeout = timeout if timeout is not None else self._deadline
        try:
            return self._inner.result(timeout)
        except ExecutionError:
            raise
        except cf.TimeoutError:
            raise ExecutionError(
                f"request did not complete within {timeout}s") from None
        except Exception as e:
            raise ExecutionError(
                f"execution failed: {type(e).__name__}: {e}",
                getattr(e, "records", [])) from e

    def done(self) -> bool:
        return self._inner.done()


class _HandleFuture:
    """``concurrent.futures``-shaped view of one :class:`GraphHandle`
    node (duck-typed inner future for :class:`Future`)."""

    def __init__(self, handle: GraphHandle, extract: Callable[..., Any]):
        self._handle = handle
        self._extract = extract

    def result(self, timeout: Optional[float] = None):
        self._handle.result(timeout)    # raises on failure / wait timeout
        return self._extract(self._handle)

    def done(self) -> bool:
        return self._handle.done()


class Session:
    """User-facing facade: SCT.run()/submit() -> Future over a Scheduler.

    Usable as a context manager (``with Session(sched) as s: ...`` shuts
    the request queue down on exit).  Requests are admitted concurrently
    — :meth:`submit` takes a whole :class:`~repro_torch.core.graph.JobGraph`
    and returns a :class:`~repro_torch.core.graph.GraphHandle`; ``run`` and
    ``run_chain`` are thin wrappers over one-node / linear graphs and
    keep their historical signatures and ``Future`` semantics.  At most
    ``max_inflight`` graphs may be unsettled at once; beyond that,
    ``submit`` blocks (backpressure) until one completes.

    Recurrent submissions are transparent to callers but cheaper: a
    structurally identical graph over same-shaped arrays is served from
    the scheduler's whole-graph plan cache (every node pre-planned, no
    decide/plan lock traffic), and — when the scheduler was built with
    ``fusion_window > 0`` — identical single-node graphs submitted
    within the window coalesce into one wider run whose merged output
    is sliced back per request.  Both paths settle the returned
    ``GraphHandle``/``Future`` exactly as the ordinary path does, with
    bit-identical outputs.

    ``run`` accepts a request-level ``deadline`` (seconds, enforced
    across retries and by ``Future.get``) and ``retries`` with
    exponential backoff on terminal
    :class:`~repro_torch.core.faults.ExecutionError`; each backoff pause is
    capped by the remaining deadline.  ``shutdown`` drains in-flight
    requests, then closes the scheduler's graph pool and executor
    (persistent work queues, reusable output buffers — see
    :class:`ThreadedExecutor`); it is idempotent.

    ``telemetry`` installs a shared :class:`~repro_torch.core.telemetry.Telemetry`
    bundle across the scheduler, executor, health tracker and balancer;
    :meth:`metrics`, :meth:`counters`, :meth:`export_trace` and
    :meth:`prometheus` expose what it collected.  Without one, the
    pipeline runs on the no-op ``NULL_TELEMETRY`` (off-by-default cheap).
    """

    def __init__(self, scheduler, *,
                 telemetry: Optional[Telemetry] = None,
                 max_inflight: int = 8):
        self.scheduler = scheduler
        if telemetry is not None and hasattr(scheduler, "attach_telemetry"):
            scheduler.attach_telemetry(telemetry)
        self.telemetry = getattr(scheduler, "telemetry", None) \
            or telemetry or NULL_TELEMETRY
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = max_inflight
        self._inflight = threading.BoundedSemaphore(max_inflight)
        self._closed = False

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.shutdown()

    # -- graph pipeline -------------------------------------------------------
    def submit(self, graph: JobGraph, *, deadline: Optional[float] = None,
               retries: int = 0, retry_backoff: float = 0.05,
               **arrays) -> GraphHandle:
        """Submit a JobGraph for concurrent execution; returns its handle.

        Blocks while ``max_inflight`` earlier submissions are still
        unsettled (backpressure); per-node ``retries`` / ``deadline``
        semantics match :meth:`run`."""
        if self._closed:
            raise RuntimeError("session is shut down")
        self._inflight.acquire()
        try:
            handle = self.scheduler.submit(
                graph, arrays, deadline=deadline, retries=retries,
                retry_backoff=retry_backoff)
        except BaseException:
            self._inflight.release()
            raise
        handle.add_done_callback(lambda _h: self._inflight.release())
        return handle

    def gather(self, *handles: GraphHandle,
               timeout: Optional[float] = None) -> List[GraphResult]:
        """Block for a set of submitted graphs; returns their results in
        argument order (raising the first failure encountered)."""
        return [h.result(timeout) for h in handles]

    def run(self, sct: SCT, *, deadline: Optional[float] = None,
            retries: int = 0, retry_backoff: float = 0.05,
            **arrays) -> Future:
        graph = JobGraph()
        name = graph.add(sct)
        handle = self.submit(graph, deadline=deadline, retries=retries,
                             retry_backoff=retry_backoff, **arrays)
        return Future(_HandleFuture(handle, lambda h: h.runs[name]),
                      deadline=deadline)

    def run_chain(self, scts: Sequence[SCT], *, deadline: Optional[float] = None,
                  retries: int = 0, **arrays) -> Future:
        """Asynchronously run a compound SCT chain with partitioned
        residency between steps (a linear ``JobGraph``: residency flows
        along its chain edges exactly as in ``Scheduler.run_chain``)."""
        graph = JobGraph()
        names = graph.add_chain(list(scts))
        handle = self.submit(graph, deadline=deadline, retries=retries,
                             **arrays)
        return Future(
            _HandleFuture(handle, lambda h: [h.runs[n] for n in names]),
            deadline=deadline)

    # -- observability --------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """JSON snapshot of every metric series the pipeline recorded."""
        return self.telemetry.metrics.snapshot()

    def prometheus(self) -> str:
        """Prometheus text-format dump of the metrics registry."""
        return self.telemetry.metrics.to_prometheus()

    def counters(self) -> Dict[str, float]:
        """Namespaced pipeline counters (see ``Scheduler.counters``)."""
        counters = getattr(self.scheduler, "counters", None)
        return counters() if counters is not None else {}

    def events(self, kind: Optional[str] = None):
        """Recent structured events, optionally filtered by kind prefix."""
        return self.telemetry.events.records(kind)

    def export_trace(self, path: str) -> Dict[str, Any]:
        """Write the Chrome/Perfetto ``trace.json``; returns the object."""
        return self.telemetry.export_trace(path)

    def shutdown(self) -> None:
        """Drain in-flight graphs and release every execution resource.

        Idempotent — repeated calls (or a context-manager exit after an
        explicit shutdown) are no-ops."""
        if self._closed:
            return
        self._closed = True
        close = getattr(self.scheduler, "close", None)
        if close is not None:
            close()                     # drains, then closes the executor
            return
        exclose = getattr(getattr(self.scheduler, "executor", None),
                          "close", None)
        if exclose is not None:
            exclose()
