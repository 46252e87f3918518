"""Calibrated heterogeneous device-pool simulator.

Scheduling-policy experiments at multi-device scale (the paper's hybrid
CPU+GPU tables, the load-fluctuation adaptation of Fig. 11, pod-scale
straggler studies) cannot be *measured* on this single-core CPU container.
They are evaluated on an analytic simulator that shares the executor
interface, with a cost model calibrated to the paper's hardware ratios:

  slot time =  compute + transfer (+ queue overhead) , where

  * GPU-class slot:  compute = units * flop_u / flops_dev
                     transfer = units * bytes_u / pcie_bw / overlap
                     (multi-buffering hides transfers behind compute)
  * CPU-class slot:  compute = units * flop_u / (flops_core * cores_slot)
                              * locality(level, working_set) * (1 + load)
                     (device fission: per-slot working sets that fit the
                     affinity domain's cache run at a locality bonus;
                     ``load`` models external CPU load fluctuation)

Determinism: multiplicative noise from a seeded Generator; experiments are
reproducible bit-for-bit.  The same model doubles as the *straggler* model
for TPU slices (a slice whose throughput drifts == a loaded CPU).

Failure semantics: the simulator honours the same
:class:`~repro_torch.core.faults.FaultInjector` and retry ladder as the real
:class:`~repro_torch.core.executor.ThreadedExecutor` — injected crashes kill a
slot halfway through its simulated run, injected stalls add
``stall_seconds`` (tripping the watchdog deadline when one is derivable
from ``profile.best_time``), lost unit ranges are re-split across the
surviving slots, and exhausted retries raise
:class:`~repro_torch.core.faults.ExecutionError` — so pod-scale failure and
straggler policies are testable deterministically without hardware.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.decomposition import ConcretePartitioning
from repro_torch.core.faults import (ExecutionError, FaultInjector, FaultPolicy,
                                     FaultRecord, split_units)
from repro_torch.core.knowledge_base import Profile
from repro_torch.core.skeletons import SCT
from repro_torch.core.spec import Transfer, Workload
from repro_torch.core.telemetry import NULL_TELEMETRY, Telemetry

#: cache capacity (bytes) of each fission affinity domain — paper Sec. 4.1
#: hardware (AMD Opteron 6272): 16 KiB L1/core, 2 MiB L2/2 cores,
#: 6 MiB L3/8 cores, NUMA = DRAM.
CACHE_BYTES = {"L1": 16 << 10, "L2": 2 << 20, "L3": 6 << 20,
               "NUMA": 1 << 62, "NO_FISSION": 1 << 62}
#: effective-throughput multiplier per fission level, calibrated to the
#: paper's Table 2 (a NO_FISSION device spanning 4 NUMA sockets loses
#: throughput to cross-socket traffic and scheduler thrash; L2-affinity
#: subdevices recover ~3x, L1 splits too fine, NUMA too coarse)
LOCALITY_FACTOR = {"L1": 2.0, "L2": 3.0, "L3": 2.4, "NUMA": 1.5,
                   "NO_FISSION": 1.0}
TILE_BONUS = 1.3                # extra bw when a slot's tile fits its cache
SLOT_OVERHEAD = 2e-4            # per-slot dispatch cost (seconds)


@dataclasses.dataclass
class SimDevice:
    name: str
    kind: str                       # "cpu" | "gpu"
    flops: float                    # effective FLOP/s of the whole device
    mem_bw: float = 50e9            # device memory bandwidth
    pcie_bw: float = 8e9            # host<->device staging bandwidth
    cores: int = 1


@dataclasses.dataclass
class CostModel:
    """Per-domain-unit costs of one SCT execution."""

    flops_per_unit: float
    bytes_per_unit: float
    iterations: float = 1.0         # Loop skeletons repeat the body

    @staticmethod
    def of(sct: SCT, workload: Workload) -> "CostModel":
        units = None
        fl = by = 0.0
        for spec in sct.kernel_specs():
            vec = [a for a in spec.vectors if a.partitionable]
            epu = vec[0].epu if vec else 1
            elems = epu  # elements of one unit along the partition dim
            row = workload.size / max(workload.dims[0], 1)
            fl += spec.flops_per_item * elems * row
            by += spec.bytes_per_item * elems * row
        return CostModel(flops_per_unit=fl, bytes_per_unit=by)


class SimulatedExecutor:
    """Executor-interface analytic simulator."""

    # analytic model: no real buffers to keep slot-resident, so the
    # Scheduler never passes residency kwargs to this executor
    supports_residency = False
    # graphs execute on the simulated timeline (GraphDriver.run_virtual):
    # deterministic per-device-queue list scheduling instead of threads
    virtual_clock = True

    def __init__(self, devices: Sequence[SimDevice], *, seed: int = 0,
                 noise: float = 0.02, compute_outputs: bool = False,
                 cost: Optional[CostModel] = None,
                 injector: Optional[FaultInjector] = None,
                 policy: FaultPolicy = FaultPolicy(),
                 telemetry: Optional[Telemetry] = None):
        self.telemetry = telemetry or NULL_TELEMETRY
        # virtual simulated-time clock (µs): spans are laid on this
        # timeline, so the exported trace is deterministic (seeded
        # jitter only — no wall-clock reads)
        self._vclock_us = 0.0
        self.devices = {d.name.split("/")[0]: d for d in devices}
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.compute_outputs = compute_outputs
        self.cpu_load = 0.0              # external load factor (Fig. 11)
        self.cost_override = cost
        self.injector = injector
        self.policy = policy
        self._last_times: List[float] = []
        self._last_n_a = 0
        self.executions = 0
        self.last_failures: List[FaultRecord] = []
        self.last_retries = 0
        self.last_timing: Dict[str, float] = {}
        self.last_merge_bytes = 0
        self.last_resident = None

    # -- knobs -------------------------------------------------------------
    def set_cpu_load(self, load: float) -> None:
        """External CPU load: 0 = idle, 1 = fully contended (x2 slowdown)."""
        self.cpu_load = max(0.0, load)

    @property
    def vclock_us(self) -> float:
        """The virtual clock (µs).  Writable: the graph driver rewinds /
        advances it to each node's dataflow-ready time."""
        return self._vclock_us

    @vclock_us.setter
    def vclock_us(self, value: float) -> None:
        self._vclock_us = float(value)

    # -- Scheduler interface -------------------------------------------------
    def execute(self, sct: SCT, part: ConcretePartitioning,
                arrays: Dict[str, Any], profile: Profile
                ) -> Tuple[Dict[str, Any], List[float]]:
        workload = _workload_of(part)
        cost = self.cost_override or CostModel.of(sct, workload)
        level = profile.config.fission_level
        overlap = max(profile.config.overlap, 1)
        cpu_slots = [s for s in part.slots if s.device_type == "cpu"]
        n_cpu = max(len(cpu_slots), 1)
        deadline = self.policy.deadline(getattr(profile, "best_time", None))

        tel = self.telemetry
        times = [0.0] * len(part.slots)
        records: List[FaultRecord] = []
        retries = 0
        dead: set = set()
        pending: Dict[int, int] = {j: u for j, u in enumerate(part.units)}
        for attempt in range(self.policy.max_attempts):
            round_us = self._vclock_us       # virtual start of this round
            round_max = 0.0
            failed: Dict[int, int] = {}
            for j, units in pending.items():
                slot = part.slots[j]
                dev = self._device_for(slot.device)
                t = self._slot_time(dev, units, cost, level, overlap,
                                    n_cpu_slots=n_cpu)
                kind = (self.injector.decide(slot.device)
                        if self.injector is not None else None)
                if kind == "stall":
                    t += self.injector.stall_seconds
                    if deadline is not None and t > deadline:
                        rec = FaultRecord(
                            slot=j, device=slot.device,
                            device_type=slot.device_type, kind="timeout",
                            attempt=attempt,
                            message="simulated stall tripped watchdog "
                                    f"({deadline:.3f}s)",
                            seconds=deadline)
                        records.append(rec)
                        dead.add(j)
                        failed[j] = units
                        times[j] += deadline
                        round_max = max(round_max, deadline)
                        self._observe_slot(slot, units, deadline, attempt,
                                           round_us, fault=rec)
                        continue
                if kind == "crash":
                    # the slot dies halfway through its simulated run
                    rec = FaultRecord(
                        slot=j, device=slot.device,
                        device_type=slot.device_type, kind="crash",
                        attempt=attempt, message="injected crash",
                        seconds=t * 0.5)
                    records.append(rec)
                    dead.add(j)
                    failed[j] = units
                    times[j] += t * 0.5
                    round_max = max(round_max, t * 0.5)
                    self._observe_slot(slot, units, t * 0.5, attempt,
                                       round_us, fault=rec)
                    continue
                times[j] += t
                round_max = max(round_max, t)
                self._observe_slot(slot, units, t, attempt, round_us)
            self._vclock_us = round_us + round_max * 1e6
            lost_units = sum(u for u in failed.values() if u > 0)
            if not lost_units:
                break
            alive = [j for j in range(len(part.slots)) if j not in dead]
            if not alive:
                raise ExecutionError(
                    "partition lost: no surviving execution slot can adopt "
                    f"{lost_units} domain units", records, attempt + 1)
            if attempt == self.policy.max_attempts - 1:
                raise ExecutionError(
                    f"retries exhausted after {self.policy.max_attempts} "
                    "attempts", records, attempt + 1)
            counts = split_units(lost_units, len(alive))
            pending = {j: u for j, u in zip(alive, counts) if u}
            retries += 1
            tel.events.emit("retry.repartition", lost_units=lost_units,
                            survivors=len(alive), attempt=attempt)

        self.last_failures = records
        self.last_retries = retries
        self._last_times = times
        self._last_n_a = sum(1 for s in part.slots if s.device_type != "cpu")
        self.last_timing = {"pool": 0.0, "dispatch": 0.0, "merge": 0.0,
                            "compute": max(times) if times else 0.0}
        self.last_merge_bytes = 0
        self.executions += 1
        outputs: Dict[str, Any] = {}
        if self.compute_outputs:
            env = dict(arrays)
            outputs = sct.apply(env)
        return outputs, times

    def execute_result(self, sct: SCT, part: ConcretePartitioning,
                       arrays: Dict[str, Any], profile: Profile):
        """Per-call result (``ExecResult``) matching the threaded
        executor's concurrent interface.  The simulator itself is
        single-threaded (graph execution is sequential in virtual time),
        so packaging from the ``last_*`` fields is race-free."""
        from repro_torch.core.executor import ExecResult
        outputs, times = self.execute(sct, part, arrays, profile)
        return ExecResult(
            outputs=outputs, times=times,
            failures=list(self.last_failures), retries=self.last_retries,
            timing=dict(self.last_timing), merge_bytes=0, direct_bytes=0,
            resident=None, n_a=self._last_n_a)

    def _observe_slot(self, slot, units: int, seconds: float, attempt: int,
                      round_us: float,
                      fault: Optional[FaultRecord] = None) -> None:
        """Telemetry for one simulated slot execution.

        Spans are laid on the virtual simulated-time axis (``record``,
        Chrome ``X`` events, one track per physical device) so the
        exported trace depends only on the seeded cost model — fully
        deterministic, no wall-clock reads."""
        tel = self.telemetry
        base = slot.device.split("/")[0]
        tid = list(self.devices).index(base) if base in self.devices else 0
        tel.tracer.record("slot", round_us, seconds * 1e6, tid=tid,
                          device=slot.device, units=units, attempt=attempt,
                          **({"fault": fault.kind} if fault else {}))
        # per-device busy seconds are accounted once, by the Scheduler,
        # from stats.times — identical for both executors
        if fault is not None:
            tel.metrics.counter("faults_total", kind=fault.kind).inc()
            tel.events.emit("fault", level="warning", message=fault.message,
                            device=fault.device, fault_kind=fault.kind,
                            attempt=fault.attempt, slot=fault.slot)

    def last_class_times(self) -> Tuple[float, float]:
        n_a, t = self._last_n_a, self._last_times
        ta = max(t[:n_a]) if n_a else 0.0
        tb = max(t[n_a:]) if len(t) > n_a else 0.0
        return ta, tb

    def synthesise_arrays(self, sct: SCT, workload: Workload
                          ) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for a in sct.free_inputs():
            out[a.name] = (_ShapeStub(workload.dims, workload.itemsize)
                           if a.kind == "vector" else np.float32(1.0))
        return out

    # -- cost model ----------------------------------------------------------
    def _device_for(self, slot_device: str) -> SimDevice:
        base = slot_device.split("/")[0]
        if base in self.devices:
            return self.devices[base]
        # fission sub-device of a CPU
        for d in self.devices.values():
            if slot_device.startswith(d.name):
                return d
        raise KeyError(slot_device)

    def _slot_time(self, dev: SimDevice, units: int, cost: CostModel,
                   level: str, overlap: int, *, n_cpu_slots: int) -> float:
        if units == 0:
            return 0.0
        flops = units * cost.flops_per_unit * cost.iterations
        byts = units * cost.bytes_per_unit
        if dev.kind == "cpu":
            loc = LOCALITY_FACTOR.get(level, 1.0)
            comp = flops / (dev.flops / n_cpu_slots * loc)
            bw = dev.mem_bw / n_cpu_slots * loc
            if byts <= CACHE_BYTES.get(level, 0):
                bw *= TILE_BONUS              # tile fits the affinity cache
            mem = byts / bw
            t = max(comp, mem) * (1.0 + self.cpu_load)
            t += SLOT_OVERHEAD * (1 + 0.02 * n_cpu_slots)   # fission overhead
        else:
            comp = max(flops / dev.flops, byts / dev.mem_bw)
            xfer = byts / dev.pcie_bw
            # multi-buffering: first buffer exposed, the rest overlapped
            t = comp + xfer / overlap + SLOT_OVERHEAD
        jitter = 1.0 + self.noise * float(self.rng.standard_normal())
        return t * max(jitter, 0.5)


@dataclasses.dataclass
class _ShapeStub:
    """Shape-only array stand-in (no allocation) for simulated requests."""

    shape: Tuple[int, ...]
    _itemsize: int = 4

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self):
        class _D:
            itemsize = self._itemsize
        return _D()


def _workload_of(part: ConcretePartitioning) -> Workload:
    v = next((v for v in part.plan.vectors.values() if not v.copy), None)
    if v is None:
        return Workload((1,))
    return Workload((v.extent,))
