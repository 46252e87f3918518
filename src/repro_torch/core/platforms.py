"""Execution platforms (paper Sec. 2.2) — the technology-bound lower layer.

The Marrow runtime delegates device specificities to *execution platforms*:

* ``CPUExecutionPlatform`` — OpenCL **device fission**: splits a multi-core
  CPU device into sub-devices along cache/NUMA affinity domains
  (L1 < L2 < L3 < NUMA < NO_FISSION) to leverage data locality.
* ``GPUExecutionPlatform`` — **multi-buffering / overlap**: N in-flight
  executions per GPU so communication overlaps computation, plus the
  occupancy-ordered work-group size candidates.

On this port's hybrid host (paper Sec. 4.2):

* :class:`HostPlatform` keeps the paper's fission semantics: each level
  splits the host's cores into that many CPU execution slots.
* :class:`AcceleratorPlatform` is the paper's GPU multi-buffering: each
  overlap slot of a card is its own CUDA stream, so one slot's copies
  overlap another's kernels.

Install-time calibration (paper: SHOC suite) is
:func:`AcceleratorPlatform.calibrate` — relative throughput scores that
drive the *static* intra-class distribution of Sec. 3.2.  The port
carries no device rates of its own: an unmeasured device has unknown
peaks and every device scores the same until a workload is timed.
"""
from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.occupancy import BlockScore, candidates
from repro_torch.core.spec import KernelSpec

#: Fission levels in the paper's search order (L1 first — most sub-devices,
#: most locality — down to NO_FISSION).
FISSION_LEVELS = ("L1", "L2", "L3", "NUMA", "NO_FISSION")


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    """One schedulable device (or device class member)."""

    name: str
    kind: str                  # "cpu" | "gpu"
    compute_units: int = 1     # cores / SMs in the device
    peak_flops: Optional[float] = None     # unknown until stated
    hbm_bw: Optional[float] = None
    link_bw: Optional[float] = None
    throughput: float = 1.0    # calibrated relative score (SHOC analogue)


@dataclasses.dataclass(frozen=True)
class FissionConfig:
    level: str
    subdevices: int            # execution slots the level yields


class HostPlatform:
    """CPU/slow-class platform: fission by affinity domain.

    ``topology`` maps each supported fission level to the number of
    sub-devices it yields (paper Sec. 4.1 example: 64-core 4-socket Opteron
    -> L1:64? the paper's table uses L2:32, L3:8, NUMA:4).  Levels absent
    from the map are unsupported by the hardware.  Without one, the levels
    split this host's ``os.cpu_count()`` cores.
    """

    def __init__(self, device: DeviceInfo,
                 topology: Optional[Dict[str, int]] = None):
        self.device = device
        cu = os.cpu_count() or 1
        self.topology: Dict[str, int] = topology or {
            "L1": cu, "L2": max(cu // 2, 1), "L3": max(cu // 8, 1),
            "NUMA": max(cu // 16, 1), "NO_FISSION": 1,
        }
        self._level = "NO_FISSION"

    # paper: CPUExecutionPlatform.getConfigurations(SCT, args)
    def get_configurations(self, sct=None, arguments=None) -> List[FissionConfig]:
        return [FissionConfig(lv, self.topology[lv]) for lv in FISSION_LEVELS
                if lv in self.topology]

    def configure(self, level: str) -> int:
        """Apply a fission level; returns the parallelism it contributes."""
        if level not in self.topology:
            raise ValueError(f"unsupported fission level {level}")
        self._level = level
        return self.topology[level]

    @property
    def level(self) -> str:
        return self._level

    @property
    def parallelism(self) -> int:
        return self.topology[self._level]


class AcceleratorPlatform:
    """GPU/fast-class platform: overlap depth + block-size candidates."""

    def __init__(self, devices: Sequence[DeviceInfo], *, max_overlap: int = 8,
                 occupancy_threshold: float = 0.80):
        if not devices:
            raise ValueError("AcceleratorPlatform needs >= 1 device")
        self.devices = list(devices)
        self.max_overlap = max_overlap
        self.occupancy_threshold = occupancy_threshold
        self._overlap = 1

    # paper: GPUExecutionPlatform.getConfigurations -> ({overlaps}, {wgs})
    def get_configurations(self, sct=None, arguments=None,
                           domain_size: int = 1 << 20
                           ) -> Tuple[List[int], Dict[str, List[BlockScore]]]:
        overlaps = list(range(1, self.max_overlap + 1))
        wgs: Dict[str, List[BlockScore]] = {}
        specs: Iterable[KernelSpec] = (sct.kernel_specs() if sct is not None
                                       else [])
        for spec in specs:
            wgs[spec.name] = candidates(
                spec, domain_size,
                cores=sum(d.compute_units for d in self.devices),
                threshold=self.occupancy_threshold)
        return overlaps, wgs

    def configure(self, overlap: int) -> int:
        """Set the overlap factor; returns contributed parallelism
        (paper: #GPUs x overlap concurrent executions)."""
        if not 1 <= overlap <= self.max_overlap:
            raise ValueError(f"overlap {overlap} out of range")
        self._overlap = overlap
        return len(self.devices) * overlap

    @property
    def overlap(self) -> int:
        return self._overlap

    @property
    def parallelism(self) -> int:
        return len(self.devices) * self._overlap

    # -- install-time calibration (SHOC analogue) ---------------------------
    def calibrate(self, workload: Optional[Callable[[DeviceInfo], object]] = None
                  ) -> List[float]:
        """Relative throughput per device, for the static intra-class split.

        With no ``workload`` every device scores its ``throughput`` (equal
        by default: the port assumes no peak rates).  A ``workload``
        enqueues work for one device on the current stream; each device
        is then timed with CUDA events, best of three, and scores the
        inverse of its time.  Timing needs a card: without one this
        raises.
        """
        if workload is None:
            scores = [d.throughput for d in self.devices]
        else:
            times = [max(_event_seconds(d, workload), 1e-12)
                     for d in self.devices]
            scores = [1.0 / t for t in times]
        tot = sum(scores)
        return [s / tot for s in scores]


def cuda_index(name: str) -> int:
    """CUDA ordinal of an accelerator device named like ``gpu1``."""
    m = re.search(r"(\d+)$", name)
    return int(m.group(1)) if m else 0


def _event_seconds(device: DeviceInfo,
                   workload: Callable[[DeviceInfo], object],
                   repeats: int = 3) -> float:
    """Best-of-N device time of ``workload(device)``, from CUDA events."""
    if not torch.cuda.is_available():
        raise RuntimeError("calibrate(workload) times on a CUDA device; "
                           "none is available")
    with torch.cuda.device(cuda_index(device.name)):
        best = float("inf")
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            workload(device)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
    return best


def timed(fn: Callable[[], None], *, repeats: int = 3) -> float:
    """Best-of-N wall-clock timer used by calibration and the autotuner."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best
