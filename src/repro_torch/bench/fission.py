"""Table 2 / Fig 6 — device-fission speedups, CPU-only executions.

Two measurements:
  (a) *simulated* Opteron testbed (the paper's 64-core 4-socket box,
      calibrated cache hierarchy): Table 2's fission-level selection and
      Fig 6's fission/no-fission speedups.  ``sim`` only: this host is no
      64-core Opteron, so ``host`` leaves it out;
  (b) *real timed* partition-count sweep on this host: saxpy over 2^20
      float32 CPU tensors in 1, 2, 4 and 8 host slots through the
      ``ThreadedExecutor`` (device ``cpu``: every slot is a host slot).
      Both testbeds run it; its ``fission_real`` lines are wall clock.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from repro_torch.bench.paper_suite import (BENCHMARKS, cost_model_for,
                                           opteron_testbed, saxpy_sct,
                                           workload_for)
from repro_torch.core import (AcceleratorPlatform, DeviceInfo,
                              ExecutionSlot, HostPlatform, KnowledgeBase,
                              Scheduler, ThreadedExecutor, build_plan)
from repro_torch.core.knowledge_base import PlatformConfig, Profile
from repro_torch.core.platforms import FISSION_LEVELS
from repro_torch.core.simulator import SimDevice, SimulatedExecutor
from repro_torch.core.spec import Workload

#: paper Sec. 4.1 topology: 64 cores; L2 pairs -> 32, L3 islands -> 8,
#: NUMA sockets -> 4
OPTERON_TOPOLOGY = {"L1": 64, "L2": 32, "L3": 8, "NUMA": 4,
                    "NO_FISSION": 1}

#: paper Table 2 best-fission results (level, speedup vs no fission)
PAPER_TABLE2 = {
    ("filter_pipeline", 2048): ("L2", 34.8 / 22.0),
    ("filter_pipeline", 4096): ("L2", 120.3 / 65.1),
    ("fft", 256): ("L2", 197.9 / 56.5),
    ("nbody", 16384): ("L3", 284.0 / 99.0),
    ("saxpy", 10 ** 7): ("L2", 72.1 / 23.9),
    ("segmentation", 512): ("L3", 11.8 / 4.3),
}


def simulate_fission(name: str, size: int) -> Dict:
    """Best fission level + speedup on the calibrated Opteron box."""
    sct = BENCHMARKS[name][0](size)
    host = HostPlatform(DeviceInfo("cpu", "cpu", compute_units=64),
                        topology=OPTERON_TOPOLOGY)
    accel = AcceleratorPlatform([DeviceInfo("null", "gpu")])  # unused
    devs = opteron_testbed() + [SimDevice("null", "gpu", flops=1.0)]
    sim = SimulatedExecutor(devs, seed=0, cost=cost_model_for(name, size))
    sched = Scheduler(host=host, accel=accel, executor=sim,
                      kb=KnowledgeBase(), default_share_a=0.0)
    workload = workload_for(name, size)
    times: Dict[str, float] = {}
    for level in FISSION_LEVELS:
        if level not in OPTERON_TOPOLOGY:
            continue
        prof = Profile(sct_id=sct.unique_id(), workload=workload,
                       share_a=0.0,
                       config=PlatformConfig(fission_level=level))
        _, stats, _, _, _ = sched._dispatch(sct, _arrays(sct, workload), prof)
        times[level] = stats.total
    best = min(times, key=times.get)
    return {"benchmark": name, "size": size, "best_level": best,
            "speedup_vs_nofission": times["NO_FISSION"] / times[best],
            "times": times}


def _arrays(sct, workload: Workload):
    return SimulatedExecutor(opteron_testbed()).synthesise_arrays(sct,
                                                                  workload)


def timed_partition_sweep() -> List[Dict]:
    """Real timed saxpy partitioned runs on this host's CPU."""
    out = []
    n = 1 << 20
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    y = np.ones(n, np.float32)
    sct = saxpy_sct()
    plan = build_plan(sct, {"x": (n,), "y": (n,), "z": (n,)})
    ex = ThreadedExecutor(device="cpu")
    try:
        for parts in (1, 2, 4, 8):
            slots = [ExecutionSlot(f"c{i}", "cpu") for i in range(parts)]
            part = plan.partition(slots, [1.0 / parts] * parts)
            arrays = {"a": np.float32(2.0), "x": x, "y": y}
            t0 = time.perf_counter()
            for _ in range(3):
                outs, _ = ex.execute(sct, part, arrays,
                                     Profile("s", Workload((n,)), 0.0,
                                             PlatformConfig()))
            dt = (time.perf_counter() - t0) / 3
            np.testing.assert_allclose(outs["z"].numpy(), 2 * x + y,
                                       rtol=1e-5)
            out.append({"partitions": parts, "seconds": dt})
    finally:
        ex.close()
    return out


def collect(full: bool = True, testbed: str = "host", device: str = "cuda",
            smoke: bool = False) -> Dict[str, Any]:
    lines: List[str] = []
    out: Dict[str, Any] = {"lines": lines}
    print("== fission (Table 2 / Fig 6) ==")
    if testbed == "sim":
        print(f"{'benchmark':18s} {'size':>9s} {'sim best':>9s} "
              f"{'paper':>6s} {'sim speedup':>11s} {'paper':>6s}")
        out["simulated"] = []
        for (name, size), (paper_level, paper_speedup) in \
                PAPER_TABLE2.items():
            r = simulate_fission(name, size)
            out["simulated"].append(r)
            print(f"{name:18s} {size:>9d} {r['best_level']:>9s} "
                  f"{paper_level:>6s} {r['speedup_vs_nofission']:>11.2f} "
                  f"{paper_speedup:>6.2f}")
            lines.append(f"fission,{name},{size},{r['best_level']},"
                         f"{r['speedup_vs_nofission']:.3f}")
    else:
        print("  (a) the simulated 64-core Opteron: sim only")
    out["real"] = timed_partition_sweep()
    for r in out["real"]:
        print(f"  [real] saxpy 1M x{r['partitions']:d} partitions: "
              f"{r['seconds'] * 1e3:.1f} ms")
        lines.append(f"fission_real,saxpy,{r['partitions']},"
                     f"{r['seconds'] * 1e6:.0f}us")
    return out


def main(full: bool = True, testbed: str = "host", device: str = "cuda",
         smoke: bool = False) -> List[str]:
    return collect(full, testbed, device, smoke)["lines"]


if __name__ == "__main__":
    import sys
    from repro_torch.bench import run
    sys.exit(run.main(["--only", "fission", *sys.argv[1:]]))
