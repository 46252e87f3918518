"""Fig 11 — adaptation to CPU load fluctuations (FFT-128).

Initial distribution ~ (GPU 75.5%, CPU 24.5%); an external application
then loads the CPU, the monitor detects the unbalance (lbt crosses the
trigger after 3-4 runs) and the adaptive binary search shifts work to the
GPU: the paper observes an abrupt 1-4-run shifting phase followed by ~10
runs of smooth halving.

``sim`` loads the calibrated 2013 testbed's CPU through the simulator's
``set_cpu_load`` (its line equals ``benchmarks/load_fluctuation.py``'s,
and it asserts the reference's ``peak > before + 0.05``).  ``host`` runs
the main path's FFT on this machine's cores and ``cuda:0`` streams, from
a given tuned FFT-128 profile or, where none is given, from the
reference's (0.755, L3, overlap 4); over the same runs the load comes from
busy child processes, one per core, which are stopped when the load ends
and also when the run fails.  On ``host`` the reference's assertion is
reported, not enforced: a shared host's load does not repeat from run to
run.
"""
from __future__ import annotations

import contextlib
import math
import os
import subprocess
import sys
from typing import Any, Dict, Iterator, List, Optional

from repro_torch.bench import hybrid
from repro_torch.bench.paper_suite import BENCHMARKS, workload_for
from repro_torch.core import LoadBalancer
from repro_torch.core.distribution import Distribution
from repro_torch.core.knowledge_base import Origin, PlatformConfig, Profile

NAME, SIZE = "fft", 128
#: the reference's starting point
START = {"gpu_share": 0.755, "fission": "L3", "overlap": 4}
#: ``smoke`` (the CPU tests): runs, and the load between LOAD runs
SMOKE_RUNS, SMOKE_LOAD = 8, (2, 5)


@contextlib.contextmanager
def busy_processes(n: int) -> Iterator[List[subprocess.Popen]]:
    """``n`` child processes, each spinning one core, killed and reaped on
    leaving (also on an exception)."""
    procs: List[subprocess.Popen] = []
    try:
        for _ in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "while True: pass"],
                stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL))
        yield procs
    finally:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()


def collect(full: bool = False, testbed: str = "host", device: str = "cuda",
            smoke: bool = False, start: Optional[Dict[str, Any]] = None
            ) -> Dict[str, Any]:
    runs = 60 if full else 40
    load_at, load_off = 10, runs - 15
    if testbed == "host" and smoke:
        runs, (load_at, load_off) = SMOKE_RUNS, SMOKE_LOAD
    size = hybrid.SMOKE[NAME] if smoke else SIZE
    begin = dict(START if start is None else start)
    ev = sim = None
    sched = hybrid.host_scheduler(device) if testbed == "host" else None
    try:
        if testbed == "host":
            ev = hybrid.host_evaluator(NAME, size, sched, device)
            sct, workload = ev.sct, ev.workload
        else:
            sct = BENCHMARKS[NAME][0](size)
            workload = workload_for(NAME, size)
            sched, sim = hybrid.make_scheduler(NAME, size, n_gpus=1)
            arrays = sim.synthesise_arrays(sct, workload)
        prof = Profile(sct_id=sct.unique_id(), workload=workload,
                       share_a=begin["gpu_share"],
                       config=PlatformConfig(fission_level=begin["fission"],
                                             overlap=begin["overlap"]))
        balancer = LoadBalancer(max_dev=0.85)
        print(f"== load-fluctuation adaptation (Fig 11, FFT-{size}, "
              f"{testbed}) ==")
        print(f"{'run':>4s} {'cpu load':>8s} {'gpu%':>6s} {'dev':>6s} "
              f"{'balanced?':>9s}")
        trace: List[float] = []
        loads: List[float] = []
        walls: List[float] = []
        pids: List[int] = []
        load = contextlib.ExitStack()
        cur = prof
        with load:
            for run in range(runs):
                loaded = load_at <= run < load_off
                if sim is not None:
                    sim.set_cpu_load(3.0 if loaded else 0.0)
                    _, stats, _, _, _ = sched._dispatch(sct, arrays, cur)
                    cpu_load = sim.cpu_load
                else:
                    if run == load_at:
                        procs = load.enter_context(
                            busy_processes(os.cpu_count() or 1))
                        pids.extend(p.pid for p in procs)
                    elif run == load_off:
                        load.close()
                    _, stats, _, wall = ev.dispatch(cur.config, cur.share_a)
                    walls.append(wall)
                    cpu_load = float(os.cpu_count() or 1) if loaded else 0.0
                loads.append(cpu_load)
                trig = balancer.observe(stats)
                if trig:
                    new = balancer.adjust(
                        Distribution(a=cur.share_a, b=1 - cur.share_a),
                        stats.time_a, stats.time_b)
                    cur = Profile(sct_id=cur.sct_id, workload=workload,
                                  share_a=new.a, config=cur.config,
                                  best_time=math.inf, origin=Origin.DERIVED)
                else:
                    balancer.balanced_again()
                trace.append(cur.share_a)
                if run % (2 if not full else 1) == 0:
                    print(f"{run:>4d} {cpu_load:>8.1f} "
                          f"{100 * cur.share_a:>6.1f} {stats.deviation:>6.2f} "
                          f"{'no' if trig else 'yes':>9s}")
    finally:
        if testbed == "host":
            sched.close()
    before = trace[load_at - 1]
    peak = max(trace[load_at:load_off])
    after = trace[-1]
    held = peak > before + 0.05
    print(f"gpu share: {100 * before:.1f}% -> {100 * peak:.1f}% under "
          f"load -> {100 * after:.1f}% after")
    if sim is not None and not held:
        raise AssertionError("balancer failed to shift work to GPU")
    else:
        print(f"  peak > before + 0.05 (the reference's assertion, not "
              f"enforced here): {'held' if held else 'missed'}")
    return {"lines": [f"load_fluctuation,fft,{size},{before:.3f},"
                      f"{peak:.3f},{after:.3f}"],
            "cell": {"benchmark": NAME, "size": size, "runs": runs,
                     "load_runs": [load_at, load_off], "start": begin,
                     "share_trace": trace, "cpu_load": loads,
                     "walls": walls, "load_pids": pids, "before": before,
                     "peak": peak, "after": after, "shift_held": held,
                     "balance_ops": balancer.balance_ops,
                     "fission": cur.config.fission_level,
                     "overlap": cur.config.overlap, "testbed": testbed}}


def main(full: bool = False, testbed: str = "host", device: str = "cuda",
         smoke: bool = False) -> List[str]:
    return collect(full, testbed, device, smoke)["lines"]


if __name__ == "__main__":
    from repro_torch.bench import run
    sys.exit(run.main(["--only", "load_fluctuation", *sys.argv[1:]]))
