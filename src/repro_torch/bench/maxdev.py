"""Table 4 — maxDev calibration under stable load.

Each case is tuned with Algorithm 1, then run 500 times (120 by default)
under its tuned profile; the value reported is the *minimum* per-run
deviation (fastest / slowest concurrent execution) observed: setting
maxDev below it keeps the load balancer quiet under stable conditions.
Paper conclusion: [0.8, 0.85] is an adequate range.

``sim`` runs the calibrated 2013 hybrid testbed (its lines equal
``benchmarks/maxdev.py``'s); ``host`` this machine's cores and ``cuda:0``
streams over the main path's SCTs (the first run's outputs checked).
"""
from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.bench import hybrid, paper_suite
from repro_torch.bench.paper_suite import BENCHMARKS, workload_for
from repro_torch.core import TunerParams, build_profile

CASES = [("saxpy", 10 ** 7), ("filter_pipeline", 4096), ("fft", 256),
         ("segmentation", 512)]
#: the reference's parameters (the default precision, 0.02 s)
PARAMS = TunerParams(number_executions=1)
#: runs a case at ``smoke`` (the CPU tests)
SMOKE_RUNS = 4


def _sim_case(name: str, size: int, runs: int) -> Dict[str, Any]:
    sct = BENCHMARKS[name][0](size)
    workload = workload_for(name, size)
    sched, sim = hybrid.make_scheduler(name, size, n_gpus=1)
    arrays = sim.synthesise_arrays(sct, workload)
    # the paper measures deviation under the *tuned* configuration
    prof = build_profile(sct.unique_id(), workload, host=sched.host,
                         accel=sched.accel,
                         evaluate=hybrid.evaluator(sched, sct, workload,
                                                   arrays),
                         params=PARAMS).profile
    worst = 1.0
    for _ in range(runs):
        _, stats, _, _, _ = sched._dispatch(sct, arrays, prof)
        worst = min(worst, stats.deviation)
    return {"benchmark": name, "size": size, "runs": runs,
            "min_deviation": worst, "gpu_share": prof.share_a,
            "fission": prof.config.fission_level,
            "overlap": prof.config.overlap}


def _host_case(name: str, size: int, runs: int, device: str
               ) -> Dict[str, Any]:
    sched = hybrid.host_scheduler(device)
    try:
        res, ev = hybrid.host_tune(name, size, sched, device, PARAMS)
        prof = res.profile
        worst, walls, err = 1.0, [], None
        for _ in range(runs):
            outputs, stats, part, wall = ev.dispatch(prof.config,
                                                     prof.share_a)
            if err is None:
                err = paper_suite.check_outputs(name, ev.arrays, outputs,
                                                part, device)
            worst = min(worst, stats.deviation)
            walls.append(wall)
    finally:
        sched.close()
    return {"benchmark": name, "size": size, "runs": runs,
            "min_deviation": worst, "gpu_share": prof.share_a,
            "fission": prof.config.fission_level,
            "overlap": prof.config.overlap, "evals": res.evaluations,
            "walls": walls, "max_abs_err": err,
            "gpu_segments": ev.segments, "device": device}


def collect(full: bool = False, testbed: str = "host", device: str = "cuda",
            smoke: bool = False) -> Dict[str, Any]:
    runs = SMOKE_RUNS if smoke else (500 if full else 120)
    print(f"== maxDev calibration (Table 4, {runs} runs each) ==")
    lines: List[str] = []
    cells: List[Dict[str, Any]] = []
    for name, size in CASES:
        if testbed == "host":
            if smoke:
                size = hybrid.SMOKE[name]
            r = _host_case(name, size, runs, device)
        else:
            r = _sim_case(name, size, runs)
        cells.append(r)
        print(f"{name:18s} {size:>9d}  min deviation "
              f"{r['min_deviation']:.3f} (paper range: 0.825-0.979)")
        lines.append(f"maxdev,{name},{size},{r['min_deviation']:.4f}")
    return {"lines": lines, "cells": cells}


def main(full: bool = False, testbed: str = "host", device: str = "cuda",
         smoke: bool = False) -> List[str]:
    return collect(full, testbed, device, smoke)["lines"]


if __name__ == "__main__":
    import sys
    from repro_torch.bench import run
    sys.exit(run.main(["--only", "maxdev", *sys.argv[1:]]))
