"""Fig 5 — execution times measured during profile construction.

The FFT-256 trace: every (fission, overlap, distribution) configuration
Algorithm 1 times, in search order, showing the ordered-and-pruned walk
towards the optimum.  ``sim`` runs it on the calibrated 2013 hybrid
testbed (its line equals ``benchmarks/profile_construction.py``'s);
``host`` on this machine's cores and ``cuda:0`` streams, over the main
path's FFT SCT (cuFFT), printing the whole trace, with the tuned
profile's outputs held to numpy's float64 FFT.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

from repro_torch.bench import hybrid, paper_suite
from repro_torch.bench.paper_suite import BENCHMARKS, workload_for
from repro_torch.core import TunerParams, build_profile

#: the reference's parameters (the default precision, 0.02 s)
PARAMS = TunerParams(number_executions=1)
NAME, SIZE, SMOKE_SIZE = "fft", 256, 4


def _print_trace(res, full: bool) -> None:
    print(f"{'#':>3s} {'fission':>10s} {'overlap':>7s} {'gpu%':>6s} "
          f"{'time':>9s}")
    step = max(1, len(res.trace) // (40 if not full else len(res.trace)))
    for i, t in enumerate(res.trace):
        if i % step == 0 or i == len(res.trace) - 1:
            print(f"{i:>3d} {t.fission_level:>10s} {t.overlap:>7d} "
                  f"{100 * t.distribution:>5.1f} {t.time:>9.4f}")


def collect(full: bool = False, testbed: str = "host", device: str = "cuda",
            smoke: bool = False) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if testbed == "host":
        size = SMOKE_SIZE if smoke else SIZE
        sched = hybrid.host_scheduler(device)
        try:
            out["host"] = hybrid.host_topology(sched)
            t0 = time.perf_counter()
            res, ev = hybrid.host_tune(NAME, size, sched, device, PARAMS)
            search_s = time.perf_counter() - t0
            best = res.profile
            outputs, _, part, wall = ev.dispatch(best.config, best.share_a)
            err = paper_suite.check_outputs(NAME, ev.arrays, outputs, part,
                                            device)
        finally:
            sched.close()
        print(f"== profile construction trace (Fig 5, FFT-{size}, "
              f"host {out['host']}) ==")
        _print_trace(res, True)
        out["cell"] = {"benchmark": NAME, "size": size,
                       "evals": res.evaluations, "best_time": best.best_time,
                       "gpu_share": best.share_a,
                       "fission": best.config.fission_level,
                       "overlap": best.config.overlap, "tuned_s": wall,
                       "search_s": search_s, "max_abs_err": err,
                       "gpu_segments": ev.segments,
                       "threads": dict(ev.threads), "device": device,
                       "trace": hybrid.trace_rows(res)}
    else:
        size = SIZE
        sct = BENCHMARKS[NAME][0](size)
        workload = workload_for(NAME, size)
        sched, sim = hybrid.make_scheduler(NAME, size, n_gpus=1)
        arrays = sim.synthesise_arrays(sct, workload)
        res = build_profile(sct.unique_id(), workload, host=sched.host,
                            accel=sched.accel,
                            evaluate=hybrid.evaluator(sched, sct, workload,
                                                      arrays),
                            params=PARAMS)
        best = res.profile
        print("== profile construction trace (Fig 5, FFT-256) ==")
        _print_trace(res, full)
        out["cell"] = {"benchmark": NAME, "size": size,
                       "evals": res.evaluations, "best_time": best.best_time,
                       "gpu_share": best.share_a,
                       "fission": best.config.fission_level,
                       "overlap": best.config.overlap,
                       "trace": hybrid.trace_rows(res)}
    print(f"best: fission={best.config.fission_level} "
          f"overlap={best.config.overlap} gpu={best.share_a:.2f} "
          f"t={best.best_time:.4f} ({res.evaluations} evaluations)")
    out["lines"] = [f"profile_construction,fft,{size},{res.evaluations},"
                    f"{best.best_time:.5f},{best.config.fission_level},"
                    f"{best.config.overlap}"]
    return out


def main(full: bool = False, testbed: str = "host", device: str = "cuda",
         smoke: bool = False) -> List[str]:
    return collect(full, testbed, device, smoke)["lines"]


if __name__ == "__main__":
    import sys
    from repro_torch.bench import run
    sys.exit(run.main(["--only", "profile_construction", *sys.argv[1:]]))
