"""Table 5 / Figs 9-10 — KB configuration derivation vs profile
construction.

Protocol (paper Sec. 4.2.2): independently build a profile for each of 8
image sizes (the baselines; 5 by default); then, starting from a KB
holding only Image 0's profile, process the other images via *derivation
only*, measuring the derived-distribution error, the performance error,
the number of unbalanced executions (of 100; 30 by default) and
load-balance operations.  Paper claims: distribution error < 3%,
performance error < 5% after the first three images, balancer fires < 4
times per 100 in steady state.

``sim`` runs the calibrated 2013 hybrid testbed (its lines equal
``benchmarks/kb_derivation.py``'s); ``host`` builds the baselines with
Algorithm 1 on this machine's cores and ``cuda:0`` streams over the main
path's filter (one fused kernel), then runs the same protocol there;
each image's first dispatch is checked against the plain version.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

from repro_torch.bench import hybrid
from repro_torch.bench.paper_suite import BENCHMARKS
from repro_torch.core import (KnowledgeBase, LoadBalancer, TunerParams,
                              build_profile)
from repro_torch.core.distribution import Distribution
from repro_torch.core.knowledge_base import Origin, Profile
from repro_torch.core.spec import Workload

#: the paper's image sequence (Table 5)
IMAGES = [1024, 4288, 512, 8192, 1800, 2048, 256, 1440]
#: the reference's parameters (the default precision, 0.02 s)
PARAMS = TunerParams(number_executions=1)
#: ``smoke`` images are the paper's over SMOKE_SCALE, runs SMOKE_RUNS
SMOKE_SCALE, SMOKE_RUNS = 32, 4
NAME = "filter_pipeline"


class _Image:
    """One image size on a testbed: its SCT, workload, Algorithm 1 and a
    dispatch of a profile.  ``sim``: a fresh simulated scheduler (seed 1,
    as the reference makes one for each baseline and each derivation);
    ``host``: a host scheduler on the main path's filter."""

    def __init__(self, size: int, testbed: str, device: str):
        if testbed == "host":
            self.sched = hybrid.host_scheduler(device)
            self.ev = hybrid.host_evaluator(NAME, size, self.sched, device)
            self.sct, self.workload = self.ev.sct, self.ev.workload
            self.evaluate = self.ev
        else:
            self.sct = BENCHMARKS[NAME][0](size)
            self.workload = Workload((size, size))
            self.sched, sim = hybrid.make_scheduler(NAME, size, n_gpus=1)
            self.arrays = sim.synthesise_arrays(self.sct, self.workload)
            self.ev = None
            self.evaluate = hybrid.evaluator(self.sched, self.sct,
                                             self.workload, self.arrays)

    def baseline(self) -> Profile:
        return build_profile(self.sct.unique_id(), self.workload,
                             host=self.sched.host, accel=self.sched.accel,
                             evaluate=self.evaluate, params=PARAMS).profile

    def run(self, prof: Profile):
        if self.ev is not None:
            return self.ev.dispatch(prof.config, prof.share_a)[1]
        return self.sched._dispatch(self.sct, self.arrays, prof)[1]

    def close(self) -> None:
        if self.ev is not None:
            self.sched.close()


def _baseline(size: int, testbed: str, device: str) -> Profile:
    image = _Image(size, testbed, device)
    try:
        return image.baseline()
    finally:
        image.close()


def collect(full: bool = False, testbed: str = "host", device: str = "cuda",
            smoke: bool = False) -> Dict[str, Any]:
    runs = SMOKE_RUNS if smoke else (100 if full else 30)
    print("== KB derivation vs construction (Table 5 / Figs 9-10) ==")
    sizes = IMAGES if full else IMAGES[:5]
    if smoke:
        sizes = [max(8, s // SMOKE_SCALE) for s in sizes]
    baselines: Dict[int, Profile] = {s: _baseline(s, testbed, device)
                                     for s in sizes}

    kb = KnowledgeBase()
    kb.store(baselines[sizes[0]])
    lines: List[str] = []
    cells: List[Dict[str, Any]] = []
    print(f"{'image':>6s} {'built gpu%':>10s} {'derived gpu%':>12s} "
          f"{'dist err%':>9s} {'perf err%':>9s} {'unbal':>6s} {'ops':>4s}")
    for size in sizes[1:]:
        image = _Image(size, testbed, device)
        try:
            image.sched.kb = kb
            workload = image.workload
            derived = kb.derive(image.sct.unique_id(), workload)
            base = baselines[size]
            dist_err = abs(derived.share_a - base.share_a) * 100

            # run 100 executions with balancing, as the paper does
            balancer = LoadBalancer(max_dev=0.85)
            cur = derived
            unbalanced = ops = 0
            best_time = math.inf
            for _ in range(runs):
                stats = image.run(cur)
                best_time = min(best_time, stats.total)
                if balancer.is_unbalanced(stats.deviation):
                    unbalanced += 1
                if balancer.observe(stats):
                    new = balancer.adjust(
                        Distribution(a=cur.share_a, b=1 - cur.share_a),
                        stats.time_a, stats.time_b)
                    cur = Profile(sct_id=cur.sct_id, workload=workload,
                                  share_a=new.a, config=cur.config,
                                  best_time=math.inf, origin=Origin.DERIVED)
                    ops += 1
                    balancer.lbt = 0.0
        finally:
            image.close()
        kb.store(Profile(sct_id=cur.sct_id, workload=workload,
                         share_a=cur.share_a, config=cur.config,
                         best_time=best_time, origin=Origin.DERIVED))
        perf_err = (best_time - base.best_time) / base.best_time * 100
        cells.append({"image": size, "built_share": base.share_a,
                      "derived_share": derived.share_a,
                      "final_share": cur.share_a,
                      "built_time": base.best_time, "best_time": best_time,
                      "dist_err_pct": dist_err, "perf_err_pct": perf_err,
                      "unbalanced": unbalanced, "ops": ops, "runs": runs,
                      "fission": cur.config.fission_level,
                      "overlap": cur.config.overlap})
        print(f"{size:>6d} {100 * base.share_a:>10.1f} "
              f"{100 * derived.share_a:>12.1f} {dist_err:>9.2f} "
              f"{perf_err:>9.2f} {unbalanced:>6d} {ops:>4d}")
        lines.append(f"kb_derivation,{size},{dist_err:.2f},"
                     f"{perf_err:.2f},{unbalanced},{ops}")
    return {"lines": lines, "cells": cells,
            "baselines": {s: {"share": p.share_a, "best_time": p.best_time,
                              "fission": p.config.fission_level,
                              "overlap": p.config.overlap}
                          for s, p in baselines.items()}}


def main(full: bool = False, testbed: str = "host", device: str = "cuda",
         smoke: bool = False) -> List[str]:
    return collect(full, testbed, device, smoke)["lines"]


if __name__ == "__main__":
    import sys
    from repro_torch.bench import run
    sys.exit(run.main(["--only", "kb_derivation", *sys.argv[1:]]))
