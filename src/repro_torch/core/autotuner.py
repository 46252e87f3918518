"""Profile construction — the paper's Algorithm 1 (Sec. 3.2.2).

Searches the configuration space

    (CPU fission level) x (GPU overlap factor) x (per-kernel work-group
    sizes) x (CPU/GPU workload distribution)

for the globally best-performing tuple.  The search is *ordered* and
*pruned* exactly as in the paper:

  * fission levels are tried L1 -> ... -> NO_FISSION,
  * overlap factors in natural order 1, 2, ...,
  * work-group sizes in non-increasing occupancy order (threshold-filtered),
  * whenever a candidate value fails to improve on the previous one, all
    subsequent values of that dimension are **discarded**,
  * the inner workload-distribution loop is the binary-search generator,
    stopped when two consecutive overall times differ by less than
    ``precision``,
  * each timed point is the best of ``number_executions`` runs (the
    paper's quality factor against performance fluctuations).

The evaluator is injected: the *real* executor times actual partitioned
executions on this host; the *simulator* (benchmarks reproducing the
paper's figures) and the *roofline evaluator* (TPU sharding hillclimb,
Sec. Perf) implement the same callable interface.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.distribution import Distribution, WorkloadDistributionGenerator
from repro_torch.core.knowledge_base import (KnowledgeBase, Origin, PlatformConfig,
                                             Profile)
from repro_torch.core.occupancy import BlockScore
from repro_torch.core.platforms import AcceleratorPlatform, HostPlatform
from repro_torch.core.spec import Workload

#: evaluator(config, distribution) -> (total_time, time_a, time_b)
Evaluator = Callable[[PlatformConfig, Distribution], Tuple[float, float, float]]


@dataclasses.dataclass
class TunerParams:
    occupancy_threshold: float = 0.80
    precision: float = 0.02          # seconds (or simulator units)
    number_executions: int = 3
    max_distribution_iters: int = 12


@dataclasses.dataclass
class TraceEntry:
    """One timed configuration — Fig. 5 is a plot of these."""

    fission_level: str
    overlap: int
    wgs: Dict[str, int]
    distribution: float              # share of class a
    time: float


@dataclasses.dataclass
class TuneResult:
    profile: Profile
    trace: List[TraceEntry]
    evaluations: int


def _wgs_product(per_kernel: Dict[str, List[BlockScore]]
                 ) -> List[Dict[str, int]]:
    """Candidate work-group assignments, best-occupancy-first.

    Rather than the full cartesian product (exponential), Algorithm 1's
    ordered-and-discardable iteration is realised rank-by-rank: rank k
    assigns every kernel its k-th best block size (clamped), which yields
    the same non-increasing-occupancy order the paper prescribes.
    """
    if not per_kernel:
        return [{}]
    depth = max(len(v) for v in per_kernel.values())
    out = []
    for k in range(depth):
        out.append({name: scores[min(k, len(scores) - 1)].wgs
                    for name, scores in per_kernel.items()})
    # dedupe consecutive identical assignments
    uniq: List[Dict[str, int]] = []
    for a in out:
        if not uniq or a != uniq[-1]:
            uniq.append(a)
    return uniq


def build_profile(sct_id: str, workload: Workload, *,
                  host: HostPlatform, accel: AcceleratorPlatform,
                  evaluate: Evaluator, params: TunerParams = TunerParams(),
                  kb: Optional[KnowledgeBase] = None,
                  sct=None) -> TuneResult:
    """Algorithm 1.  Returns the best profile plus the full search trace."""
    trace: List[TraceEntry] = []
    evals = 0
    best_profile = Profile(sct_id=sct_id, workload=workload, share_a=1.0,
                           config=PlatformConfig(), best_time=math.inf,
                           origin=Origin.BUILT)

    cpu_configurations = host.get_configurations(sct, None)           # step 1
    overlaps, wgs_cands = accel.get_configurations(                   # step 2
        sct, None, domain_size=workload.size)
    wgs_assignments = _wgs_product(wgs_cands)                         # step 3

    prev_fission_best = math.inf
    for fission in cpu_configurations:
        host.configure(fission.level)                                 # step 5
        prev_overlap_best = math.inf
        fission_best = math.inf
        for overlap in overlaps:
            accel.configure(overlap)                                  # step 7
            prev_wgs_best = math.inf
            overlap_best = math.inf
            for wgs in wgs_assignments:
                cfg = PlatformConfig(fission_level=fission.level,
                                     overlap=overlap, wgs=dict(wgs))
                wldg = WorkloadDistributionGenerator()                # step 9
                wgs_best = math.inf
                prev_time = math.inf
                for _ in range(params.max_distribution_iters):
                    dist = wldg.next()                                # step 11
                    # steps 12-13: partition + execute (best of N)
                    total, ta, tb = math.inf, math.inf, math.inf
                    for _ in range(params.number_executions):
                        t, a, b = evaluate(cfg, dist)
                        if t < total:
                            total, ta, tb = t, a, b
                    evals += 1
                    trace.append(TraceEntry(fission.level, overlap, dict(wgs),
                                            dist.a, total))
                    wldg.feedback(ta, tb)
                    wgs_best = min(wgs_best, total)
                    if total < best_profile.best_time:                # 15-16
                        best_profile = Profile(
                            sct_id=sct_id, workload=workload, share_a=dist.a,
                            config=cfg, best_time=total, origin=Origin.BUILT)
                    if abs(prev_time - total) < params.precision:     # step 17
                        break
                    prev_time = total
                overlap_best = min(overlap_best, wgs_best)
                if wgs_best >= prev_wgs_best:                         # step 21
                    break                                             # discard
                prev_wgs_best = wgs_best
            fission_best = min(fission_best, overlap_best)
            if overlap_best >= prev_overlap_best:                     # step 23
                break
            prev_overlap_best = overlap_best
        if fission_best >= prev_fission_best:                         # step 25
            break
        prev_fission_best = fission_best

    if kb is not None:
        kb.store(best_profile)                                        # persist
    return TuneResult(profile=best_profile, trace=trace, evaluations=evals)
