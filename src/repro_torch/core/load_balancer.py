"""Dynamic load balancing (paper Sec. 3.3).

Every SCT execution is monitored; per-execution statistics feed the
*load-balancing threshold*:

    lbt(n) = isUnbalanced(dev) * weight + lbt(n-1) * (1 - weight)

    isUnbalanced(x) = 0  if x / cFactor <= maxDev
                      1  otherwise

where ``dev`` is the deviation between the completion times of the
concurrent executions of the SCT, ``weight`` the weight of the last run
versus history (default 2/3 per the paper — 3-to-4 consecutive unbalanced
runs trigger balancing), ``maxDev`` the user bound (paper Table 4
calibrates [0.8, 0.85]) and ``cFactor`` a correction for computations that
prefer slightly unbalanced distributions.

A SCT is *unbalanced* when ``lbt(n) ~ 1``; the balancer then adjusts the
distribution with the :class:`~repro_torch.core.distribution.AdaptiveBinarySearch`
and persists improved configurations back into the KB (progressive profile
refinement).

Deviation convention: times t_1..t_p of the p concurrent executions give
``dev = min(t) / max(t)`` (1.0 = perfectly balanced), matching Table 4's
"all executions within 80..85% of the best performing one".  A run is
unbalanced when ``dev / cFactor < maxDev`` — the formula above with the
comparison inverted to match this convention.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.distribution import AdaptiveBinarySearch, Distribution
from repro_torch.core.telemetry import NULL_TELEMETRY


@dataclasses.dataclass
class ExecutionStats:
    """Statistics of one monitored SCT execution (paper Sec. 3.3).

    ``time_a`` / ``time_b`` are the per-class makespans (accelerator
    class first) recorded at dispatch time so the balancer, the
    autotuner's evaluator, and the device-health tracker all share one
    source of truth.  ``failures`` / ``retries`` carry the fault history
    of the run (see :mod:`repro_torch.core.faults`): a run with failures is
    excluded from lbt updates and KB ``best_time`` refinement so fault
    noise cannot corrupt learned profiles.

    The per-phase breakdown decomposes one scheduled run's wall time:
    ``plan_seconds`` (decomposition-plan derivation + partitioning, or a
    plan-cache lookup), ``pool_seconds`` (worker-pool acquisition; ~0
    when the persistent pool is reused), ``dispatch_seconds`` (segment
    setup and task launch), ``compute_seconds`` (the concurrent kernel
    attempts) and ``merge_seconds`` (result assembly).  ``merge_bytes``
    counts bytes copied at merge time — 0 on the resident-chain path and
    whenever every partitionable output was written in place by its
    slot.  ``plan_cache_hit`` / ``resident`` flag which fast paths the
    run took.
    """

    times: List[float]           # per concurrent execution
    share_a: float               # distribution in effect
    time_a: float = 0.0          # accelerator-class makespan
    time_b: float = 0.0          # host-class makespan
    failures: List = dataclasses.field(default_factory=list)  # FaultRecords
    retries: int = 0             # repartition/retry rounds consumed
    plan_seconds: float = 0.0    # plan build/partition (or cache lookup)
    pool_seconds: float = 0.0    # worker-pool creation/acquisition
    dispatch_seconds: float = 0.0  # segment setup + task launch
    compute_seconds: float = 0.0   # concurrent kernel execution (wall)
    merge_seconds: float = 0.0   # result assembly
    merge_bytes: int = 0         # bytes copied during merge (0 = zero-copy)
    plan_cache_hit: bool = False  # partitioning served from the plan cache
    resident: bool = False       # outputs left slot-resident (merge skipped)

    @property
    def ok(self) -> bool:
        return not self.failures

    @property
    def total(self) -> float:
        return max(self.times) if self.times else 0.0

    @property
    def overhead_seconds(self) -> float:
        """Non-compute dispatch overhead: plan + pool + dispatch + merge."""
        return (self.plan_seconds + self.pool_seconds
                + self.dispatch_seconds + self.merge_seconds)

    @property
    def deviation(self) -> float:
        if not self.times or max(self.times) <= 0:
            return 1.0
        return min(self.times) / max(self.times)


class LoadBalancer:
    """lbt-based unbalance detector + adaptive-binary-search corrector."""

    def __init__(self, *, max_dev: float = 0.85, weight: float = 2.0 / 3.0,
                 c_factor: float = 1.0, trigger: float = 0.9):
        if not 0 < weight <= 1:
            raise ValueError("weight in (0, 1]")
        self.max_dev = max_dev
        self.weight = weight
        self.c_factor = c_factor
        self.trigger = trigger          # lbt(n) ~ 1 -> balance
        self.lbt = 0.0
        self.unbalanced_runs = 0
        self.balance_ops = 0
        self.telemetry = NULL_TELEMETRY
        self._search: Optional[AdaptiveBinarySearch] = None

    # -- detector -------------------------------------------------------------
    def is_unbalanced(self, deviation: float) -> bool:
        return (deviation / self.c_factor) < self.max_dev

    def observe(self, stats: ExecutionStats) -> bool:
        """Update lbt with one execution; True if balancing should kick in.

        Runs that suffered slot faults are ignored: their per-slot times
        mix real compute with retry/repartition noise, so feeding them to
        the detector would trigger spurious balancing operations.
        """
        if not stats.ok:
            return False
        ub = 1.0 if self.is_unbalanced(stats.deviation) else 0.0
        if ub:
            self.unbalanced_runs += 1
            self.telemetry.metrics.counter("balancer_unbalanced_total").inc()
        self.lbt = ub * self.weight + self.lbt * (1.0 - self.weight)
        self.telemetry.metrics.gauge("balancer_lbt").set(self.lbt)
        triggered = self.lbt >= self.trigger
        if triggered:
            self.telemetry.events.emit(
                "balancer.trigger", lbt=round(self.lbt, 6),
                deviation=round(stats.deviation, 6),
                share_a=stats.share_a)
        return triggered

    # -- corrector --------------------------------------------------------------
    def adjust(self, current: Distribution, stats_a: float, stats_b: float,
               *, step: float = 0.05) -> Distribution:
        """One load-balancing operation: move work from worst to best class.

        ``stats_a`` / ``stats_b`` are the per-class completion times of the
        last run.  Keeps the adaptive search alive across calls so the
        shifting/doubling behaviour (Fig. 11) spans consecutive
        adjustments; the search restarts when balance has been re-attained
        (lbt back under trigger).
        """
        if self._search is None:
            self._search = AdaptiveBinarySearch(current, step=step)
            self._search.next()
        else:
            # re-anchor at the externally persisted distribution
            self._search.center = current
            self._search.next()
        new = self._search.feedback(stats_a, stats_b)
        self.balance_ops += 1
        self.telemetry.metrics.counter("balancer_adjustments_total").inc()
        self.telemetry.events.emit(
            "balancer.adjust", share_a_before=round(current.a, 6),
            share_a_after=round(new.a, 6), time_a=stats_a, time_b=stats_b)
        return new

    def reset_search(self) -> None:
        self._search = None

    def balanced_again(self) -> None:
        """Called when an execution round is balanced: cool down."""
        if self.lbt < self.trigger:
            self._search = None


def class_times(times: Sequence[float], n_a: int) -> tuple:
    """Split per-execution times into per-class makespans (a first)."""
    ta = max(times[:n_a]) if n_a else 0.0
    tb = max(times[n_a:]) if len(times) > n_a else 0.0
    return ta, tb
