"""Workload distribution between device classes (paper Sec. 3.2.2 / 3.3.1).

Two search procedures over the CPU/GPU (here: slow-class/fast-class) split:

* :class:`WorkloadDistributionGenerator` — the paper's *binary search*.
  At every step the **transferable partition** is split evenly between the
  two device types; after observing which type finished first, the half
  assigned to the winner is *permanently bound* to it and the other half
  becomes the next transferable partition:

      transferableSize(n, size) = size / 2^n,  ->  0 as n -> inf

* :class:`AdaptiveBinarySearch` — the load-balancing variant (Sec. 3.3.1).
  The interval under inspection may *shift sideways* when the optimum has
  moved out of it (CPU load fluctuation), and after more than 2 shifts in
  the same direction the transferable partition **doubles** to speed up the
  chase of the new optimum.

Device classes are kept abstract ("a" = accelerator-like / GPU, "b" =
host-like / CPU in the paper; on the TPU adaptation they are fast/slow
slice classes of a heterogeneous pool).  Within one class, load is divided
*statically* by the per-device performance ratios measured at installation
time (paper: SHOC suite; here :mod:`repro_torch.core.platforms`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class Distribution:
    """A workload split: fraction of the domain per device type."""

    a: float  # fast class (GPU in the paper)
    b: float  # slow class (CPU in the paper)

    def __post_init__(self) -> None:
        if not (-1e-9 <= self.a <= 1 + 1e-9 and -1e-9 <= self.b <= 1 + 1e-9):
            raise ValueError(f"bad distribution ({self.a}, {self.b})")
        if abs(self.a + self.b - 1.0) > 1e-6:
            raise ValueError(f"distribution must sum to 1, got {self.a + self.b}")
        self.a = min(1.0, max(0.0, self.a))
        self.b = 1.0 - self.a

    def per_device(self, ratios_a: Sequence[float],
                   ratios_b: Sequence[float]) -> List[float]:
        """Static intra-class split by relative performance (paper Sec. 3.2).

        ``ratios_*``: one positive throughput score per device of the class
        (from install-time calibration).  Returns one share per device,
        class-a devices first.
        """
        out: List[float] = []
        for frac, ratios in ((self.a, ratios_a), (self.b, ratios_b)):
            tot = sum(ratios)
            if ratios and tot <= 0:
                raise ValueError("non-positive calibration ratios")
            out.extend(frac * r / tot for r in ratios)
        if not out:
            raise ValueError("no devices")
        return out


@dataclasses.dataclass
class _Step:
    dist: Distribution
    time_a: float
    time_b: float


class WorkloadDistributionGenerator:
    """Paper Sec. 3.2.2: binary-search workload distribution generator.

    Iterator protocol:
      >>> g = WorkloadDistributionGenerator()
      >>> d = g.next()                # candidate distribution
      >>> g.feedback(time_a, time_b)  # observed per-class completion times
      >>> d = g.next()                # refined candidate ...

    Internally tracks ``bound_a``/``bound_b`` (work permanently bound to a
    class) and ``transferable`` (work still under training).  Each candidate
    assigns every class its bound share plus half the transferable one.
    """

    def __init__(self, initial: Optional[Distribution] = None):
        if initial is None:
            self.bound_a = 0.0
            self.bound_b = 0.0
            self.transferable = 1.0
        else:
            # Warm start (used by the load balancer): treat the current
            # distribution as mostly bound, with a small transferable margin.
            self.transferable = 2 * min(initial.a, initial.b, 0.25)
            self.bound_a = initial.a - self.transferable / 2
            self.bound_b = initial.b - self.transferable / 2
        self.history: List[_Step] = []
        self._pending: Optional[Distribution] = None

    @property
    def iteration(self) -> int:
        return len(self.history)

    def transferable_size(self) -> float:
        """Paper: transferableSize(n, 1.0) = 1 / 2^n (cold start)."""
        return self.transferable

    def next(self) -> Distribution:
        d = Distribution(a=self.bound_a + self.transferable / 2,
                         b=self.bound_b + self.transferable / 2)
        self._pending = d
        return d

    def feedback(self, time_a: float, time_b: float) -> None:
        """Bind half the transferable partition to the faster class."""
        if self._pending is None:
            raise RuntimeError("feedback() without a pending next()")
        half = self.transferable / 2
        if time_a <= time_b:      # class a finished first -> bind to a
            self.bound_a += half
        else:
            self.bound_b += half
        self.transferable = half
        self.history.append(_Step(self._pending, time_a, time_b))
        self._pending = None

    def converged(self, precision: float) -> bool:
        """Stop when two consecutive candidates differ less than precision."""
        return self.transferable < precision


class AdaptiveBinarySearch:
    """Paper Sec. 3.3.1: binary search whose interval may shift sideways.

    Used by the dynamic load balancer.  Starts from the currently-persisted
    distribution.  Each round proposes a distribution; ``feedback`` moves
    load from the worst- to the best-performing class.  If the winner stays
    on the same side the interval *shifts* in that direction; after more
    than ``shift_doubling`` (=2) consecutive shifts in one direction the
    transferable partition doubles, speeding up convergence towards a far
    optimum (the "shifting phase" of Fig. 11).  Once the winner alternates,
    the procedure degenerates into the plain halving binary search.
    """

    def __init__(self, current: Distribution, *, step: float = 0.05,
                 shift_doubling: int = 2, max_step: float = 0.5):
        self.center = current
        self.transferable = step
        self.max_step = max_step
        self.shift_doubling = shift_doubling
        self._consecutive = 0          # signed count of same-direction shifts
        self._last_winner: Optional[str] = None
        self._pending: Optional[Distribution] = None
        self.history: List[_Step] = []

    def next(self) -> Distribution:
        self._pending = self.center
        return self.center

    def feedback(self, time_a: float, time_b: float) -> Distribution:
        if self._pending is None:
            raise RuntimeError("feedback() without a pending next()")
        winner = "a" if time_a < time_b else "b"
        if winner == self._last_winner:
            self._consecutive += 1
        else:
            self._consecutive = 1
            # direction flipped: enter plain binary search (halve the step)
            if self._last_winner is not None:
                self.transferable = max(self.transferable / 2, 1e-4)
        self._last_winner = winner

        # >2 shifts in the same direction -> double the transferable size
        if self._consecutive > self.shift_doubling:
            self.transferable = min(self.transferable * 2, self.max_step)

        delta = self.transferable
        if winner == "a":   # a faster -> move work towards a
            new_a = min(1.0, self.center.a + delta)
        else:
            new_a = max(0.0, self.center.a - delta)
        self.history.append(_Step(self._pending, time_a, time_b))
        self.center = Distribution(a=new_a, b=1.0 - new_a)
        self._pending = None
        return self.center

    def converged(self, precision: float) -> bool:
        return self.transferable < precision


def run_binary_search(measure, *, precision: float = 0.01,
                      max_iters: int = 32) -> Tuple[Distribution, int]:
    """Drive a cold-start binary search to convergence.

    ``measure(dist) -> (time_a, time_b)`` executes (or simulates) the SCT
    under the candidate distribution.  Returns the final distribution and
    the number of iterations used.
    """
    g = WorkloadDistributionGenerator()
    d = g.next()
    for it in range(max_iters):
        ta, tb = measure(d)
        g.feedback(ta, tb)
        if g.converged(precision):
            break
        d = g.next()
    return g.next(), g.iteration


def balance_until_stable(measure, current: Distribution, *,
                         precision: float = 0.005, max_iters: int = 64,
                         step: float = 0.05) -> Tuple[Distribution, int]:
    """Drive the adaptive binary search until its step is below precision."""
    s = AdaptiveBinarySearch(current, step=step)
    d = s.next()
    for it in range(max_iters):
        ta, tb = measure(d)
        d = s.feedback(ta, tb)
        if s.converged(precision):
            break
        s.next()
    return s.center, len(s.history)
