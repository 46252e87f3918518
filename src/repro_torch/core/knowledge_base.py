"""Knowledge Base + configuration derivation (paper Sec. 3.2.1 / 3.2.3).

The KB stores :class:`Profile` records — everything needed to reproduce a
framework configuration for one (SCT, workload) pair:

  a) SCT unique identifier,
  b) workload characterisation (dims, element size),
  c) workload share per device (class),
  d) per-device execution-platform configuration (fission level, overlap
     factor, per-kernel work-group/block sizes),
  e) minimum execution time measured for this configuration,
  f) the generation process: BUILT (empirical, Algorithm 1) or DERIVED.

Configuration derivation for an unseen (SCT, workload) applies
multidimensional scattered-data interpolation over the collected profiles:

  * workload dimensionality 1–3  ->  Gaussian **RBF network** (the paper
    uses Alglib's fast RBF; we implement the classical regularised RBF
    solve in numpy — identical model class),
  * dimensionality  > 3          ->  **nearest neighbour** (Euclidean).

Scope-widening rules (paper): first interpolate over profiles of the *same
SCT*; failing that, profiles of the *same workload* under any SCT; failing
that, any profile of the same *dimensionality*.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import math
import os
import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.spec import Workload


class Origin(enum.Enum):
    BUILT = "built"       # empirical profile construction (Algorithm 1)
    DERIVED = "derived"   # interpolated from the KB


@dataclasses.dataclass
class PlatformConfig:
    """Execution-platform configuration (paper Sec. 3.2.1 item d).

    TPU adaptation: ``fission_level`` = mesh-fission level of the host/slow
    class; ``overlap`` = in-flight microbatch depth of the accelerator
    class; ``wgs`` = per-kernel work-group (block) sizes.
    """

    fission_level: str = "NO_FISSION"
    overlap: int = 1
    wgs: Dict[str, int] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict:
        return {"fission_level": self.fission_level, "overlap": self.overlap,
                "wgs": dict(self.wgs)}

    @staticmethod
    def from_json(d: Dict) -> "PlatformConfig":
        return PlatformConfig(fission_level=d["fission_level"],
                              overlap=int(d["overlap"]),
                              wgs={k: int(v) for k, v in d["wgs"].items()})


@dataclasses.dataclass
class Profile:
    sct_id: str
    workload: Workload
    share_a: float                      # fast-class (GPU) share of the work
    config: PlatformConfig
    best_time: float = math.inf
    origin: Origin = Origin.BUILT

    @property
    def share_b(self) -> float:
        return 1.0 - self.share_a

    def key(self) -> Tuple[str, str]:
        return (self.sct_id, self.workload.key())

    def to_json(self) -> Dict:
        return {"sct_id": self.sct_id,
                "dims": list(self.workload.dims),
                "itemsize": self.workload.itemsize,
                "share_a": self.share_a,
                "config": self.config.to_json(),
                "best_time": self.best_time,
                "origin": self.origin.value}

    @staticmethod
    def from_json(d: Dict) -> "Profile":
        return Profile(sct_id=d["sct_id"],
                       workload=Workload(tuple(d["dims"]), d["itemsize"]),
                       share_a=float(d["share_a"]),
                       config=PlatformConfig.from_json(d["config"]),
                       best_time=float(d["best_time"]),
                       origin=Origin(d["origin"]))


# ---------------------------------------------------------------------------
# Scattered-data interpolation
# ---------------------------------------------------------------------------

class RBFNetwork:
    """Regularised Gaussian radial-basis-function network.

    phi(r) = exp(-(r/sigma)^2); weights from the regularised linear solve
    (Phi + lam*I) w = y.  Features are standardised (zero mean / unit std)
    before fitting — workload dims span orders of magnitude.
    """

    def __init__(self, sigma: Optional[float] = None, lam: float = 1e-8):
        self.sigma = sigma
        self.lam = lam
        self._x: Optional[np.ndarray] = None
        self._w: Optional[np.ndarray] = None
        self._mu: Optional[np.ndarray] = None
        self._sd: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RBFNetwork":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.ndim != 2 or len(x) != len(y):
            raise ValueError("bad RBF training data")
        self._mu = x.mean(axis=0)
        self._sd = np.where(x.std(axis=0) > 0, x.std(axis=0), 1.0)
        xs = (x - self._mu) / self._sd
        if self.sigma is None:
            # median pairwise distance heuristic
            if len(xs) > 1:
                d = np.sqrt(((xs[:, None, :] - xs[None, :, :]) ** 2).sum(-1))
                med = float(np.median(d[d > 0])) if (d > 0).any() else 1.0
                self.sigma = max(med, 1e-6)
            else:
                self.sigma = 1.0
        phi = self._phi(xs, xs)
        n = len(xs)
        self._w = np.linalg.solve(phi + self.lam * np.eye(n), y)
        self._x = xs
        return self

    def _phi(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / (self.sigma ** 2))

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        one = x.ndim == 1
        if one:
            x = x[None, :]
        xs = (x - self._mu) / self._sd
        out = self._phi(xs, self._x) @ self._w
        return out[0] if one else out


def nearest_neighbour(x: np.ndarray, pts: np.ndarray) -> int:
    """Index of the Euclidean nearest neighbour (log-scaled features)."""
    lx = np.log1p(np.asarray(x, dtype=np.float64))
    lp = np.log1p(np.asarray(pts, dtype=np.float64))
    d = ((lp - lx[None, :]) ** 2).sum(-1)
    return int(np.argmin(d))


# ---------------------------------------------------------------------------
# The Knowledge Base
# ---------------------------------------------------------------------------

class KnowledgeBase:
    """Profile store + inference engine (paper Fig. 2 / Sec. 3.2.3)."""

    RBF_MAX_DIM = 3   # paper: RBF for dims 1..3, NN beyond

    def __init__(self, path: Optional[str] = None):
        self._profiles: Dict[Tuple[str, str], Profile] = {}
        # concurrent graph nodes store/derive from multiple scheduler
        # threads; RLock because store() may nest inside derive()/save()
        self._lock = threading.RLock()
        self.path = path
        if path and os.path.exists(path):
            self.load(path)

    # -- storage ------------------------------------------------------------
    def store(self, profile: Profile) -> None:
        """Persist a profile, keeping only the best time per (SCT, workload).

        ``best_time`` must be positive (or ``inf`` for not-yet-measured
        profiles): NaN / non-positive times — e.g. from a run that
        suffered slot faults and was mis-reported — are rejected so fault
        noise can never displace a genuinely measured best configuration
        (the Scheduler additionally excludes failed runs upstream).
        """
        if math.isnan(profile.best_time) or profile.best_time <= 0:
            raise ValueError(
                f"refusing to store profile with best_time="
                f"{profile.best_time!r} for {profile.key()}")
        with self._lock:
            k = profile.key()
            old = self._profiles.get(k)
            if old is None or profile.best_time <= old.best_time:
                self._profiles[k] = profile
                if self.path:
                    self.save(self.path)

    def exact(self, sct_id: str, workload: Workload) -> Optional[Profile]:
        with self._lock:
            return self._profiles.get((sct_id, workload.key()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._profiles)

    def profiles(self) -> List[Profile]:
        with self._lock:
            return list(self._profiles.values())

    # -- persistence (atomic) -------------------------------------------------
    def save(self, path: str) -> None:
        with self._lock:
            payload = json.dumps(
                [p.to_json() for p in self._profiles.values()], indent=1)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".kb.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load(self, path: str) -> None:
        with open(path) as f:
            records = json.load(f)
        with self._lock:
            for d in records:
                p = Profile.from_json(d)
                self._profiles[p.key()] = p

    # -- derivation (paper Sec. 3.2.3) ---------------------------------------
    def derive(self, sct_id: str, workload: Workload) -> Optional[Profile]:
        """Derive a configuration for an unseen (SCT, workload).

        Scope widening: same-SCT profiles -> same-workload profiles (any
        SCT) -> same-dimensionality profiles.  Returns ``None`` only when
        the KB is empty of usable data.
        """
        hit = self.exact(sct_id, workload)
        if hit is not None:
            return hit
        with self._lock:
            pool = list(self._profiles.values())
        scopes = (
            [p for p in pool if p.sct_id == sct_id
             and p.workload.ndim == workload.ndim],
            [p for p in pool
             if p.workload.key() == workload.key()],
            [p for p in pool
             if p.workload.ndim == workload.ndim],
        )
        for cand in scopes:
            if cand:
                return self._interpolate(sct_id, workload, cand)
        return None

    def _interpolate(self, sct_id: str, workload: Workload,
                     cand: Sequence[Profile]) -> Profile:
        feats = np.array([p.workload.as_features() for p in cand])
        target = np.array(workload.as_features())
        nn = cand[nearest_neighbour(target, feats)]
        if workload.ndim <= self.RBF_MAX_DIM and len(cand) >= 2:
            # interpolate the continuous quantities with the RBF network;
            # discrete platform choices come from the nearest neighbour.
            try:
                lf = np.log1p(feats)
                lt = np.log1p(target)
                share = float(np.clip(
                    RBFNetwork().fit(lf, np.array([p.share_a for p in cand]))
                    .predict(lt), 0.0, 1.0))
                overlap = int(round(float(np.clip(
                    RBFNetwork().fit(
                        lf, np.array([float(p.config.overlap) for p in cand]))
                    .predict(lt), 1, 64))))
            except np.linalg.LinAlgError:
                share, overlap = nn.share_a, nn.config.overlap
        else:
            share, overlap = nn.share_a, nn.config.overlap
        cfg = PlatformConfig(fission_level=nn.config.fission_level,
                             overlap=overlap, wgs=dict(nn.config.wgs))
        return Profile(sct_id=sct_id, workload=workload, share_a=share,
                       config=cfg, best_time=math.inf, origin=Origin.DERIVED)
