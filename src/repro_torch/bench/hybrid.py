"""Table 3 / Figs 7-8 — CPU+GPU versus GPU-only executions.

For each paper benchmark x parameterisation class: run Algorithm 1
(profile construction), then compare the tuned hybrid execution with the
GPU-only baseline (share 1.0, ``NO_FISSION``, the tuned overlap).  The
paper claims a hybrid speedup of 1.11-2.07x (avg 1.72x) on 1 GPU and
1.00-1.88x (avg 1.56x) on 2 GPUs; N-body stays GPU-only; the CPU share
shrinks as GPUs are added.

Two testbeds:

* ``sim``: the JAX package's protocol on the calibrated 2013 hybrid
  testbed (i7-3930K + 1-2 HD 7950), the port's ``SimulatedExecutor``,
  1 and 2 GPUs.  Its lines equal ``benchmarks/hybrid.py``'s.
* ``host`` (the default): the same protocol on this machine, 1 GPU.  The
  host's cores are the fission slots (``HostPlatform`` over
  ``os.cpu_count()`` with the topology it yields), ``cuda:0`` streams
  the overlap slots (up to 4), through the ``ThreadedExecutor``; the
  bodies are the main path's (:mod:`repro_torch.suite`: the hand-written
  kernels on the card, cuFFT for the FFT) on :func:`paper_suite.host_inputs`.
  ``device="cpu"`` runs the accelerator slots on host threads (the
  tests); without a card and without it, the executor raises.

On the host:

* One untimed dispatch runs before the search: the first dispatch at a
  shape pays for the plan cache, the pinned staging buffers and the
  kernels' first launch.
* ``torch.set_num_threads`` is per process, and a thread that has run a
  parallel op keeps the count it found then (the OpenMP setting is made
  once per thread).  So the evaluator sets ``cores // slots`` of the
  level it evaluates in the main thread and in each host work queue's
  thread, and restores the earlier count after each evaluation; one
  count for all levels would oversubscribe L1 or starve NO_FISSION.
* Every evaluation must run without a fault (else it raises), and the
  tuned run's and the baseline's outputs are held to the plain versions.
* ``speedup`` is the reference's: one baseline dispatch over the least
  time of the whole search, which favours the hybrid on a noisy clock.
  ``speedup_turns`` re-times the tuned profile and the baseline in turns
  (5 runs each, wall clock of the whole dispatch) and divides their
  medians.
* The FFT runs 65536 float32 a row, as the main path does (the
  reference's workload says ``itemsize=8``).  Segmentation's largest
  class (3840 planes) needs ~15 GiB in and ~15 GiB out of pinned host
  memory; where inputs and outputs would pass :data:`HOST_MEMORY_SHARE`
  of the host's memory it is cut to the planes that fit, and the cell
  says so (``cut_from``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import statistics
import time
from typing import Any, Dict, List

import torch

from repro_torch.bench import paper_suite
from repro_torch.bench.paper_suite import (BENCHMARKS, cost_model_for,
                                           hybrid_testbed, workload_for)
from repro_torch.core import (AcceleratorPlatform, DeviceInfo, HostPlatform,
                              KnowledgeBase, TunerParams, build_profile,
                              infer_workload)
from repro_torch.core.distribution import Distribution
from repro_torch.core.executor import ThreadedExecutor
from repro_torch.core.knowledge_base import PlatformConfig, Profile
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.simulator import SimulatedExecutor

I7_TOPOLOGY = {"L1": 6, "L2": 6, "L3": 2, "NO_FISSION": 1}

CLASSES = {
    "filter_pipeline": [2048, 4096, 8192],
    "fft": [128, 256, 512],
    "nbody": [16384, 32768, 65536],
    "saxpy": [10 ** 6, 10 ** 7, 10 ** 8],
    "segmentation": [64, 512, 3840],
}
#: the host testbed's sizes at ``smoke`` (the CPU tests)
SMOKE = {"filter_pipeline": 64, "fft": 4, "nbody": 256, "saxpy": 1 << 14,
         "segmentation": 2}
#: overlap slots of the card, as the reference's accelerator platform
MAX_OVERLAP = 4
#: Algorithm 1's parameters, the reference's
PARAMS = TunerParams(number_executions=1, precision=1e-4)
#: hybrid and GPU-only runs each, in turns, after the search
TURNS = 5
#: the largest part of the host's memory a cell's inputs and outputs take
HOST_MEMORY_SHARE = 0.4


# ---------------------------------------------------------------------------
# sim: the reference's protocol on the 2013 testbed
# ---------------------------------------------------------------------------

def make_scheduler(name: str, size: int, n_gpus: int):
    host = HostPlatform(DeviceInfo("cpu", "cpu", compute_units=6),
                        topology=I7_TOPOLOGY)
    accel = AcceleratorPlatform(
        [DeviceInfo(f"gpu{i}", "gpu", peak_flops=2.87e12)
         for i in range(n_gpus)], max_overlap=MAX_OVERLAP)
    sim = SimulatedExecutor(hybrid_testbed(n_gpus), seed=1,
                            cost=cost_model_for(name, size))
    sched = Scheduler(host=host, accel=accel, executor=sim,
                      kb=KnowledgeBase())
    return sched, sim


def evaluator(sched: Scheduler, sct, workload, arrays):
    """The reference's evaluator: one dispatch at the candidate's
    configuration and share, returning (total, GPU-class, CPU-class)
    times."""
    def evaluate(cfg: PlatformConfig, dist: Distribution):
        prof = Profile(sct_id=sct.unique_id(), workload=workload,
                       share_a=dist.a, config=cfg, best_time=math.inf)
        _, stats, _, _, _ = sched._dispatch(sct, arrays, prof)
        return stats.total, stats.time_a, stats.time_b
    return evaluate


def tune_cell(name: str, size: int, n_gpus: int) -> Dict:
    sct = BENCHMARKS[name][0](size)
    workload = workload_for(name, size)
    sched, sim = make_scheduler(name, size, n_gpus)
    arrays = sim.synthesise_arrays(sct, workload)
    res = build_profile(sct.unique_id(), workload, host=sched.host,
                        accel=sched.accel,
                        evaluate=evaluator(sched, sct, workload, arrays),
                        params=PARAMS)
    # GPU-only baseline: share_a = 1, best overlap from the same tuner cfg
    base_prof = Profile(sct_id=sct.unique_id(), workload=workload,
                        share_a=1.0,
                        config=PlatformConfig(
                            fission_level="NO_FISSION",
                            overlap=res.profile.config.overlap))
    _, base_stats, _, _, _ = sched._dispatch(sct, arrays, base_prof)
    return {"benchmark": name, "size": size, "gpus": n_gpus,
            "hybrid_time": res.profile.best_time,
            "gpu_only_time": base_stats.total,
            "speedup": base_stats.total / max(res.profile.best_time, 1e-12),
            "gpu_share": res.profile.share_a,
            "fission": res.profile.config.fission_level,
            "overlap": res.profile.config.overlap,
            "evals": res.evaluations}


# ---------------------------------------------------------------------------
# host: the same protocol on this machine's cores and cuda:0 streams
# ---------------------------------------------------------------------------

def host_scheduler(device: str = "cuda") -> Scheduler:
    """This host's cores as the fission slots (``cpu0``), ``MAX_OVERLAP``
    stream slots on ``gpu0``; the executor raises without a card unless
    ``device`` is ``"cpu"``."""
    executor = ThreadedExecutor(device=device)
    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if executor.device.type == "cuda" else 1)
    host = HostPlatform(DeviceInfo("cpu0", "cpu",
                                   compute_units=os.cpu_count() or 1))
    accel = AcceleratorPlatform([DeviceInfo("gpu0", "gpu",
                                            compute_units=sms)],
                                max_overlap=MAX_OVERLAP)
    return Scheduler(host=host, accel=accel, executor=executor,
                     kb=KnowledgeBase())


def host_topology(sched: Scheduler) -> Dict[str, Any]:
    return {"cores": sched.host.device.compute_units,
            "topology": dict(sched.host.topology),
            "overlap_slots": sched.accel.max_overlap,
            "accelerator": str(sched.executor.device)}


def set_host_threads(sched: Scheduler, n: int) -> None:
    """``torch.set_num_threads(n)`` in this thread and in the thread of
    every host fission slot's work queue (a thread keeps the count it
    found at its first parallel op)."""
    names = [f"{sched.host.device.name}/f{i}"
             for i in range(max(sched.host.topology.values()))]
    queues = sched.executor._acquire_queues(names)
    for f in [q.submit(torch.set_num_threads, n) for q in queues.values()]:
        f.result()
    torch.set_num_threads(n)


def trace_rows(res) -> List[Dict[str, Any]]:
    """Algorithm 1's trace, one dict per timed configuration."""
    return [dataclasses.asdict(t) for t in res.trace]


def gpu_segments(part) -> int:
    """Accelerator slots of ``part`` that received work (each launches
    its SCT's kernels)."""
    return sum(1 for s, u in zip(part.slots, part.units)
               if s.device_type != "cpu" and u > 0)


class HostEvaluator:
    """Algorithm 1's evaluator over the live executor: one dispatch of
    the candidate configuration and share, at ``cores // slots`` threads
    of its fission level, restored after.  Counts the evaluations and the
    accelerator segments they launched; raises on any fault."""

    def __init__(self, sched: Scheduler, sct, workload, arrays):
        self.sched, self.sct = sched, sct
        self.workload, self.arrays = workload, arrays
        self.cores = sched.host.device.compute_units
        self.evaluations = 0
        self.segments = 0
        self.threads: Dict[str, int] = {}

    def threads_for(self, level: str) -> int:
        return max(1, self.cores // self.sched.host.topology[level])

    def dispatch(self, cfg: PlatformConfig, share_a: float):
        """One run; returns (outputs, stats, partitioning, wall seconds).
        The outputs alias the executor's buffers until its next run."""
        prof = Profile(sct_id=self.sct.unique_id(), workload=self.workload,
                       share_a=share_a, config=cfg, best_time=math.inf)
        before = torch.get_num_threads()
        n = self.threads_for(cfg.fission_level)
        self.threads[cfg.fission_level] = n
        set_host_threads(self.sched, n)
        try:
            t0 = time.perf_counter()
            outputs, stats, _, _, plan = self.sched._dispatch(
                self.sct, self.arrays, prof)
            wall = time.perf_counter() - t0
        finally:
            set_host_threads(self.sched, before)
        if not stats.ok:
            raise RuntimeError(
                f"{self.sct.unique_id()} at {cfg} share {share_a}: "
                f"{[f.message for f in stats.failures]}")
        self.segments += gpu_segments(plan.part)
        return outputs, stats, plan.part, wall

    def __call__(self, cfg: PlatformConfig, dist: Distribution):
        _, stats, _, _ = self.dispatch(cfg, dist.a)
        self.evaluations += 1
        return stats.total, stats.time_a, stats.time_b


def host_size(name: str, size: int) -> int:
    """``size``, or segmentation's planes cut to what
    :data:`HOST_MEMORY_SHARE` of the host's memory holds (in and out)."""
    if name != "segmentation":
        return size
    budget = HOST_MEMORY_SHARE * os.sysconf("SC_PAGE_SIZE") \
        * os.sysconf("SC_PHYS_PAGES")
    return max(1, min(size, int(budget // (2 * 4 * 1024 * 1024))))


def host_evaluator(name: str, size: int, sched: Scheduler,
                   device: str) -> HostEvaluator:
    """The main path's SCT of ``name`` at ``size`` on inputs from seed 0,
    after one untimed dispatch (its outputs checked)."""
    sct = paper_suite.host_sct(name, size)
    arrays = paper_suite.host_inputs(name, size, device)
    ev = HostEvaluator(sched, sct, infer_workload(sct, arrays), arrays)
    first = sched.host.get_configurations()[0].level
    outputs, _, part, _ = ev.dispatch(
        PlatformConfig(fission_level=first, overlap=1), 0.5)
    paper_suite.check_outputs(name, arrays, outputs, part, device)
    return ev


def host_tune(name: str, size: int, sched: Scheduler, device: str,
              params: TunerParams = PARAMS):
    """Algorithm 1 over the live executor, after :func:`host_evaluator`:
    returns (TuneResult, evaluator).  As in the reference's protocol the
    SCT is not given to the search, so it tries no work-group sizes (the
    kernels choose their own blocks)."""
    ev = host_evaluator(name, size, sched, device)
    res = build_profile(ev.sct.unique_id(), ev.workload, host=sched.host,
                        accel=sched.accel, evaluate=ev, params=params)
    return res, ev


def host_cell(name: str, size: int, device: str = "cuda") -> Dict[str, Any]:
    """One ``host`` cell: Algorithm 1, the reference's GPU-only baseline
    and speedup, then the tuned profile and the baseline re-timed in
    turns; both outputs checked."""
    ran = host_size(name, size)
    sched = host_scheduler(device)
    try:
        t0 = time.perf_counter()
        res, ev = host_tune(name, ran, sched, device)
        search_s = time.perf_counter() - t0
        best = res.profile
        tuned = best.config
        base = PlatformConfig(fission_level="NO_FISSION",
                              overlap=tuned.overlap)
        _, base_stats, _, _ = ev.dispatch(base, 1.0)
        walls: Dict[str, List[float]] = {"hybrid": [], "gpu_only": []}
        spans: Dict[str, List[float]] = {"hybrid": [], "gpu_only": []}
        errs: Dict[str, float] = {}
        for _ in range(TURNS):
            for leg, cfg, share in (("hybrid", tuned, best.share_a),
                                    ("gpu_only", base, 1.0)):
                outputs, stats, part, wall = ev.dispatch(cfg, share)
                walls[leg].append(wall)
                spans[leg].append(stats.total)
                if leg not in errs:
                    errs[leg] = paper_suite.check_outputs(
                        name, ev.arrays, outputs, part, device)
        hybrid_s = statistics.median(walls["hybrid"])
        gpu_only_s = statistics.median(walls["gpu_only"])
        cell = {
            "benchmark": name, "size": ran, "gpus": 1,
            "hybrid_time": best.best_time,
            "gpu_only_time": base_stats.total,
            "speedup": base_stats.total / max(best.best_time, 1e-12),
            "gpu_share": best.share_a, "fission": tuned.fission_level,
            "overlap": tuned.overlap, "evals": res.evaluations,
            "speedup_turns": gpu_only_s / max(hybrid_s, 1e-12),
            "hybrid_s": hybrid_s, "gpu_only_s": gpu_only_s,
            "hybrid_walls": walls["hybrid"],
            "gpu_only_walls": walls["gpu_only"],
            "hybrid_makespan_s": statistics.median(spans["hybrid"]),
            "gpu_only_makespan_s": statistics.median(spans["gpu_only"]),
            "max_abs_err": errs, "tolerance": paper_suite.TOLERANCES[name],
            "gpu_segments": ev.segments, "threads": dict(ev.threads),
            "search_s": search_s, "device": device,
            "host": host_topology(sched),
            "trace": trace_rows(res)}
        if ran != size:
            cell["cut_from"] = size
        return cell
    finally:
        sched.close()


def host_sizes(name: str, full: bool, smoke: bool) -> List[int]:
    if smoke:
        return [SMOKE[name]]
    return CLASSES[name] if full else CLASSES[name][1:2]


# ---------------------------------------------------------------------------

def collect(full: bool = False, testbed: str = "host", device: str = "cuda",
            smoke: bool = False) -> Dict[str, Any]:
    lines: List[str] = []
    cells: List[Dict[str, Any]] = []
    out: Dict[str, Any] = {"lines": lines, "cells": cells}
    print("== hybrid CPU+GPU vs GPU-only (Table 3 / Figs 7-8) ==")
    if testbed == "host":
        print(f"{'benchmark':18s} {'size':>9s} {'gpus':>4s} {'speedup':>8s} "
              f"{'turns':>7s} {'gpu share':>9s} {'fission':>10s} "
              f"{'overlap':>7s} {'evals':>5s} {'hybrid s':>9s} "
              f"{'gpu-only s':>10s}")
        for name in CLASSES:
            for size in host_sizes(name, full, smoke):
                r = host_cell(name, size, device)
                cells.append(r)
                print(f"{name:18s} {r['size']:>9d} {1:>4d} "
                      f"{r['speedup']:>8.2f} {r['speedup_turns']:>7.2f} "
                      f"{r['gpu_share']:>9.3f} {r['fission']:>10s} "
                      f"{r['overlap']:>7d} {r['evals']:>5d} "
                      f"{r['hybrid_s']:>9.4f} {r['gpu_only_s']:>10.4f}",
                      flush=True)
                lines.append(
                    f"hybrid,{name},{r['size']},1,{r['speedup']:.3f},"
                    f"{r['gpu_share']:.3f},{r['speedup_turns']:.3f}")
        out["host"] = cells[0]["host"]
        print(f"host: {out['host']}")
        avg = sum(r["speedup_turns"] for r in cells) / len(cells)
        print(f"  avg hybrid speedup in turns, 1 GPU: {avg:.2f}x "
              f"(paper: 1.72x)")
        lines.append(f"hybrid_avg_turns,1gpu,{avg:.3f}")
        return out
    print(f"{'benchmark':18s} {'size':>9s} {'gpus':>4s} {'speedup':>8s} "
          f"{'gpu share':>9s} {'fission':>9s} {'overlap':>7s}")
    shares = {1: [], 2: []}
    speeds = {1: [], 2: []}
    for name, sizes in CLASSES.items():
        use = sizes if full else sizes[1:2]
        for size in use:
            for n_gpus in (1, 2):
                r = tune_cell(name, size, n_gpus)
                cells.append(r)
                print(f"{name:18s} {size:>9d} {n_gpus:>4d} "
                      f"{r['speedup']:>8.2f} {r['gpu_share']:>9.2f} "
                      f"{r['fission']:>9s} {r['overlap']:>7d}")
                lines.append(
                    f"hybrid,{name},{size},{n_gpus},{r['speedup']:.3f},"
                    f"{r['gpu_share']:.3f}")
                shares[n_gpus].append(r["gpu_share"])
                speeds[n_gpus].append(r["speedup"])
    for g in (1, 2):
        if speeds[g]:
            avg = sum(speeds[g]) / len(speeds[g])
            print(f"  avg hybrid speedup {g} GPU(s): {avg:.2f}x "
                  f"(paper: {1.72 if g == 1 else 1.56:.2f}x)")
            lines.append(f"hybrid_avg,{g}gpu,{avg:.3f}")
    if shares[1] and shares[2]:
        s1 = sum(shares[1]) / len(shares[1])
        s2 = sum(shares[2]) / len(shares[2])
        print(f"  avg CPU share: {1 - s1:.2f} (1 GPU) -> {1 - s2:.2f} "
              f"(2 GPUs)  [paper: decreases]")
        lines.append(f"hybrid_cpu_share,{1 - s1:.3f},{1 - s2:.3f}")
    return out


def main(full: bool = False, testbed: str = "host", device: str = "cuda",
         smoke: bool = False) -> List[str]:
    return collect(full, testbed, device, smoke)["lines"]


if __name__ == "__main__":
    import sys
    from repro_torch.bench import run
    sys.exit(run.main(["--only", "hybrid", *sys.argv[1:]]))
