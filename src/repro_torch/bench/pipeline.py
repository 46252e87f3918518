"""Pipeline benchmark: graph-based concurrent submission (JobGraph).

Measures what the graph pipeline buys over the historical blocking
FCFS dispatch, in two deterministic virtual-time phases plus one
wall-clock phase:

  * **virtual throughput** — a fan-out JobGraph of K independent nodes
    with complementary device affinity (half pinned gpu-heavy, half
    cpu-heavy via KB profiles) on the :class:`SimulatedExecutor`,
    against the same K nodes forced into a serial chain (the FCFS
    order).  Virtual makespans are exact — no timer noise — so the
    speedup is gated at > 1.5x.
  * **virtual overlap** — a 3-node fan-out whose spans must share a
    common instant (three nodes simultaneously in flight on the
    per-device work queues); gated.
  * **threaded** — the same fan-out on the real ThreadedExecutor:
    bit-identical outputs vs. blocking sequential runs (gated), also
    under an injected per-node fault recovered by graph-level retry
    (gated), plus the wall-clock phase below.
  * **graph plan cache** — the same graph submitted twice: the second
    submission must be served from the whole-graph plan cache, with
    every node pre-planned and **zero decide/plan lock acquisitions**
    while it runs (gated), and bit-identical outputs (gated).
  * **fusion** — K identical single-node requests submitted
    concurrently with ``fusion_window`` set: they must coalesce into
    one fused run (one decide + dispatch + merge) whose slices are
    bit-identical to independently-run requests (gated), including
    under an injected fault recovered by in-run repartition (gated).
  * **wall throughput** (inside ``threaded``) — K identical small
    requests, serialized FCFS vs. concurrent admission with fusion.
    This is fusion's target regime — a high rate of small requests —
    and the ratio is **gated** (> 1.0 in full mode, a generous 0.4
    floor in --smoke for shared hosts).  The distinct-node
    fan-out ratio stays reported-only as ``wall_distinct_gain_x``: on
    a single-core host concurrency alone cannot beat serialization,
    which is precisely why admission-side fusion exists.

Accelerator slots run on CUDA streams of ``cuda:0`` (``--device cuda``,
the default) or on host threads (``--device cpu``); the virtual phases
run on the simulator either way.  Inputs are numpy arrays; outputs are
compared as host tensors.  Emits ``build/BENCH_pipeline_torch.json``
(with an embedded telemetry metrics block via
:func:`repro_torch.bench.report.embed_metrics`).  ``--check`` applies
:func:`deterministic_failures` and :func:`wall_failures`.

Run:  PYTHONPATH=src python -m repro_torch.bench.pipeline [--smoke] [--check] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List

import numpy as np

import torch

from repro_torch.bench.report import embed_metrics, host, write
from repro_torch.core import (AcceleratorPlatform, DeviceInfo, FaultInjector,
                              FaultPolicy, HostPlatform, JobGraph,
                              KnowledgeBase, LoadBalancer, Origin,
                              PlatformConfig, Profile, Scheduler, Session,
                              Telemetry, ThreadedExecutor, Workload, kernel,
                              vector)
from repro_torch.core.simulator import CostModel, SimDevice, SimulatedExecutor

# a huge watchdog multiple disables spurious timeout trips on busy hosts
POLICY = FaultPolicy(watchdog_multiple=1e6)


def node_kernel(i: int):
    """One independent graph node; distinct sct-id and output name."""
    c = np.float32(i + 1)
    return kernel(lambda x, y, c=c: x * c + y, name=f"node{i}",
                  inputs=[vector("x"), vector("y")],
                  outputs=[vector(f"o{i}")])


def make_arrays(n: int):
    return {"x": np.arange(n, dtype=np.float32),
            "y": np.ones(n, dtype=np.float32)}


def make_scheduler(executor, **kw) -> Scheduler:
    host = HostPlatform(DeviceInfo("cpu0", "cpu", compute_units=4),
                        topology={"L2": 2, "NO_FISSION": 1})
    accel = AcceleratorPlatform([DeviceInfo("gpu0", "gpu")], max_overlap=2)
    kw.setdefault("balancer", LoadBalancer(max_dev=0.0))
    kw.setdefault("kb", KnowledgeBase())
    return Scheduler(host=host, accel=accel, executor=executor, **kw)


def pin(sched: Scheduler, sct, n: int, share_a: float) -> None:
    sched.kb.store(Profile(
        sct_id=sct.unique_id(), workload=Workload((n,)), share_a=share_a,
        config=PlatformConfig(), best_time=float("inf"),
        origin=Origin.DERIVED))


# ---------------------------------------------------------------------------
# Virtual phases (deterministic — gated)
# ---------------------------------------------------------------------------

def virtual_scheduler(*, symmetric: bool) -> Scheduler:
    """Simulator whose compute dwarfs per-slot dispatch overhead.

    ``symmetric`` gives the CPU the GPU's throughput, so a gpu-heavy
    and a cpu-heavy node have equal makespans and the two device work
    queues carry equal totals — the ideal pipelining scenario."""
    devs = [SimDevice("gpu0", "gpu", flops=1e12),
            SimDevice("cpu0", "cpu", flops=1e12 if symmetric else 1e11,
                      cores=4)]
    sim = SimulatedExecutor(devs, noise=0.0,
                            cost=CostModel(flops_per_unit=1e6,
                                           bytes_per_unit=0.0))
    return make_scheduler(sim)


def graph_makespan(handle) -> float:
    spans = handle.spans().values()
    return (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e6


def bench_virtual_throughput(n: int, k: int) -> dict:
    """Fan-out of K complementary nodes vs. the same nodes serialised."""
    scts = [node_kernel(i) for i in range(k)]
    shares = [0.95 if i % 2 == 0 else 0.05 for i in range(k)]

    # serialized FCFS: a linear chain forces one-at-a-time execution
    serial = virtual_scheduler(symmetric=True)
    g_serial = JobGraph()
    prev = ()
    for sct, sh in zip(scts, shares):
        pin(serial, sct, n, sh)
        prev = (g_serial.add(sct, after=prev),)
    t_serial = graph_makespan(serial.submit(g_serial, make_arrays(n)))

    # concurrent: the same nodes as a pure fan-out through the Session
    conc = virtual_scheduler(symmetric=True)
    g_conc = JobGraph()
    for sct, sh in zip(scts, shares):
        pin(conc, sct, n, sh)
        g_conc.add(sct)
    with Session(conc) as sess:
        t_conc = graph_makespan(sess.submit(g_conc, **make_arrays(n)))

    return {"nodes": k, "serialized_makespan_s": t_serial,
            "concurrent_makespan_s": t_conc,
            "throughput_gain_x": t_serial / t_conc if t_conc > 0 else 0.0}


def bench_virtual_overlap(n: int) -> dict:
    """Three cpu-heavy nodes: short gpu legs drain while long cpu legs
    run, so all three nodes are in flight at one instant."""
    scts = [node_kernel(i) for i in range(3)]
    sched = virtual_scheduler(symmetric=False)
    g = JobGraph()
    for sct in scts:
        pin(sched, sct, n, 0.1)
        g.add(sct)
    with Session(sched) as sess:
        handle = sess.submit(g, **make_arrays(n))
    spans = list(handle.spans().values())
    max_conc = max(sum(1 for (s, e) in spans if s <= t < e)
                   for (t, _) in spans)
    return {"nodes": 3, "spans_us": sorted(spans),
            "max_concurrent_nodes": max_conc}


# ---------------------------------------------------------------------------
# Threaded phase (bit-identity gated; wall throughput reported)
# ---------------------------------------------------------------------------

def bench_threaded(n: int, k: int, reps: int, telemetry,
                   device: str) -> dict:
    scts = [node_kernel(i) for i in range(k)]
    arrays = make_arrays(n)

    # blocking FCFS baseline: one sched.run per node, in order
    seq = make_scheduler(ThreadedExecutor(policy=POLICY, device=device))
    expected = {}
    for sct in scts:
        r = seq.run(sct, dict(arrays))
        expected.update({kk: host(v) for kk, v in r.outputs.items()})
    seq.close()

    # concurrent graph execution — bit-identity gate
    par = make_scheduler(ThreadedExecutor(policy=POLICY, device=device),
                         telemetry=telemetry)
    g = JobGraph()
    for sct in scts:
        g.add(sct)
    res = par.submit(g, arrays).result(timeout=120)
    bit_identical = all(
        torch.equal(expected[kk], host(res.outputs[kk]))
        for kk in expected)
    par.close()

    # fault-injected per-node retry — bit-identity under recovery
    inj = FaultInjector(crash_on_call={"gpu0": [1]})
    flt = make_scheduler(
        ThreadedExecutor(injector=inj, policy=FaultPolicy(
            max_attempts=1, watchdog_multiple=1e6), device=device),
        telemetry=telemetry)
    g2 = JobGraph()
    for sct in scts:
        g2.add(sct)
    res2 = flt.submit(g2, arrays, retries=2,
                      retry_backoff=0.01).result(timeout=120)
    bit_identical_faulted = all(
        torch.equal(expected[kk], host(res2.outputs[kk]))
        for kk in expected)
    node_retries = int(flt.counters()["scheduler.failed_runs"])
    flt.close()

    # distinct-node fan-out wall ratio (reported only, see module doc)
    def timed_distinct(max_inflight: int) -> float:
        sched = make_scheduler(ThreadedExecutor(policy=POLICY, device=device),
                               max_inflight=max(2, max_inflight))
        with Session(sched, max_inflight=max_inflight) as sess:
            def round_():
                handles = []
                for sct in scts:
                    gr = JobGraph()
                    gr.add(sct)
                    handles.append(sess.submit(gr, **arrays))
                sess.gather(*handles, timeout=120)
            round_()                    # warm pools, caches, KB
            t0 = time.perf_counter()
            round_()
            return time.perf_counter() - t0

    d_serial = statistics.median(timed_distinct(1) for _ in range(reps))
    d_conc = statistics.median(timed_distinct(k) for _ in range(reps))

    # gated wall throughput: K identical small requests — serialized
    # FCFS vs. concurrent admission coalesced by cross-request fusion
    # into a single decide + dispatch + merge
    n_small, k_ident = WALL_N, WALL_K
    sct_i = node_kernel(0)
    small = make_arrays(n_small)

    def timed_identical(max_inflight: int, fusion_window: float) -> float:
        sched = make_scheduler(ThreadedExecutor(policy=POLICY, device=device),
                               max_inflight=max(2, max_inflight),
                               fusion_window=fusion_window,
                               fusion_max=k_ident)
        with Session(sched, max_inflight=max_inflight) as sess:
            def round_():
                handles = [sess.submit(JobGraph.from_chain([sct_i]), **small)
                           for _ in range(k_ident)]
                sess.gather(*handles, timeout=120)
            round_()                    # warm pools, plan caches, KB
            t0 = time.perf_counter()
            round_()
            return time.perf_counter() - t0

    wall_reps = max(reps, 5)    # cheap rounds; medians need the depth
    serialized = statistics.median(
        timed_identical(1, 0.0) for _ in range(wall_reps))
    concurrent = statistics.median(
        timed_identical(k_ident, 0.5) for _ in range(wall_reps))

    return {"nodes": k, "bit_identical": bit_identical,
            "bit_identical_faulted": bit_identical_faulted,
            "node_retries": node_retries,
            "distinct_serialized_wall_s": d_serial,
            "distinct_concurrent_wall_s": d_conc,
            "wall_distinct_gain_x": d_serial / d_conc if d_conc > 0 else 0.0,
            "wall_n": n_small, "wall_requests": k_ident,
            "serialized_wall_s": serialized,
            "concurrent_wall_s": concurrent,
            "wall_throughput_gain_x": (serialized / concurrent
                                       if concurrent > 0 else 0.0)}


# ---------------------------------------------------------------------------
# Graph plan cache + fusion phases (gated)
# ---------------------------------------------------------------------------

WALL_N = 1 << 16        # fusion's target regime: many small requests
WALL_K = 8


def bench_graph_plan_cache(n: int, k: int, telemetry,
                           device: str) -> dict:
    """Identical graph submitted twice: the second submission must be
    pre-planned end to end — a whole-graph cache hit, every node action
    ``preplanned``, zero decide/plan lock acquisitions."""
    scts = [node_kernel(i) for i in range(k)]
    arrays = make_arrays(n)
    sched = make_scheduler(ThreadedExecutor(policy=POLICY, device=device),
                           telemetry=telemetry)

    def submit_once():
        g = JobGraph()
        for sct in scts:
            g.add(sct)
        return sched.submit(g, arrays).result(timeout=120)

    r1 = submit_once()
    c0 = sched.counters()
    r2 = submit_once()
    c1 = sched.counters()
    sched.close()
    return {
        "nodes": k,
        "graph_hits": int(c1["plan_cache.graph_hits"]),
        "graph_misses": int(c1["plan_cache.graph_misses"]),
        "decide_locks_second": int(c1["scheduler.decide_locks"]
                                   - c0["scheduler.decide_locks"]),
        "plan_locks_second": int(c1["scheduler.plan_locks"]
                                 - c0["scheduler.plan_locks"]),
        "preplanned_nodes": sum(1 for r in r2.runs.values()
                                if r.action == "preplanned"),
        "bit_identical": all(
            torch.equal(host(r1.outputs[kk]), host(r2.outputs[kk]))
            for kk in r1.outputs),
    }


def bench_fused(telemetry, device: str) -> dict:
    """K identical requests (distinct array *values*) coalesced by the
    fusion window: slices must be bit-identical to independent runs —
    clean, and under an injected fault recovered by in-run
    repartition."""
    n, k = WALL_N, WALL_K
    sct = node_kernel(0)
    batches = [{"x": np.arange(n, dtype=np.float32) + i,
                "y": np.full(n, float(i + 1), dtype=np.float32)}
               for i in range(k)]

    # independent baseline: one ordinary run per request
    base = make_scheduler(ThreadedExecutor(policy=POLICY, device=device))
    expected = [host(base.run(sct, dict(b)).outputs["o0"]) for b in batches]
    base.close()

    def fused_outputs(injector=None):
        sched = make_scheduler(
            ThreadedExecutor(policy=POLICY, injector=injector,
                             device=device),
            telemetry=telemetry, max_inflight=2,
            fusion_window=0.5, fusion_max=k)
        with Session(sched, max_inflight=k) as sess:
            handles = [sess.submit(JobGraph.from_chain([sct]), **b)
                       for b in batches]
            results = sess.gather(*handles, timeout=120)
        got = [host(r.outputs["o0"]) for r in results]
        retries = int(sched.counters()["scheduler.retries"])
        actions = [r.runs[list(r.runs)[0]].action for r in results]
        sched.close()
        return got, retries, actions

    got, _, actions = fused_outputs()
    clean = all(torch.equal(e, g) for e, g in zip(expected, got))

    inj = FaultInjector(crash_on_call={"gpu0": [1]})
    got_f, retries_f, _ = fused_outputs(injector=inj)
    faulted = all(torch.equal(e, g) for e, g in zip(expected, got_f))

    return {"requests": k, "n": n,
            "fused_actions": sum(1 for a in actions if a == "fused"),
            "bit_identical": clean,
            "bit_identical_faulted": faulted,
            "fused_run_retries": retries_f}


# ---------------------------------------------------------------------------

def bench(smoke: bool, n: int, device: str = "cuda") -> dict:
    telemetry = Telemetry()
    result = {
        "bench": "pipeline", "smoke": smoke, "n": n, "device": device,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "virtual_throughput": bench_virtual_throughput(4096, k=6),
        "virtual_overlap": bench_virtual_overlap(4096),
        "threaded": bench_threaded(n, k=4, reps=3 if smoke else 7,
                                   telemetry=telemetry, device=device),
        "graph_plan_cache": bench_graph_plan_cache(n, k=4,
                                                   telemetry=telemetry,
                                                   device=device),
        "fusion": bench_fused(telemetry=telemetry, device=device),
    }
    return embed_metrics(result, telemetry)


def deterministic_failures(result) -> List[str]:
    """Every gate that does not depend on a clock."""
    failures = []
    gain = result["virtual_throughput"]["throughput_gain_x"]
    if gain <= 1.5:
        failures.append(
            f"virtual concurrent throughput gain {gain:.2f}x <= 1.5x")
    conc = result["virtual_overlap"]["max_concurrent_nodes"]
    if conc < 3:
        failures.append(
            f"only {conc} nodes simultaneously in flight (need >= 3)")
    if not result["threaded"]["bit_identical"]:
        failures.append("graph outputs differ from blocking FCFS runs")
    if not result["threaded"]["bit_identical_faulted"]:
        failures.append("fault-injected graph outputs differ from FCFS")
    if result["threaded"]["node_retries"] < 1:
        failures.append("fault injection did not exercise per-node retry")

    # whole-graph plan cache: second identical submission is a hit and
    # runs without a single decide/plan lock acquisition
    gpc = result["graph_plan_cache"]
    if gpc["graph_hits"] < 1:
        failures.append("second identical submission missed the "
                        "graph plan cache")
    if gpc["decide_locks_second"] != 0 or gpc["plan_locks_second"] != 0:
        failures.append(
            f"pre-planned submission acquired locks (decide="
            f"{gpc['decide_locks_second']}, plan="
            f"{gpc['plan_locks_second']}; need 0/0)")
    if gpc["preplanned_nodes"] != gpc["nodes"]:
        failures.append(
            f"only {gpc['preplanned_nodes']}/{gpc['nodes']} nodes ran "
            "pre-planned on the cached submission")
    if not gpc["bit_identical"]:
        failures.append("pre-planned outputs differ from first run")

    # cross-request fusion: coalesced slices bit-identical to
    # independent runs, with and without an injected fault
    fus = result["fusion"]
    if fus["fused_actions"] != fus["requests"]:
        failures.append(
            f"only {fus['fused_actions']}/{fus['requests']} requests "
            "were served from the fused run")
    if not fus["bit_identical"]:
        failures.append("fused request slices differ from independent runs")
    if not fus["bit_identical_faulted"]:
        failures.append("fault-injected fused slices differ from "
                        "independent runs")
    if fus["fused_run_retries"] < 1:
        failures.append("fault injection did not exercise the fused "
                        "run's repartition retry")
    return failures


def wall_failures(result) -> List[str]:
    """The wall-clock gate: fusion must make concurrent admission of
    identical requests beat serialized FCFS (generous smoke floor for
    shared hosts)."""
    smoke = bool(result.get("smoke"))
    floor = 0.4 if smoke else 1.0
    wall = result["threaded"]["wall_throughput_gain_x"]
    if wall <= floor:
        return [f"wall throughput gain {wall:.2f}x <= {floor}x "
                f"({'smoke floor' if smoke else 'full gate'})"]
    return []


def check(result) -> int:
    failures = deterministic_failures(result) + wall_failures(result)
    for f in failures:
        print(f"CHECK FAILED: {f}")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small workload / few reps")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero if acceptance gates regress")
    ap.add_argument("--out", default="build/BENCH_pipeline_torch.json")
    ap.add_argument("--n", type=int, default=None,
                    help="vector length (default: 1<<18 smoke, 1<<20 full)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the accelerator slots run")
    args = ap.parse_args(argv)
    if args.n is None:
        args.n = (1 << 18) if args.smoke else (1 << 20)

    result = bench(args.smoke, args.n, args.device)
    write(result, args.out)
    print(json.dumps(result, indent=2))
    print(f"wrote {args.out}")
    if args.check:
        raise SystemExit(check(result))


if __name__ == "__main__":
    main()
