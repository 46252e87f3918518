"""Locality benchmark: plan cache + persistent pools + zero-copy merge.

Measures the non-compute dispatch overhead (plan + pool + dispatch +
merge) of recurrent runs and of a 3-kernel compound chain, comparing:

  * **baseline** — the historical dispatch path: plan cache off,
    per-attempt thread pools, ``torch.cat`` merge
    (``Scheduler(plan_cache=False)`` +
    ``ThreadedExecutor(persistent_pool=False, inplace_merge=False)``);
  * **optimized** — the locality pipeline: plan/partitioning cache,
    persistent worker pool, in-place merge into reusable (pinned, on a
    card) buffers, and ``run_chain`` partitioned residency between
    chained kernels (device-resident on the accelerator slots).

Accelerator slots run on CUDA streams of ``cuda:0`` (``--device cuda``,
the default) or on host threads (``--device cpu``).  Inputs are numpy
arrays; outputs are compared as host tensors.  Emits
``build/BENCH_locality_torch.json``.  ``--check`` gates the
deterministic acceptance counters (:func:`deterministic_failures`):

  * ``resident_merge_bytes == 0`` — zero bytes copied at merge on the
    resident-chain path;
  * ``plan_cache_hit_rate >= 0.8`` over the recurrent phase;
  * bit-identical outputs vs. the baseline merge implementation, with
    and without an injected fault (repartition path), and the fault
    exercised the retry path.

The overhead reductions are wall-clock ratios: reported, never gated.

Run:  PYTHONPATH=src python -m repro_torch.bench.locality [--smoke] [--check] [--device cpu]
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
                              FaultPolicy, HostPlatform, KnowledgeBase,
                              LoadBalancer, Origin, PlatformConfig, Profile,
                              Scheduler, Telemetry, ThreadedExecutor,
                              infer_workload, kernel, scalar, vector)

# a huge watchdog multiple disables spurious timeout trips on busy hosts
POLICY = FaultPolicy(watchdog_multiple=1e6)


def chain_kernels():
    k1 = kernel(lambda a, x, y: a * x + y, name="saxpy",
                inputs=[scalar("a"), vector("x"), vector("y")],
                outputs=[vector("z")])
    k2 = kernel(lambda a, z: z * a, name="scale",
                inputs=[scalar("a"), vector("z")], outputs=[vector("w")])
    k3 = kernel(lambda w, y: w + y, name="addy",
                inputs=[vector("w"), vector("y")], outputs=[vector("v")])
    return [k1, k2, k3]


def make_arrays(n: int):
    return {"a": np.float32(2.0),
            "x": np.arange(n, dtype=np.float32),
            "y": np.ones(n, dtype=np.float32)}


def make_scheduler(n: int, device: str, *, optimized: bool, injector=None,
                   telemetry=None) -> Scheduler:
    host_p = HostPlatform(DeviceInfo("cpu0", "cpu", compute_units=4),
                          topology={"L2": 2, "NO_FISSION": 1})
    accel = AcceleratorPlatform([DeviceInfo("gpu0", "gpu")], max_overlap=2)
    ex = ThreadedExecutor(policy=POLICY, injector=injector,
                          persistent_pool=optimized,
                          inplace_merge=optimized,
                          reuse_buffers=optimized, device=device)
    sched = Scheduler(host=host_p, accel=accel, executor=ex,
                      kb=KnowledgeBase(),
                      balancer=LoadBalancer(max_dev=0.0),
                      plan_cache=optimized, telemetry=telemetry)
    # pre-store fission profiles so both legs run the same slot layout
    # and no watchdog deadline applies (best_time stays infinite)
    for sct in chain_kernels():
        wl = infer_workload(sct, make_arrays(n),
                            shapes={"z": (n,), "w": (n,)})
        sched.kb.store(Profile(
            sct_id=sct.unique_id(), workload=wl, share_a=0.5,
            config=PlatformConfig(fission_level="L2"),
            best_time=float("inf"), origin=Origin.DERIVED))
    return sched


def run_sequential(sched: Scheduler, arrays, copy_out: bool):
    """Chain the kernels through full merges (the baseline data path)."""
    env = dict(arrays)
    overheads = []
    for sct in chain_kernels():
        r = sched.run(sct, env)
        env.update({k: (host(v) if copy_out else v)
                    for k, v in r.outputs.items()})
        overheads.append(r.stats.overhead_seconds)
    return env["v"], sum(overheads)


def bench(smoke: bool, n: int, device: str = "cuda") -> dict:
    reps = 5 if smoke else 9
    warmup = 2
    arrays = make_arrays(n)
    scheds: List[Scheduler] = []

    def new(**kw) -> Scheduler:
        scheds.append(make_scheduler(n, device, **kw))
        return scheds[-1]

    # -- recurrent single-SCT phase -----------------------------------------
    telemetry = Telemetry()      # shared by every optimized-leg scheduler
    base = new(optimized=False)
    opt = new(optimized=True, telemetry=telemetry)
    sct = chain_kernels()[0]
    base_over, opt_over = [], []
    for sched, sink in ((base, base_over), (opt, opt_over)):
        for _ in range(warmup):
            sched.run(sct, dict(arrays))
        for _ in range(reps):
            r = sched.run(sct, dict(arrays))
            sink.append(r.stats.overhead_seconds)
    hit_rate = opt.plan_cache.hit_rate

    # -- compound-chain phase ------------------------------------------------
    base_c = new(optimized=False)
    opt_c = new(optimized=True, telemetry=telemetry)
    expected, _ = run_sequential(base_c, arrays, copy_out=True)
    base_chain, opt_chain = [], []
    resident_bytes = []
    for _ in range(warmup):
        opt_c.run_chain(chain_kernels(), dict(arrays))
    for _ in range(reps):
        _, o = run_sequential(base_c, arrays, copy_out=True)
        base_chain.append(o)
        runs = opt_c.run_chain(chain_kernels(), dict(arrays))
        opt_chain.append(sum(r.stats.overhead_seconds for r in runs))
        resident_bytes.extend(r.stats.merge_bytes for r in runs
                              if r.stats.resident)
    got = host(runs[-1].outputs["v"])
    bit_identical = bool(torch.equal(expected, got))

    # -- fault-injected chain (repartition fallback) -------------------------
    inj = FaultInjector(crash_on_call={"gpu0": [1]})
    faulted = new(optimized=True, injector=inj, telemetry=telemetry)
    fruns = faulted.run_chain(chain_kernels(), dict(arrays))
    bit_identical_faulted = bool(torch.equal(
        expected, host(fruns[-1].outputs["v"])))
    faulted_retries = sum(r.stats.retries for r in fruns)
    for sched in scheds:
        sched.close()

    med = statistics.median
    result = {
        "bench": "locality", "smoke": smoke, "n": n, "reps": reps,
        "device": device,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "recurrent": {
            "baseline_overhead_s": med(base_over),
            "optimized_overhead_s": med(opt_over),
            "overhead_reduction_x": (med(base_over) / med(opt_over)
                                     if med(opt_over) > 0 else float("inf")),
            "plan_cache": opt.plan_cache.counters(),
            "pools_created": opt.executor.pools_created,
            "pool_reuses": opt.executor.pool_reuses,
        },
        "chain": {
            "baseline_overhead_s": med(base_chain),
            "optimized_overhead_s": med(opt_chain),
            "overhead_reduction_x": (med(base_chain) / med(opt_chain)
                                     if med(opt_chain) > 0 else float("inf")),
            "resident_merge_bytes": int(max(resident_bytes))
            if resident_bytes else -1,
            "resident_steps_per_chain": sum(
                1 for r in runs if r.stats.resident),
        },
        "plan_cache_hit_rate": hit_rate,
        "bit_identical": bit_identical,
        "bit_identical_faulted": bit_identical_faulted,
        "faulted_retries": faulted_retries,
    }
    return embed_metrics(result, telemetry)


def deterministic_failures(result) -> List[str]:
    """Every gate that does not depend on a clock."""
    failures = []
    if result["chain"]["resident_merge_bytes"] != 0:
        failures.append("resident-chain path copied bytes at merge: "
                        f"{result['chain']['resident_merge_bytes']}")
    if result["plan_cache_hit_rate"] < 0.8:
        failures.append("plan-cache hit rate regressed: "
                        f"{result['plan_cache_hit_rate']:.2f} < 0.8")
    if not result["bit_identical"]:
        failures.append("optimized outputs differ from baseline merge")
    if not result["bit_identical_faulted"]:
        failures.append("fault-injected outputs differ from baseline merge")
    if result["faulted_retries"] < 1:
        failures.append("fault injection did not exercise the retry path")
    return failures


def wall_failures(result) -> List[str]:
    """Wall-clock gates: locality has none (its ratios are reported)."""
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
                    help="exit non-zero if acceptance counters regress")
    ap.add_argument("--out", default="build/BENCH_locality_torch.json")
    ap.add_argument("--n", type=int, default=None,
                    help="vector length (default: 1<<19 smoke, 1<<20 full)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the accelerator slots run")
    args = ap.parse_args(argv)
    if args.n is None:
        args.n = (1 << 19) if args.smoke else (1 << 20)

    result = bench(args.smoke, args.n, args.device)
    write(result, args.out)
    print(json.dumps(result, indent=2))
    print(f"wrote {args.out}")
    if args.check:
        raise SystemExit(check(result))


if __name__ == "__main__":
    main()
