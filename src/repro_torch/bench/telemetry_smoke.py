"""Telemetry smoke: fault-injected chain → validated Chrome trace.

The gate of the observability subsystem.  Runs a 2-SCT ``run_chain``
with an injected gpu0 crash under a telemetry-enabled :class:`Session`,
then checks:

  * ``Session.export_trace`` writes a well-formed Chrome trace
    (``validate_chrome_trace``: required keys, matched B/E pairs);
  * the trace contains the plan, per-slot compute, retry (attempt > 0)
    and merge spans the span model promises;
  * ``Session.metrics()`` retry / plan-cache counters match the
    ``ExecutionStats`` the same runs returned;
  * a fault event and a repartition event were logged;
  * the disabled-telemetry path stays cheap (a wall-clock microbench
    bound, loose enough for shared hosts).

Accelerator slots run on CUDA streams of ``cuda:0`` (``--device cuda``,
the default) or on host threads (``--device cpu``).  On a card each
accelerator slot span carries its work's CUDA-event milliseconds
(``device_ms``); :func:`slot_spans` pairs the spans up so a caller can
hold each span's length against them.

Drop the exported trace on https://ui.perfetto.dev or
``chrome://tracing`` to inspect a run.

Run:  PYTHONPATH=src python -m repro_torch.bench.telemetry_smoke [--out build/trace_torch.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import numpy as np

from repro_torch.bench.report import embed_metrics, write
from repro_torch.core import (AcceleratorPlatform, DeviceInfo, FaultInjector,
                              FaultPolicy, HostPlatform, KnowledgeBase,
                              LoadBalancer, NULL_TELEMETRY, Scheduler,
                              Session, Telemetry, ThreadedExecutor, kernel,
                              scalar, vector, validate_chrome_trace)

POLICY = FaultPolicy(watchdog_multiple=1e6)

# required by the span model; "attempt" spans with attempt >= 1 are the
# retry spans
REQUIRED_SPANS = {"run", "plan", "dispatch", "attempt", "slot", "merge"}
#: the no-op span's cost bound, seconds (wall clock)
NOOP_SPAN_BOUND = 20e-6


def chain_kernels():
    k1 = kernel(lambda a, x, y: a * x + y, name="saxpy",
                inputs=[scalar("a"), vector("x"), vector("y")],
                outputs=[vector("z")])
    k2 = kernel(lambda a, z: z * a, name="scale",
                inputs=[scalar("a"), vector("z")], outputs=[vector("w")])
    return [k1, k2]


def make_session(telemetry: Telemetry, device: str) -> Session:
    host = HostPlatform(DeviceInfo("cpu0", "cpu", compute_units=4),
                        topology={"L2": 2, "NO_FISSION": 1})
    accel = AcceleratorPlatform([DeviceInfo("gpu0", "gpu")], max_overlap=2)
    inj = FaultInjector(crash_on_call={"gpu0": [1]})
    ex = ThreadedExecutor(policy=POLICY, injector=inj, device=device)
    sched = Scheduler(host=host, accel=accel, executor=ex,
                      kb=KnowledgeBase(), balancer=LoadBalancer(max_dev=0.0))
    return Session(sched, telemetry=telemetry)


def noop_span_cost(iters: int = 50_000) -> float:
    """Seconds per disabled-telemetry span (shared no-op singleton)."""
    tracer = NULL_TELEMETRY.tracer
    t0 = time.perf_counter()
    for _ in range(iters):
        with tracer.span("x", device="gpu0"):
            pass
    return (time.perf_counter() - t0) / iters


def slot_spans(trace) -> List[Dict]:
    """Every closed "slot" span of a Chrome trace: its device, its length
    in microseconds (E.ts - B.ts) and the args of both events merged (the
    late notes, such as ``device_ms`` and ``fault``, come on the E)."""
    stacks: Dict[tuple, List[Dict]] = {}
    spans = []
    for e in trace["traceEvents"]:
        key = (e.get("pid"), e.get("tid"))
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e)
        elif e["ph"] == "E":
            b = stacks[key].pop()
            if b["name"] == "slot":
                args = {**b.get("args", {}), **e.get("args", {})}
                spans.append({"device": args.get("device"),
                              "us": e["ts"] - b["ts"], "args": args})
    return spans


def smoke(out: str, device: str = "cuda") -> dict:
    failures = []
    telemetry = Telemetry()
    n = 1 << 14
    arrays = {"a": np.float32(2.0),
              "x": np.arange(n, dtype=np.float32),
              "y": np.ones(n, dtype=np.float32)}

    with make_session(telemetry, device) as session:
        runs = session.run_chain(chain_kernels(), **arrays).get()
        trace = session.export_trace(out)
        metrics = session.metrics()
        counters = session.counters()

    # -- trace well-formedness + span model ----------------------------------
    errors = validate_chrome_trace(trace)
    if errors:
        failures.append(f"trace validation: {errors[:5]}")
    names = {e["name"] for e in trace["traceEvents"]}
    missing = REQUIRED_SPANS - names
    if missing:
        failures.append(f"missing spans: {sorted(missing)}")
    retry_spans = [e for e in trace["traceEvents"]
                   if e["name"] == "attempt"
                   and e.get("args", {}).get("attempt", 0) >= 1]
    if not retry_spans:
        failures.append("no retry (attempt >= 1) span in the trace")

    # -- metrics vs ExecutionStats -------------------------------------------
    stats_retries = sum(r.stats.retries for r in runs)
    if stats_retries < 1:
        failures.append("fault injection did not exercise the retry path")
    if metrics.get("retries_total", 0) != stats_retries:
        failures.append(
            f"retries_total={metrics.get('retries_total')} != "
            f"sum(stats.retries)={stats_retries}")
    hits = metrics.get("plan_cache_hits_total", 0)
    misses = metrics.get("plan_cache_misses_total", 0)
    hit_ratio = hits / (hits + misses) if hits + misses else 0.0
    if abs(hit_ratio - counters["plan_cache.hit_rate"]) > 1e-9:
        failures.append(
            f"metrics hit ratio {hit_ratio} != plan-cache counter "
            f"{counters['plan_cache.hit_rate']}")

    # -- event stream --------------------------------------------------------
    kinds = {e.kind for e in telemetry.events.records()}
    for needed in ("fault", "retry.repartition"):
        if needed not in kinds:
            failures.append(f"missing event kind {needed!r}")

    # -- disabled-telemetry cost (wall clock) --------------------------------
    cost = noop_span_cost()
    wall = []
    if cost > NOOP_SPAN_BOUND:  # loose bound; tests enforce a tighter one
        wall.append(f"no-op span cost {cost * 1e6:.2f}µs > "
                    f"{NOOP_SPAN_BOUND * 1e6:.0f}µs")

    result = {
        "bench": "telemetry_smoke",
        "device": device,
        "trace_events": len(trace["traceEvents"]),
        "span_names": sorted(names),
        "retry_spans": len(retry_spans),
        "event_kinds": sorted(kinds),
        "stats_retries": stats_retries,
        "noop_span_cost_us": cost * 1e6,
        "deterministic_failures": failures,
        "wall_failures": wall,
        "failures": failures + wall,
    }
    return embed_metrics(result, telemetry)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="build/trace_torch.json",
                    help="Chrome trace output path")
    ap.add_argument("--json", default="build/BENCH_telemetry_torch.json",
                    help="smoke-result JSON output path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the accelerator slots run")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    result = smoke(args.out, args.device)
    write(result, args.json)
    print(json.dumps({k: v for k, v in result.items() if k != "metrics"},
                     indent=2))
    print(f"wrote {args.out} and {args.json}")
    for f in result["failures"]:
        print(f"SMOKE FAILED: {f}")
    raise SystemExit(1 if result["failures"] else 0)


if __name__ == "__main__":
    main()
