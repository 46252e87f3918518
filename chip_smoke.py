#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels (``src/repro_torch/csrc/*.cu``, with
``nvcc`` for ``sm_90a``, into ``build/kernels/``), holds each kernel
against its plain PyTorch version on the card, then drives the port's main
path — ``Session`` -> ``Scheduler`` -> ``ThreadedExecutor``, host fission
slots plus two CUDA-stream slots on ``cuda:0`` — over the paper's four
benchmark SCTs at the paper's sizes, and checks every output.

Standard output ends with three lines: the card's name and power limit as
``nvidia-smi`` prints them, one JSON object describing each kernel
(``{"kernels": [...]}``), and the result line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before the result line; so does a machine without a CUDA device.  A fuller
record is written to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import suite  # noqa: E402
from repro_torch.core import (AcceleratorPlatform, DeviceInfo,  # noqa: E402
                              ExecutionSlot, HostPlatform, JobGraph,
                              KnowledgeBase, LoadBalancer, PlatformConfig,
                              Profile, Scheduler, Session, ThreadedExecutor,
                              Workload, build_plan)
from repro_torch.kernels import _build, ops, ref  # noqa: E402

#: published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

#: the paper's sizes (benchmarks/paper_suite.py BENCHMARKS); segmentation
#: is cut from its largest class (3840 planes, ~15 GiB in and out on the
#: host) to 512 planes for the run's time
SIZE = {"saxpy": 5 * 10 ** 7, "filter_pipeline": 8192, "nbody": 32768,
        "segmentation": 512}
ORDER = ["saxpy", "segmentation", "filter_pipeline", "nbody"]
REQUESTS = 3
SHARE_A = 0.8           # accelerator share of the KB profile carried in
OVERLAP = 2             # CUDA streams on cuda:0
FISSION = "L2"          # host fission level of that profile
NBODY_TOL = 3e-4        # max |err| / max |acc| against float64

KERNELS = {
    "saxpy": ("src/repro_torch/csrc/saxpy.cu",
              "src/repro/kernels/saxpy.py:17"),
    "segmentation": ("src/repro_torch/csrc/segmentation.cu",
                     "src/repro/kernels/segmentation.py:23"),
    "filter_pipeline": ("src/repro_torch/csrc/filter_pipeline.cu",
                        "src/repro/kernels/filter_pipeline.py:46"),
    "nbody": ("src/repro_torch/csrc/nbody.cu",
              "src/repro/kernels/nbody.py:44"),
}


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the card, from CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, fp32_ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = fp32_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# inputs: the paper's sizes, made on the card from a seed, kept pinned
# ---------------------------------------------------------------------------

def pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def make_inputs(seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    n = SIZE["saxpy"]
    saxpy = {"a": 2.5, "x": pinned(torch.randn(n, generator=g, device=dev)),
             "y": pinned(torch.randn(n, generator=g, device=dev))}
    planes = SIZE["segmentation"]
    vol = torch.empty((planes, 1024, 1024), pin_memory=True)
    for p in range(0, planes, 64):     # 256 MiB at a time
        vol[p:p + 64].copy_(torch.rand((min(64, planes - p), 1024, 1024),
                                       generator=g, device=dev) * 255)
    side = SIZE["filter_pipeline"]
    img = pinned(torch.rand((side, side), generator=g, device=dev) * 255)
    nb = SIZE["nbody"]
    pos = pinned(torch.randn((nb, 3), generator=g, device=dev))
    nbody = {"pos": pos, "vel": pinned(torch.zeros((nb, 3), device=dev)),
             "all_pos": pos,
             "mass": pinned(torch.rand(nb, generator=g, device=dev) + 0.1)}
    return {"saxpy": saxpy, "segmentation": {"vol": vol},
            "filter_pipeline": {"img": img, "seed": 7}, "nbody": nbody}


def sct_for(name: str):
    build, _, _ = suite.BENCHMARKS[name]
    return build(SIZE[name])


# ---------------------------------------------------------------------------
# the runtime: hybrid host + CUDA-stream slots, a KB carried in
# ---------------------------------------------------------------------------

def make_scheduler(balancer=None) -> Scheduler:
    """Host fission slots from this machine's cores; OVERLAP streams on
    cuda:0; a KB holding one profile per SCT at the paper's smallest size
    class, which the first request at full size derives its
    configuration from."""
    kb = KnowledgeBase()
    for name in ORDER:
        sct = sct_for(name)
        _, classes, _ = suite.BENCHMARKS[name]
        dims = {"saxpy": (classes[0],), "segmentation": (classes[0], 1024,
                                                         1024),
                "filter_pipeline": (classes[0], classes[0]),
                "nbody": (classes[0], 3)}[name]
        kb.store(Profile(sct_id=sct.unique_id(), workload=Workload(dims),
                         share_a=SHARE_A,
                         config=PlatformConfig(fission_level=FISSION,
                                               overlap=OVERLAP),
                         best_time=1.0))
    props = torch.cuda.get_device_properties(0)
    host = HostPlatform(DeviceInfo("cpu0", "cpu",
                                   compute_units=os.cpu_count() or 1))
    accel = AcceleratorPlatform(
        [DeviceInfo("gpu0", "gpu", compute_units=props.multi_processor_count)],
        max_overlap=OVERLAP)
    return Scheduler(host=host, accel=accel, executor=ThreadedExecutor(),
                     kb=kb, balancer=balancer)


def first_partitioning(sched: Scheduler, name: str, arrays):
    """The partitioning the first request will run under (the KB profile's
    slots and shares), for the kernel phase's main-path shapes."""
    host_slots = sched.host.topology[FISSION]
    slots = [ExecutionSlot(f"gpu0/q{i}", "gpu") for i in range(OVERLAP)] + \
        [ExecutionSlot(f"cpu0/f{i}", "cpu") for i in range(host_slots)]
    shares = [SHARE_A / OVERLAP] * OVERLAP + \
        [(1 - SHARE_A) / host_slots] * host_slots
    shapes = {k: tuple(v.shape) for k, v in arrays.items()
              if isinstance(v, torch.Tensor)}
    return build_plan(sct_for(name), shapes).partition(slots, shares)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def kernel_phase(inputs, gpu_units):
    dev = torch.device("cuda")
    results = {}

    # saxpy: one accelerator slot's slice; ragged N; a misaligned view
    a = inputs["saxpy"]["a"]
    u = gpu_units["saxpy"]
    x = inputs["saxpy"]["x"][:u].to(dev)
    y = inputs["saxpy"]["y"][:u].to(dev)
    err = (ops.saxpy(a, x, y) - ref.saxpy_ref(a, x, y)).abs().max().item()
    k = min(u - 3, 4_000_001)
    for xs, ys in [(x[:1_000_003], y[:1_000_003]), (x[1:1 + k], y[3:3 + k])]:
        torch.testing.assert_close(ops.saxpy(a, xs, ys),
                                   ref.saxpy_ref(a, xs, ys),
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ops.saxpy(a, x, y), ref.saxpy_ref(a, x, y),
                               rtol=1e-5, atol=1e-5)
    results["saxpy"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: ops.saxpy(a, x, y), 20),
        plain_ms=cuda_ms(lambda: ref.saxpy_ref(a, x, y), 20),
        library_ms=cuda_ms(lambda: torch.add(y, x, alpha=a), 20),
        shape=list(x.shape), tolerance="rtol 1e-5, atol 1e-5",
        bound=bound_ms(12.0 * u, 2.0 * u))

    # segmentation: exact; NaN -> 128; ragged and misaligned flat views
    u = gpu_units["segmentation"]
    vol = inputs["segmentation"]["vol"][:u].to(dev)
    vol.view(-1)[::1_000_003] = float("nan")
    got, want = ops.segmentation(vol), ref.segmentation_ref(vol)
    expect(torch.equal(got, want), "segmentation kernel == plain, exactly")
    flat = vol.view(-1)
    for v in (flat[:1_000_003], flat[1:1_000_002], vol[:3]):
        expect(torch.equal(ops.segmentation(v), ref.segmentation_ref(v)),
               f"segmentation exact on {tuple(v.shape)} "
               f"offset {v.storage_offset()}")
    n = vol.numel()
    results["segmentation"] = dict(
        max_abs_err=(got - want).abs().max().item(),
        ms=cuda_ms(lambda: ops.segmentation(vol), 10),
        plain_ms=cuda_ms(lambda: ref.segmentation_ref(vol), 10),
        library_ms=None, shape=list(vol.shape), tolerance="exact",
        bound=bound_ms(8.0 * n, 2.0 * n))

    # filter pipeline: one slot's rows; odd widths; a row-offset view
    u = gpu_units["filter_pipeline"]
    img = inputs["filter_pipeline"]["img"][:u].to(dev)
    seed = inputs["filter_pipeline"]["seed"]
    got, want = ops.filter_pipeline(img, seed), ref.filter_pipeline_ref(img,
                                                                        seed)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    for im in (img[:1001, :777].contiguous(), img[5:700],
               img[:64, :8191].contiguous()):
        torch.testing.assert_close(ops.filter_pipeline(im, seed),
                                   ref.filter_pipeline_ref(im, seed),
                                   rtol=1e-5, atol=1e-4)
    hw = img.numel()
    results["filter_pipeline"] = dict(
        max_abs_err=(got - want).abs().max().item(),
        ms=cuda_ms(lambda: ops.filter_pipeline(img, seed), 10),
        plain_ms=cuda_ms(lambda: ref.filter_pipeline_ref(img, seed), 3),
        library_ms=None, shape=list(img.shape),
        tolerance="rtol 1e-5, atol 1e-4",
        bound=bound_ms(8.0 * hw, 10.0 * hw))

    # nbody: one slot's targets against every body, vs float64; ragged N
    u = gpu_units["nbody"]
    pos = inputs["nbody"]["pos"].to(dev)
    mass = inputs["nbody"]["mass"].to(dev)
    tgt = pos[:u]
    got = ops.nbody_accelerations(pos, mass, targets=tgt)
    want = ref.nbody_ref(pos.double(), mass.double(), targets=tgt.double())
    err = (got.double() - want).abs().max().item()
    scale = want.abs().max().item()
    expect(err <= NBODY_TOL * scale,
           f"nbody max err {err} <= {NBODY_TOL} x max |acc| {scale}")
    for n_i, n_j in [(1000, 1001), (129, 32767)]:
        p, m = pos[:n_j], mass[:n_j]
        g2 = ops.nbody_accelerations(p, m, targets=p[:n_i])
        w2 = ref.nbody_ref(p.double(), m.double(), targets=p[:n_i].double())
        expect((g2.double() - w2).abs().max().item()
               <= NBODY_TOL * w2.abs().max().item(),
               f"nbody ragged {n_i}x{n_j}")
    n_i, n_j = tgt.shape[0], pos.shape[0]
    results["nbody"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: ops.nbody_accelerations(pos, mass, targets=tgt), 5),
        plain_ms=cuda_ms(lambda: ref.nbody_ref(pos, mass, targets=tgt), 2),
        library_ms=None, shape=[n_i, n_j], max_abs_acc=scale,
        tolerance=f"max |err| <= {NBODY_TOL} x max |acc| (float64 plain)",
        bound=bound_ms(24.0 * n_i + 16.0 * n_j, 20.0 * n_i * n_j))
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def check_outputs(name: str, arrays, run) -> float:
    """Hold one request's merged outputs against the plain versions on the
    card; returns the largest absolute error."""
    dev = torch.device("cuda")
    out = run.outputs
    if name == "saxpy":
        got = out["z"].to(dev)
        want = ref.saxpy_ref(arrays["a"], arrays["x"].to(dev),
                             arrays["y"].to(dev))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return (got - want).abs().max().item()
    if name == "segmentation":
        worst = 0.0
        for p in range(0, arrays["vol"].shape[0], 64):
            v = arrays["vol"][p:p + 64].to(dev)
            got = out["seg"][p:p + 64].to(dev)
            expect(torch.equal(got, ref.segmentation_ref(v)),
                   f"segmentation planes {p}.. exact")
        return worst
    if name == "filter_pipeline":
        # row ids are local to each slot's slice: apply the plain version
        # per segment of the run's own partitioning
        part = run.node_plan.part
        worst = 0.0
        for off, size in zip(part.offsets("img"), part.sizes("img")):
            if not size:
                continue
            im = arrays["img"][off:off + size].to(dev)
            got = out["out"][off:off + size].to(dev)
            want = ref.filter_pipeline_ref(im, arrays["seed"])
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            worst = max(worst, (got - want).abs().max().item())
        return worst
    pos = arrays["pos"].to(dev)
    vel = arrays["vel"].to(dev)
    acc64 = ref.nbody_ref(pos.double(), arrays["mass"].to(dev).double(),
                          block=256)
    dt = suite.NBODY_DT
    vel_out, pos_out = out["vel"].to(dev), out["pos"].to(dev)
    acc_out = (vel_out.double() - vel.double()) / dt
    err = (acc_out - acc64).abs().max().item()
    expect(err <= NBODY_TOL * acc64.abs().max().item(),
           f"nbody step: acceleration error {err}")
    torch.testing.assert_close(pos_out, pos + vel_out * dt,
                               rtol=1e-6, atol=1e-6)
    return err


def gpu_segments(run) -> int:
    part = run.node_plan.part
    return sum(1 for s, u in zip(part.slots, part.units)
               if s.device_type != "cpu" and u > 0)


def units_by_class(run):
    part = run.node_plan.part
    gpu = sum(u for s, u in zip(part.slots, part.units)
              if s.device_type != "cpu")
    return {"gpu": gpu, "cpu": sum(part.units) - gpu,
            "slots": [s.device for s in part.slots]}


def main_path(sched: Scheduler, inputs):
    need = {k: 0 for k in ops.COUNTERS}
    requests = []
    for c in ops.COUNTERS.values():
        c.reset()
    with Session(sched) as session:
        for name in ORDER:
            arrays = inputs[name]
            for r in range(REQUESTS):
                t0 = time.perf_counter()
                run = session.run(sct_for(name), **arrays).get()
                seconds = time.perf_counter() - t0
                err = check_outputs(name, arrays, run)
                kernel = "nbody" if name == "nbody" else name
                need[kernel] += gpu_segments(run)
                requests.append(dict(
                    sct=name, request=r, action=run.action,
                    share_a=run.profile.share_a, seconds=seconds,
                    merge_bytes=run.stats.merge_bytes,
                    units=units_by_class(run), max_abs_err=err,
                    slot_seconds=run.stats.times))
                print(f"main {name} #{r}: {run.action} share_a="
                      f"{run.profile.share_a:.3f} {seconds:.3f}s "
                      f"units={units_by_class(run)['gpu']}gpu/"
                      f"{units_by_class(run)['cpu']}cpu "
                      f"merge_bytes={run.stats.merge_bytes}", flush=True)
    chain = chain_phase(inputs["filter_pipeline"], need)
    launches = {k: c.value for k, c in ops.COUNTERS.items()}
    for k, n in need.items():
        expect(launches[k] >= n and n > 0,
               f"{k}: {launches[k]} launches >= {n} accelerator segments")
    return requests, chain, launches


def chain_phase(arrays, need):
    """filter -> filter as one JobGraph: resident on the accelerator slots
    between the steps, bit-identical to the same graph merged between.

    The filter's row ids are local to each slot's slice, so the two graphs
    must run under one partitioning: each runs on a fresh scheduler whose
    load balancer never adjusts the KB profile's distribution."""
    side = SIZE["filter_pipeline"]
    outs = {}
    info = {}
    for residency in (None, False):
        session = Session(make_scheduler(LoadBalancer(trigger=math.inf)))
        g = JobGraph()
        first = g.add(suite.filter_pipeline_sct(side, dst="mid"),
                      residency=residency)
        g.add(suite.filter_pipeline_sct(side, src="mid", dst="out2"),
              after=first)
        t0 = time.perf_counter()
        h = session.submit(g, **arrays)
        res = h.result(timeout=600)
        seconds = time.perf_counter() - t0
        outs[residency] = res.outputs["out2"].clone()
        runs = [h.runs[n] for n in g.names()]
        for run in runs:
            need["filter_pipeline"] += gpu_segments(run)
        head = runs[0]
        info["resident" if residency is None else "merged"] = dict(
            seconds=seconds, handoff=head.stats.resident,
            merge_bytes=[r.stats.merge_bytes for r in runs])
        if residency is None:
            expect(head.stats.resident, "chain handoff stayed resident")
            handle = head.resident_handle
            on_card = [env["mid"].device.type
                       for env, slot in zip(handle.envs, handle.part.slots)
                       if slot.device_type != "cpu" and "mid" in env]
            expect(on_card and all(d == "cuda" for d in on_card),
                   f"resident accelerator-slot values on the card: {on_card}")
        session.shutdown()
        print(f"chain residency={residency}: {seconds:.3f}s "
              f"handoff={head.stats.resident}", flush=True)
    expect(torch.equal(outs[None], outs[False]),
           "resident chain bit-identical to the merged chain")
    return info


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = gpu_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_log.splitlines()
            if "registers" in ln]
    print(f"built the kernels in {build_s:.1f}s; ptxas: {regs}", flush=True)

    sched = make_scheduler()
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // sched.host.topology[FISSION]))
    inputs = make_inputs()
    gpu_units = {}
    for name in ORDER:
        part = first_partitioning(sched, name, inputs[name])
        gpu_units[name] = part.units[0]
    results = kernel_phase(inputs, gpu_units)
    for name, r in results.items():
        print(f"kernel {name} {r['shape']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), max err "
              f"{r['max_abs_err']:.3g}", flush=True)

    requests, chain, launches = main_path(sched, inputs)

    kernels = []
    for name in ["saxpy", "filter_pipeline", "segmentation", "nbody"]:
        r = results[name]
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    record = {"card": card, "build_seconds": build_s, "ptxas": regs,
              "kernel_phase": results, "requests": requests,
              "chain": chain, "launches": launches, "kernels": kernels}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
