"""The paper's five benchmarks, its 2013 testbeds, and their inputs on this
host.

Two sets of SCTs, because Algorithm 1 searches work-group sizes per
kernel (``autotuner._wgs_product``), so an SCT's structure steers the
search:

* the **reference-shaped** SCTs (:data:`BENCHMARKS`: the JAX package's
  ``benchmarks/paper_suite.py`` node for node, with its names, ``epu``s
  and ``flops/bytes_per_item``; torch bodies) drive the ``sim`` testbed,
  which times only their specs: a 3-kernel filter ``Pipeline``, an
  N-body over ``(n, 4)`` bodies;
* the **main path's** SCTs (:data:`repro_torch.suite.BENCHMARKS`: one
  fused filter kernel, N-body over ``pos``/``vel``/``all_pos``/``mass``,
  every body a hand-written kernel on the card, the FFT's cuFFT) drive
  the ``host`` testbed, on :func:`host_inputs`.

Testbeds (the simulator's calibration, paper Sec. 4):

* OPTERON, Sec. 4.1: 4x 16-core AMD Opteron 6272 (CPU-only), 16 KiB L1 /
  2 MiB L2 per 2 cores / 6 MiB L3 per 8 cores.
* HYBRID, Sec. 4.2: i7-3930K (6C12T) + 1-2x AMD HD 7950 on PCIe x16.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import suite
from repro_torch.core import (Loop, LoopState, Map, Pipeline, SCT, kernel,
                              scalar, vector)
from repro_torch.core.simulator import CostModel, SimDevice
from repro_torch.core.spec import Workload
from repro_torch.kernels import ref


# ---------------------------------------------------------------------------
# the reference-shaped SCTs (the sim testbed times only their specs)
# ---------------------------------------------------------------------------

def filter_pipeline_sct(width: int = 1024) -> SCT:
    """Gaussian Noise -> Solarize -> Mirror; epu = image line, nu = 2."""

    def noise(img):
        h = (torch.arange(img.shape[0])[:, None] * 31
             + torch.arange(img.shape[1])[None, :] * 17) % 13
        return torch.clamp(img + (h.to(img.dtype) - 6.0), 0, 255)

    k1 = kernel(noise, name="gauss_noise",
                inputs=[vector("img", epu=1)],
                outputs=[vector("noisy", epu=1)],  # 2 px/thread is intra-line
                flops_per_item=6 * width, bytes_per_item=8 * width)
    k2 = kernel(solarize, name="solarize",
                inputs=[vector("noisy", epu=1)],
                outputs=[vector("sol", epu=1)],
                flops_per_item=2 * width, bytes_per_item=8 * width)
    k3 = kernel(lambda x: x.flip(1), name="mirror",
                inputs=[vector("sol", epu=1)],
                outputs=[vector("out", epu=1)],
                flops_per_item=1 * width, bytes_per_item=8 * width)
    return Pipeline(k1, k2, k3)


def solarize(x):
    return torch.where(x > 128.0, 255.0 - x, x)


FFT_ELEMS = suite.FFT_ELEMS        # one 512 KiB FFT (f64 complex pairs)


def fft_sct() -> SCT:
    """FFT -> iFFT pipeline; epu = one whole FFT (paper: 512 KiB)."""
    lg = math.log2(FFT_ELEMS)
    k1 = kernel(lambda x: torch.fft.fft(x, dim=1).real.to(x.dtype),
                name="fft", inputs=[vector("sig", epu=1)],
                outputs=[vector("freq", epu=1)],
                flops_per_item=5 * FFT_ELEMS * lg,
                bytes_per_item=16 * FFT_ELEMS)
    k2 = kernel(lambda x: torch.fft.ifft(x, dim=1).real.to(x.dtype),
                name="ifft", inputs=[vector("freq", epu=1)],
                outputs=[vector("sig_out", epu=1)],
                flops_per_item=5 * FFT_ELEMS * lg,
                bytes_per_item=16 * FFT_ELEMS)
    return Pipeline(k1, k2)


def nbody_sct(n_bodies: int, iterations: int = 1) -> SCT:
    """Direct-sum N-Body; COPY dataset, partitioned at body level."""

    def step(mine, all_pos):
        d = all_pos[None, :, :3] - mine[:, None, :3]
        r2 = (d * d).sum(-1) + 1e-3
        acc = (d / (r2 ** 1.5)[..., None]).sum(1)
        out = mine.clone()
        out[:, :3] += 0.001 * acc
        return out

    body = kernel(step, name="nbody_step",
                  inputs=[vector("bodies", epu=1),
                          vector("all_bodies", copy=True)],
                  outputs=[vector("bodies", epu=1)],
                  flops_per_item=20.0 * n_bodies,
                  bytes_per_item=16.0)
    return Loop(body, LoopState(max_iterations=iterations,
                                global_sync=True))


def saxpy_sct() -> SCT:
    k = kernel(lambda a, x, y: a * x + y, name="saxpy",
               inputs=[scalar("a"), vector("x", epu=1),
                       vector("y", epu=1)],
               outputs=[vector("z", epu=1)],
               flops_per_item=2.0, bytes_per_item=12.0)
    return Map(k)


def segmentation_sct(plane: int = 1024 * 1024) -> SCT:
    """3-D gray volume -> 3 classes; epu = one (D1 x D2) plane."""
    k = kernel(lambda v: torch.where(v < 85, 0.0,
                                     torch.where(v > 170, 255.0, 128.0)),
               name="segmentation",
               inputs=[vector("vol", epu=1)],
               outputs=[vector("seg", epu=1)],
               flops_per_item=2.0 * plane, bytes_per_item=8.0 * plane)
    return Map(k)


#: name -> (sct builder(size), workload sizes, workload label) — the
#: paper's parameterisation classes (Table 2 / Table 3)
BENCHMARKS: Dict[str, Tuple] = {
    "filter_pipeline": (lambda n: filter_pipeline_sct(n),
                        [1024, 2048, 4096, 8192], "image size (px)"),
    "fft": (lambda n: fft_sct(),
            [256, 512, 1024], "#FFTs (512KiB each)"),
    "nbody": (lambda n: nbody_sct(n),
              [8192, 16384, 32768], "bodies"),
    "saxpy": (lambda n: saxpy_sct(),
              [10 ** 6, 10 ** 7, 5 * 10 ** 7], "elements"),
    "segmentation": (lambda n: segmentation_sct(),
                     [64, 512, 3840], "planes (1Mpx)"),
}


# ---------------------------------------------------------------------------
# calibrated testbeds (paper hardware)
# ---------------------------------------------------------------------------

def opteron_testbed() -> List[SimDevice]:
    """Sec. 4.1: 4x Opteron 6272, 64 cores total, ~2.2 GHz."""
    return [SimDevice("cpu", "cpu", flops=280e9, mem_bw=51e9,
                      pcie_bw=math.inf, cores=64)]


def hybrid_testbed(n_gpus: int = 1) -> List[SimDevice]:
    """Sec. 4.2: i7-3930K + n x AMD HD 7950 (PCIe x16)."""
    devs = [SimDevice(f"gpu{i}", "gpu", flops=2870e9, mem_bw=240e9,
                      pcie_bw=8e9, cores=28) for i in range(n_gpus)]
    devs.append(SimDevice("cpu", "cpu", flops=150e9, mem_bw=43e9,
                          pcie_bw=math.inf, cores=6))
    return devs


def workload_for(name: str, size: int) -> Workload:
    if name == "filter_pipeline":
        return Workload((size, size))
    if name == "fft":
        return Workload((size, FFT_ELEMS), itemsize=8)
    if name == "nbody":
        return Workload((size, 4))
    if name == "segmentation":
        return Workload((size, 1024, 1024))
    return Workload((size,))


def cost_model_for(name: str, size: int) -> CostModel:
    """Per-domain-unit analytic costs (drives the simulator)."""
    if name == "filter_pipeline":
        per_line = size
        return CostModel(flops_per_unit=9.0 * per_line,
                         bytes_per_unit=24.0 * per_line)
    if name == "fft":
        lg = math.log2(FFT_ELEMS)
        return CostModel(flops_per_unit=10 * FFT_ELEMS * lg,
                         bytes_per_unit=32.0 * FFT_ELEMS)
    if name == "nbody":
        return CostModel(flops_per_unit=20.0 * size, bytes_per_unit=32.0,
                         iterations=1.0)
    if name == "segmentation":
        return CostModel(flops_per_unit=2.0 * (1 << 20),
                         bytes_per_unit=8.0 * (1 << 20))
    return CostModel(flops_per_unit=2.0, bytes_per_unit=12.0)


# ---------------------------------------------------------------------------
# the host testbed: the main path's SCTs on real inputs
# ---------------------------------------------------------------------------

#: the filter's seed scalar (the kernel's hash), as the main path uses
FILTER_SEED = 7
#: FFT -> iFFT against numpy's float64 FFT over CHECK_ROWS rows:
#: max |err| <= FFT_TOL x max |ref|
FFT_TOL = 1e-5
CHECK_ROWS = 64
#: N-body: max |acc err| <= NBODY_TOL x max |acc| against float64
NBODY_TOL = 3e-4
#: what each check holds, as the main path's checks hold it
TOLERANCES = {"saxpy": "rtol 1e-5, atol 1e-5", "segmentation": "exact",
              "filter_pipeline": "rtol 1e-5, atol 1e-4",
              "fft": f"max |err| <= {FFT_TOL} x max |ref| (float64)",
              "nbody": f"max |err| <= {NBODY_TOL} x max |acc| (float64)"}
#: segmentation planes made at a time (256 MiB)
PLANE_CHUNK = 64


def host_sct(name: str, size: int) -> SCT:
    """The main path's SCT of ``name`` at ``size`` (repro_torch.suite)."""
    return suite.BENCHMARKS[name][0](size)


def _pinned(t: torch.Tensor, pin: bool) -> torch.Tensor:
    if not pin:
        return t.cpu()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def host_inputs(name: str, size: int, device: str = "cuda",
                seed: int = 0) -> Dict[str, Any]:
    """The arguments of :func:`host_sct` ``(name, size)``, drawn from
    ``seed`` on ``device`` (the card draws them fast) and kept on the
    host, pinned when ``device`` is a card, as the main path takes them:
    saxpy ``a, x, y`` (size,); the filter's ``img`` (size, size) in
    [0, 255) and its ``seed`` scalar; segmentation's ``vol`` (size, 1024,
    1024) in [0, 255); N-body's ``pos`` (size, 3), zero ``vel``,
    ``all_pos`` (the same tensor as ``pos``) and ``mass`` (size,) in
    [0.1, 1.1); the FFT's ``sig`` (size, 65536) float32."""
    dev = torch.device(device)
    pin = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    if name == "saxpy":
        return {"a": 2.5,
                "x": _pinned(torch.randn(size, generator=g, device=dev), pin),
                "y": _pinned(torch.randn(size, generator=g, device=dev), pin)}
    if name == "segmentation":
        vol = torch.empty((size, 1024, 1024), pin_memory=pin)
        for p in range(0, size, PLANE_CHUNK):
            n = min(PLANE_CHUNK, size - p)
            vol[p:p + n].copy_(torch.rand((n, 1024, 1024), generator=g,
                                          device=dev) * 255)
        return {"vol": vol}
    if name == "filter_pipeline":
        img = torch.rand((size, size), generator=g, device=dev) * 255
        return {"img": _pinned(img, pin), "seed": FILTER_SEED}
    if name == "nbody":
        pos = _pinned(torch.randn((size, 3), generator=g, device=dev), pin)
        mass = torch.rand(size, generator=g, device=dev) + 0.1
        return {"pos": pos, "vel": _pinned(torch.zeros((size, 3)), pin),
                "all_pos": pos, "mass": _pinned(mass, pin)}
    if name == "fft":
        sig = torch.randn((size, FFT_ELEMS), generator=g, device=dev)
        return {"sig": _pinned(sig, pin)}
    raise KeyError(name)


def check_outputs(name: str, arrays: Dict[str, Any], outputs: Dict[str, Any],
                  part, device: str = "cuda") -> float:
    """Hold one run's merged ``outputs`` against the plain versions on
    ``device`` (``part``: the run's partitioning; the filter's row ids
    are local to each slot's slice).  Raises ``AssertionError`` on a
    difference beyond :data:`TOLERANCES`; returns the largest absolute
    error."""
    dev = torch.device(device)
    if name == "saxpy":
        got = outputs["z"].to(dev)
        want = ref.saxpy_ref(arrays["a"], arrays["x"].to(dev),
                             arrays["y"].to(dev))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        return (got - want).abs().max().item()
    if name == "segmentation":
        for p in range(0, arrays["vol"].shape[0], PLANE_CHUNK):
            v = arrays["vol"][p:p + PLANE_CHUNK].to(dev)
            got = outputs["seg"][p:p + PLANE_CHUNK].to(dev)
            if not torch.equal(got, ref.segmentation_ref(v)):
                raise AssertionError(f"segmentation planes {p}.. differ "
                                     "from the plain version")
        return 0.0
    if name == "filter_pipeline":
        worst = 0.0
        for off, size in zip(part.offsets("img"), part.sizes("img")):
            if not size:
                continue
            im = arrays["img"][off:off + size].to(dev)
            got = outputs["out"][off:off + size].to(dev)
            want = ref.filter_pipeline_ref(im, arrays["seed"])
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            worst = max(worst, (got - want).abs().max().item())
        return worst
    if name == "fft":
        sig, out = arrays["sig"], outputs["sig_out"]
        if out.shape != sig.shape or out.dtype != torch.float32 \
                or not bool(torch.isfinite(out).all()):
            raise AssertionError("fft: outputs are not finite float32 of "
                                 "the input's shape")
        rows = np.sort(np.random.default_rng(0).choice(
            sig.shape[0], min(CHECK_ROWS, sig.shape[0]), replace=False))
        x = sig[rows].numpy().astype(np.float64)
        want = np.fft.ifft(np.fft.fft(x, axis=1).real, axis=1).real
        err = float(np.abs(out[rows].numpy() - want).max())
        if err > FFT_TOL * np.abs(want).max():
            raise AssertionError(f"fft -> ifft: max err {err} > {FFT_TOL} "
                                 f"x max |ref| {np.abs(want).max()}")
        return err
    pos, vel = arrays["pos"].to(dev), arrays["vel"].to(dev)
    acc64 = ref.nbody_ref(pos.double(), arrays["mass"].to(dev).double(),
                          block=256)
    vel_out, pos_out = outputs["vel"].to(dev), outputs["pos"].to(dev)
    err = ((vel_out.double() - vel.double()) / suite.NBODY_DT
           - acc64).abs().max().item()
    if err > NBODY_TOL * acc64.abs().max().item():
        raise AssertionError(f"nbody step: acceleration error {err} > "
                             f"{NBODY_TOL} x max |acc|")
    torch.testing.assert_close(pos_out, pos + vel_out * suite.NBODY_DT,
                               rtol=1e-6, atol=1e-6)
    return err
