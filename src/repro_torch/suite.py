"""The paper's benchmark SCTs (Sec. 4) over the port's kernels.

Each body calls :mod:`repro_torch.kernels.ops`, so an accelerator slot
launches the hand-written CUDA kernel and a host fission slot runs the
plain version.  The elementary partitioning units are the paper's (one
element, one image line, one body, one 1024x1024 plane), as are
``flops/bytes_per_item``; ``BENCHMARKS`` carries the paper's size
classes (Table 2 / Table 3).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core import SCT, Loop, LoopState, Map, kernel, scalar, vector
from repro_torch.kernels import ops

NBODY_DT = 0.01


def saxpy_sct() -> SCT:
    k = kernel(ops.saxpy, name="saxpy",
               inputs=[scalar("a"), vector("x", epu=1), vector("y", epu=1)],
               outputs=[vector("z", epu=1)],
               flops_per_item=2.0, bytes_per_item=12.0)
    return Map(k)


def segmentation_sct(plane: int = 1024 * 1024) -> SCT:
    """3-D gray volume (planes, 1024, 1024) -> 3 classes; epu = one plane."""
    k = kernel(ops.segmentation, name="segmentation",
               inputs=[vector("vol", epu=1)],
               outputs=[vector("seg", epu=1)],
               flops_per_item=2.0 * plane, bytes_per_item=8.0 * plane)
    return Map(k)


def filter_pipeline_sct(width: int = 1024, *, src: str = "img",
                        dst: str = "out") -> SCT:
    """Noise -> Solarize -> Mirror as one fused kernel node; epu = one
    image line.  ``src``/``dst`` name the edges, so two filters chain."""
    k = kernel(ops.filter_pipeline, name="filter_pipeline",
               inputs=[vector(src, epu=1), scalar("seed")],
               outputs=[vector(dst, epu=1)],
               flops_per_item=9.0 * width, bytes_per_item=8.0 * width)
    return Map(k)


def _nbody_body(pos, vel, all_pos, mass):
    return ops.nbody_step(pos, vel, mass, NBODY_DT, all_pos=all_pos)


def nbody_sct(n_bodies: int, iterations: int = 1) -> SCT:
    """Direct-sum N-Body leapfrog steps: the slot's bodies (``pos``,
    ``vel``; epu = one body) move under the gravity of every body
    (``all_pos``, ``mass``: COPY datasets)."""
    body = kernel(_nbody_body, name="nbody_step",
                  inputs=[vector("pos", epu=1), vector("vel", epu=1),
                          vector("all_pos", copy=True),
                          vector("mass", copy=True)],
                  outputs=[vector("pos", epu=1), vector("vel", epu=1)],
                  flops_per_item=20.0 * n_bodies, bytes_per_item=16.0)
    return Loop(body, LoopState(max_iterations=iterations, global_sync=True))


#: name -> (SCT builder(size), the paper's size classes, size label)
BENCHMARKS: Dict[str, Tuple] = {
    "filter_pipeline": (lambda n: filter_pipeline_sct(n),
                        [1024, 2048, 4096, 8192], "image size (px)"),
    "nbody": (lambda n: nbody_sct(n), [8192, 16384, 32768], "bodies"),
    "saxpy": (lambda n: saxpy_sct(),
              [10 ** 6, 10 ** 7, 5 * 10 ** 7], "elements"),
    "segmentation": (lambda n: segmentation_sct(),
                     [64, 512, 3840], "planes (1Mpx)"),
}
