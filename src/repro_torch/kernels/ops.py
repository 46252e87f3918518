"""Public entry points of the paper's benchmark kernels, by device.

A CUDA tensor goes to the hand-written kernel, whose wrapper checks its
inputs and raises on anything it does not take.  Any other tensor (the
host fission slots' CPU tensors, the ``meta`` tensors of a shape probe)
goes to the plain PyTorch version in :mod:`repro_torch.kernels.ref`.
The choice is the tensor's device and nothing else: no error ever sends
a CUDA tensor to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import filter_pipeline as _filter
from repro_torch.kernels import nbody as _nbody
from repro_torch.kernels import saxpy as _saxpy
from repro_torch.kernels import segmentation as _seg


def saxpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return _saxpy.saxpy(a, x, y)
    return ref.saxpy_ref(a, x, y)


def filter_pipeline(img: torch.Tensor, seed: int = 0, **kw) -> torch.Tensor:
    if img.is_cuda:
        return _filter.filter_pipeline(img, seed, **kw)
    return ref.filter_pipeline_ref(img, seed, **kw)


def segmentation(vol: torch.Tensor, **kw) -> torch.Tensor:
    if vol.is_cuda:
        return _seg.segmentation(vol, **kw)
    return ref.segmentation_ref(vol, **kw)


def nbody_accelerations(pos: torch.Tensor, mass: torch.Tensor, *,
                        targets: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Accelerations on ``targets`` (default: every body) from ``pos``/``mass``."""
    tgt = pos if targets is None else targets
    if tgt.is_cuda:
        return _nbody.nbody_accelerations(tgt, pos, mass)
    return ref.nbody_ref(pos, mass, targets=tgt)


def nbody_step(pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor,
               dt: float = 0.01, *, all_pos: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leapfrog step (the paper's Loop body) of the bodies ``pos``/``vel``
    under the gravity of ``all_pos``/``mass`` (default: ``pos`` itself)."""
    src = pos if all_pos is None else all_pos
    acc = nbody_accelerations(src, mass, targets=pos)
    vel = vel + acc * dt
    return pos + vel * dt, vel


#: launch counters of the kernels, by kernel name
COUNTERS = {c.name: c for c in (_saxpy.launches, _filter.launches,
                                _seg.launches, _nbody.launches)}
