"""Public entry points of the hand-written kernels, by device.

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
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import moe_gemm as _gmm
from repro_torch.kernels import nbody as _nbody
from repro_torch.kernels import saxpy as _saxpy
from repro_torch.kernels import segmentation as _seg
from repro_torch.kernels import ssd_scan as _ssd


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    **kw) -> torch.Tensor:
    """(B,H,Sq,hd) x (B,KV,Sk,hd) attention (GQA/causal/window/softcap/
    ``kv_len``), output in q's dtype."""
    if q.is_cuda:
        return _flash.flash_attention(q, k, v, **kw)
    return ref.attention_ref(q, k, v, **kw)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         **kw) -> torch.Tensor:
    """Model-layout adapter: (B,S,H,hd)/(B,S,KV,hd) in and out.  The kernel
    reads the model's layout through its strides; the plain version works
    on transposed views."""
    if q.is_cuda:
        return _flash.flash_attention_bshd(q, k, v, **kw)
    o = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), **kw)
    return o.transpose(1, 2)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, *, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba2 SSD -> (y in x's dtype, final state float32)."""
    if x.is_cuda:
        return _ssd.ssd_scan(x, dt, B, C, A, chunk=chunk, h0=h0)
    return ref.ssd_scan_ref(x, dt, B, C, A, chunk=chunk, h0=h0)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E,C,d) x (E,d,f) -> (E,C,f), one product per expert, summed in
    float32, in x's dtype."""
    if x.is_cuda:
        return _gmm.grouped_matmul(x, w)
    return ref.grouped_matmul_ref(x, w)


#: launch counters of the kernels, by kernel name
COUNTERS = {c.name: c for c in (_saxpy.launches, _filter.launches,
                                _seg.launches, _nbody.launches,
                                _flash.launches, _ssd.launches,
                                _gmm.launches)}
