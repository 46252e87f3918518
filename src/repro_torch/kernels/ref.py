"""Plain PyTorch versions of the paper's benchmark kernels.

Each computes the same function as its hand-written CUDA kernel with
ordinary tensor operations, on any device.  The CPU tests hold them
against the JAX package's kernels, ``chip_smoke.py`` holds each kernel
against them on the card, and the host fission slots compute their share
of every hybrid run with them (``ops`` dispatches by device).
"""
from __future__ import annotations

from typing import Optional

import torch

_M32 = 1 << 32
_H32 = 1 << 31


def saxpy_ref(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    return a * x + y


def _wrap32(h):
    """Reduce an int64 tensor (or a Python int) to the value int32
    arithmetic would hold."""
    if isinstance(h, int):
        return (h + _H32) % _M32 - _H32
    return torch.remainder(h + _H32, _M32) - _H32


def filter_pipeline_ref(img: torch.Tensor, seed: int = 0, *,
                        noise_scale: float = 8.0,
                        solarize_threshold: float = 128.0) -> torch.Tensor:
    """The kernel's hash noise, exactly: int32 products and sums are taken
    in int64 and wrapped after every step, so torch's own overflow
    behaviour is never relied on; ``>>`` on a wrapped value is int32's
    arithmetic shift."""
    H, W = img.shape
    row = torch.arange(H, dtype=torch.int64, device=img.device)[:, None]
    col = torch.arange(W, dtype=torch.int64, device=img.device)[None, :]
    base = _wrap32(_wrap32(row * -1640531535) + _wrap32(col * 40503)
                   + _wrap32(int(seed) * 69069))

    def hash01(salt: int) -> torch.Tensor:
        h = _wrap32(base + _wrap32(salt * 1013904223))
        h = h ^ (h >> 13)
        h = _wrap32(h * 1274126177)
        h = h ^ (h >> 16)
        return (h & 0xFFFF).to(torch.float32) / 65535.0

    noise = (hash01(1) + hash01(2) - 1.0) * noise_scale
    v = torch.clamp(img + noise, 0.0, 255.0)
    v = torch.where(v > solarize_threshold, 255.0 - v, v)
    return v.flip(1).to(img.dtype)


def segmentation_ref(vol: torch.Tensor, *, lo: float = 85.0,
                     hi: float = 170.0) -> torch.Tensor:
    black = torch.zeros((), dtype=vol.dtype, device=vol.device)
    white = torch.full((), 255.0, dtype=vol.dtype, device=vol.device)
    gray = torch.full((), 128.0, dtype=vol.dtype, device=vol.device)
    return torch.where(vol < lo, black, torch.where(vol > hi, white, gray))


def nbody_ref(pos: torch.Tensor, mass: torch.Tensor,
              softening: float = 1e-3, *,
              targets: Optional[torch.Tensor] = None,
              block: int = 64) -> torch.Tensor:
    """Accelerations on ``targets`` (default: every body of ``pos``) from
    the bodies ``pos``/``mass``.  Target rows are taken ``block`` at a
    time, so the ``(n_i, N, 3)`` difference tensor is never whole."""
    tgt = pos if targets is None else targets
    acc = torch.empty_like(tgt)
    for s in range(0, tgt.shape[0], block):
        d = pos[None, :, :] - tgt[s:s + block, None, :]     # (b, N, 3)
        r2 = (d * d).sum(-1) + softening
        inv_r3 = torch.rsqrt(r2) / r2
        acc[s:s + block] = torch.einsum("ij,ijk->ik",
                                        mass[None, :] * inv_r3, d)
    return acc
