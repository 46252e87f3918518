"""Learning-rate schedules: cosine and WSD (minicpm, arXiv:2404.06395).

Each is a ``step -> lr`` function returning a 0-dimensional float32
tensor, computed in float32 as the JAX package's jnp schedules are, so the
two agree to float32 rounding.
"""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    def f(step):
        return _f32(lr)
    return f


def linear_warmup(lr: float, warmup: int):
    def f(step):
        s = _f32(step)
        return lr * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
    return f


def cosine_schedule(lr: float, warmup: int, total: int,
                    final_ratio: float = 0.1):
    """Linear warmup then cosine decay to final_ratio * lr."""
    def f(step):
        s = _f32(step)
        warm = lr * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_ratio + (1 - final_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup, warm, lr * cos)
    return f


def wsd_schedule(lr: float, warmup: int, stable: int, decay: int,
                 final_ratio: float = 0.01):
    """Warmup–Stable–Decay (minicpm): flat plateau, then a short
    exponential-style decay to ``final_ratio * lr`` over ``decay`` steps."""
    def f(step):
        s = _f32(step)
        warm = lr * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
        in_decay = torch.clamp((s - warmup - stable) / max(decay, 1),
                               0.0, 1.0)
        dec = lr * torch.pow(_f32(final_ratio), in_decay)
        return torch.where(s < warmup, warm,
                           torch.where(s < warmup + stable, _f32(lr), dec))
    return f
