"""Plain PyTorch versions of the hand-written kernels: the paper's
benchmark kernels, the LM kernels (flash attention, SSD scan, the MoE
grouped GEMM) and the train step's (AdamW, the microbatch accumulation).

Each computes the same function as its hand-written CUDA kernel with
ordinary tensor operations, on any device.  The CPU tests hold them
against the JAX package's kernels, ``chip_smoke.py`` holds each kernel
against them on the card, and the host fission slots compute their share
of every hybrid run with them (``ops`` dispatches by device).
"""
from __future__ import annotations

from typing import Optional, Tuple

import math

import torch

from repro_torch.kernels.grad_accum import check_args as check_accum_args

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


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

#: the score of a masked key, as in the JAX package (not -inf: a row with
#: every key masked averages V instead of giving NaN)
NEG_INF = -2.0 ** 30


def attention_probs(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None, logit_cap: float = 0.0,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B,H,Sq,hd); k: (B,KV,Sk,hd) -> the float32 softmax (B,H,Sq,Sk)
    over the masked (NEG_INF) scores.  Query i sits at position
    ``q_offset + i`` for the causal mask and the window."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.repeat_interleave(H // KV, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf.float()) * sc
    if logit_cap and logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    qp = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = kp < (Sk if kv_len is None else kv_len)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    return torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  logit_cap: float = 0.0, scale: Optional[float] = None,
                  kv_len: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (B,H,Sq,hd); k/v: (B,KV,Sk,hd) -> (B,H,Sq,hd) in q's dtype.
    Dense float32 softmax over all Sk keys (queries at ``q_offset`` on).
    Its gradient under autograd is the plain version of the flash backward
    kernel."""
    p = attention_probs(q, k, causal=causal, window=window, q_offset=q_offset,
                        logit_cap=logit_cap, scale=scale, kv_len=kv_len)
    vf = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf.float())
    return o.to(q.dtype)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, A: torch.Tensor, *, chunk: int,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The token-by-token recurrence the chunked kernel computes:
    ``h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t)``, ``y_t = C_t h_t``.

    x (Bsz,S,nh*hd), dt (Bsz,S,nh), B/C (Bsz,S,ds), A (nh,), h0
    (Bsz,nh,ds,hd) -> (y in x's dtype, final state float32).  S must be a
    multiple of ``chunk``, as for the kernel; the recurrence itself does
    not depend on it."""
    Bsz, S, dih = x.shape
    nh = dt.shape[-1]
    hd = dih // nh
    ds = B.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} not a multiple of chunk={chunk}")
    xf = x.float().reshape(Bsz, S, nh, hd)
    dtf = dt.float()
    Bf = B.float()
    Cf = C.float()
    h = (torch.zeros((Bsz, nh, ds, hd), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    a = torch.exp(dtf * A.float()[None, None, :])            # (Bsz,S,nh)
    xdt = xf * dtf[..., None]                                # (Bsz,S,nh,hd)
    ys = torch.empty((Bsz, S, nh, hd), dtype=torch.float32, device=x.device)
    for t in range(S):
        upd = Bf[:, t, None, :, None] * xdt[:, t, :, None, :]
        h = h * a[:, t, :, None, None] + upd
        ys[:, t] = (Cf[:, t, None, :, None] * h).sum(2)
    return ys.reshape(Bsz, S, dih).to(x.dtype), h


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------

def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E,C,d) x w (E,d,f) -> (E,C,f): one product per expert, summed in
    float32, in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def grouped_matmul_dx_ref(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The gradient of ``grouped_matmul_ref`` for x: dy (E,C,f) and w
    (E,d,f) -> dx[e] = dy[e] w[e]^T (E,C,d), summed in float32, in dy's
    dtype."""
    return torch.einsum("ecf,edf->ecd", dy.float(), w.float()).to(dy.dtype)


def grouped_matmul_dw_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gradient of ``grouped_matmul_ref`` for w: x (E,C,d) and dy
    (E,C,f) -> dw[e] = x[e]^T dy[e] (E,d,f), summed in float32, in x's
    dtype."""
    return torch.einsum("ecd,ecf->edf", x.float(), dy.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# AdamW: gradient norm and update (the eager loop the kernels replace)
# ---------------------------------------------------------------------------

def grad_sumsq_ref(grads) -> torch.Tensor:
    """(n,) float32: each gradient's sum of squares, taken in float32."""
    return torch.stack([torch.sum(torch.square(g.float())) for g in grads])


def sum_in_order_ref(x: torch.Tensor) -> torch.Tensor:
    """0-d: x[0] + x[1] + ... in x's dtype, one addition at a time in
    order (as Python's ``sum`` over the per-tensor sums adds them)."""
    return sum(x.unbind(0), torch.zeros((), dtype=x.dtype, device=x.device))


def adamw_update_ref(params, grads, ms, vs, decayed, scale: torch.Tensor,
                     *, lr: float, b1: float, b2: float, b1c: float,
                     b2c: float, eps: float, wd: float) -> None:
    """AdamW's step of each parameter in place, in float32, rounded back
    to its dtype: its gradient times ``scale``, the moments ``ms``/``vs``
    updated in place, weight decay where ``decayed``."""
    for p, g, m, v, dec in zip(params, grads, ms, vs, decayed):
        g = g.float() * scale.to(p.device)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).add_(g * g, alpha=1 - b2)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        pf = p.float()
        if dec:
            delta.add_(pf, alpha=wd)
        p.copy_(pf - lr * delta)


# ---------------------------------------------------------------------------
# the microbatch gradient accumulation (the eager loop the kernel replaces)
# ---------------------------------------------------------------------------

def grad_accumulate_ref(accs, grads, *, mode: str, scale: float = 1.0
                        ) -> None:
    """Each gradient added into its float32 accumulator in place: ``first``
    zeros the accumulator before the addition, ``last`` multiplies by
    ``scale`` (a Python float, taken in float32) after it."""
    check_accum_args(accs, grads, mode)
    for a, g in zip(accs, grads):
        if mode == "first":
            a.zero_()
        a += g.float()
        if mode == "last":
            a.mul_(scale)
