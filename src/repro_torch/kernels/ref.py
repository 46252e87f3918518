"""Plain PyTorch versions of the hand-written kernels: the paper's
benchmark kernels, the LM kernels (flash attention, SSD scan, the MoE
grouped GEMM), the train step's (AdamW, the microbatch accumulation) and
the decode step's (RMSNorm, rope with the cache write, decode attention,
the Mamba2 recurrent step).

Each computes the same function as its hand-written CUDA kernel with
ordinary tensor operations, on any device.  The CPU tests hold them
against the JAX package's kernels, ``chip_smoke.py`` holds each kernel
against them on the card, and the host fission slots compute their share
of every hybrid run with them (``ops`` dispatches by device).
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import math

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# the decode step's layer bodies (the eager code the decode kernels replace)
# ---------------------------------------------------------------------------

#: cache rows a decode step turns to float32 at a time
DECODE_ROWS = 4096


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float,
                residual: Optional[torch.Tensor] = None):
    """RMSNorm over the last dim (``rmsnorm_rows``); with a residual, the
    sum ``x + residual`` in x's dtype and its norm."""
    if residual is not None:
        s = x + residual
        return s, rmsnorm_rows(s, scale, eps)
    return rmsnorm_rows(x, scale, eps)


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor, eps: float
                 ) -> torch.Tensor:
    """RMSNorm over the last dim in float32, in x's dtype: the models'
    norm everywhere (``layers.rmsnorm``) and the decode norm's plain
    version."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rotate_ref(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, hd) rotated at ``positions`` (broadcastable to
    (..., S)) by the float32 frequencies ``freqs`` (hd/2,)."""
    ang = positions.to(torch.float32)[..., None] * freqs       # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def update_cache_ref(k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor,
                     pos: Union[int, torch.Tensor],
                     window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one (B,1,KV,hd) k/v at ``pos`` (modulo window for rolling),
    in place.  A position past the end is clamped to the last row, as
    ``jax.lax.dynamic_update_slice`` clamps it in the JAX package; a tensor
    position is reduced and clamped on the device."""
    Scap = k_cache.shape[1]
    idx = pos % Scap if (window is not None and Scap == window) else pos
    if isinstance(idx, torch.Tensor):
        idx = idx.clamp(0, Scap - 1).long().view(1)
        k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
        v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
        return k_cache, v_cache
    idx = min(max(idx, 0), Scap - 1)
    k_cache[:, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[:, idx] = v[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def rope_cache_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   k_cache: torch.Tensor, v_cache: torch.Tensor,
                   pos: Union[int, torch.Tensor], *,
                   freqs: Optional[torch.Tensor] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """One decode step's q and k (B,1,H,hd), (B,1,KV,hd) rotated at
    ``pos`` by ``freqs`` (None: no rotation), k and v written at the
    cache row of ``pos`` (``update_cache_ref``).  Returns q."""
    if freqs is not None:
        positions = (pos.view(1, 1) if isinstance(pos, torch.Tensor)
                     else torch.full((1, 1), pos, device=q.device))
        q = rotate_ref(q, positions, freqs)
        k = rotate_ref(k, positions, freqs)
    update_cache_ref(k_cache, v_cache, k, v, pos, window=window)
    return q


def decode_scores(q: torch.Tensor, k_cache: torch.Tensor, *,
                  pos: Union[int, torch.Tensor], window: Optional[int],
                  logit_cap: float, scale: Optional[float], row0: int = 0,
                  n_rows: Optional[int] = None) -> torch.Tensor:
    """The masked float32 scores (B,KV,G,rows) of one decode query over the
    cache's rows, read a block of :data:`DECODE_ROWS` rows at a time.  Row j
    of the cache is position ``row0 + j`` of a cache of ``n_rows`` rows."""
    B, _, H, hd = q.shape
    Scap, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    n_rows = Scap if n_rows is None else n_rows
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.empty((B, KV, G, Scap), dtype=torch.float32, device=q.device)
    for a in range(0, Scap, DECODE_ROWS):
        b = min(a + DECODE_ROWS, Scap)
        s[..., a:b] = torch.einsum("bkgh,bjkh->bkgj", qg,
                                   k_cache[:, a:b].to(q.dtype).float())
    s = s * sc
    if logit_cap and logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    j = torch.arange(Scap, device=q.device) + row0
    valid = j <= pos
    if window is not None and n_rows > window:
        valid &= j > pos - window
    return s.masked_fill(~valid, NEG_INF)


def weighted_values(p: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """sum_j p[..., j] v[:, j] in float32, a block of rows at a time:
    (B,KV,G,hd)."""
    Scap = v_cache.shape[1]
    o = None
    for a in range(0, Scap, DECODE_ROWS):
        b = min(a + DECODE_ROWS, Scap)
        part = torch.einsum("bkgj,bjkh->bkgh", p[..., a:b],
                            v_cache[:, a:b].float())
        o = part if o is None else o + part
    return o


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, *,
                         pos: Union[int, torch.Tensor],
                         window: Optional[int] = None, logit_cap: float = 0.0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,1,H,hd); caches: (B,Scap,KV,hd); ``pos``: current position.

    For rolling (windowed) caches the caller guarantees Scap == window and
    positions are stored modulo the window; masking here is by validity
    count only.  Scores and the weighted sum are float32, as in the JAX
    package (bf16 products are exact in float32); the cache is read in its
    own dtype, a block of rows at a time."""
    B, _, H, hd = q.shape
    s = decode_scores(q, k_cache, pos=pos, window=window,
                      logit_cap=logit_cap, scale=scale)
    p = torch.softmax(s, dim=-1)
    o = weighted_values(p, v_cache)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def _conv1(val: torch.Tensor, w: torch.Tensor, buf: torch.Tensor):
    """One token's depth-K causal conv of ``val`` (B,1,C) after the
    buffer's K-1 rows (B,K-1,C), weights (K,C), then silu; and the shifted
    window."""
    window = torch.cat([buf.to(val.dtype), val], dim=1)
    y = torch.einsum("bkc,kc->bc", window, w)[:, None]
    return F.silu(y), window[:, 1:]


def ssd_decode_step_ref(z: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor, dt: torch.Tensor,
                        p: Mapping[str, torch.Tensor], *, h: torch.Tensor,
                        conv: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The Mamba2 recurrent step of one token past its projections: z, x
    (B,1,nh*hd), B, C (B,1,ds) and the raw dt (B,1,nh) in, y = (C . h +
    D x) * silu(z) (B,1,nh*hd) out; the conv buffers ``conv`` (x, B, C)
    shifted and the float32 state ``h`` (B,nh,ds,hd) updated in place."""
    Bsz = x.shape[0]
    nh, ds = dt.shape[-1], B.shape[-1]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    xr, nbx = _conv1(x, p["conv_x"], conv["x"])
    Br, nbB = _conv1(B, p["conv_B"], conv["B"])
    Cr, nbC = _conv1(C, p["conv_C"], conv["C"])
    A = -torch.exp(p["A_log"].float())
    xh = xr.reshape(Bsz, nh, -1).float()                  # (B,nh,hd)
    dt1 = dt.reshape(Bsz, nh)                             # f32
    a = torch.exp(dt1 * A)                                # (B,nh)
    Bv = Br.reshape(Bsz, ds).float()
    Cv = Cr.reshape(Bsz, ds).float()
    hf = h.float()
    h_new = hf * a[:, :, None, None] + torch.einsum(
        "bs,bh,bhe->bhse", Bv, dt1, xh)
    y = torch.einsum("bs,bhse->bhe", Cv, h_new)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(Bsz, 1, -1).to(x.dtype)
    y = y * F.silu(z)
    h.copy_(h_new.to(h.dtype))
    for key, new in (("x", nbx), ("B", nbB), ("C", nbC)):
        conv[key].copy_(new.to(conv[key].dtype))
    return y
