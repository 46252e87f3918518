"""The three LM kernels, the train step's (AdamW's, the microbatch
accumulation's) and the decode step's on ``meta`` tensors: what a dry-run
step reaches in their place.

Each function here stands for the CUDA wrapper of the same name in
:mod:`~repro_torch.kernels.flash_attention`,
:mod:`~repro_torch.kernels.ssd_scan`, :mod:`~repro_torch.kernels.moe_gemm`,
:mod:`~repro_torch.kernels.adamw` (all three of its wrappers under
``adamw``, as they count in its ``launches``),
:mod:`~repro_torch.kernels.grad_accum` or
:mod:`~repro_torch.kernels.decode_step`:
it takes the same arguments, allocates the same outputs and scratch (on
``meta``: shapes, no memory), launches nothing, and reports the call with
its work from :mod:`repro_torch.launch.roofline` (the FLOPs and bytes of
the card's kernel at these shapes) to every sink in :data:`SINKS` (the
grouped GEMM's backward kernels under the forward's name, as their
launches count in its ``launches``).
:mod:`~repro_torch.kernels.ops` sends meta tensors here through the same
autograd Functions as the card's, so a dry-run step counts each kernel
call, forward and backward, by its formula, and never runs a plain version
(the SSD scan's loops over every token in Python; attention's forms the
dense float32 scores).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import decode_step as _decode
from repro_torch.kernels import grad_accum as _accum
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.launch import roofline as rl

#: callables ``sink(kernel name, flops, bytes)`` told of every call;
#: :class:`repro_torch.launch.op_analysis.OpAnalysis` adds itself while it
#: counts
SINKS: List[Callable[[str, float, float], None]] = []


def _report(name: str, work: rl.Work) -> None:
    for sink in SINKS:
        sink(name, *work)


def _bhsd(t: torch.Tensor, bshd: bool) -> torch.Tensor:
    return t.transpose(1, 2) if bshd else t


def _flash(q, k, v, bshd: bool, **kw) -> None:
    qh, kh = _bhsd(q, bshd), _bhsd(k, bshd)
    B, H, Sq, hd = qh.shape
    _report("flash_attention",
            rl.flash_work(B, H, kh.shape[1], Sq, kh.shape[2], hd, q.dtype,
                          **kw))


def flash_attention(q, k, v, **kw) -> torch.Tensor:
    _flash(q, k, v, False, **kw)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def flash_attention_bshd(q, k, v, **kw) -> torch.Tensor:
    _flash(q, k, v, True, **kw)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def flash_attention_with_lse(q, k, v, *, bshd: bool = False, **kw):
    _flash(q, k, v, bshd, **kw)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(_bhsd(q, bshd).shape[:3], dtype=torch.float32,
                      device=q.device)
    return o, lse


def flash_attention_backward(q, k, v, o, do, lse, *, bshd: bool = False,
                             causal: bool = True,
                             window: Optional[int] = None,
                             logit_cap: float = 0.0,
                             scale: Optional[float] = None,
                             kv_len: Optional[int] = None):
    if kv_len is not None:
        raise ValueError("the flash attention backward does not take "
                         "kv_len")
    qh, kh = _bhsd(q, bshd), _bhsd(k, bshd)
    B, H, Sq, hd = qh.shape
    dq = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype,
                             device=q.device)
    dk = torch.empty_strided(k.shape, k.stride(), dtype=k.dtype,
                             device=k.device)
    dv = torch.empty_strided(k.shape, k.stride(), dtype=k.dtype,
                             device=k.device)
    torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)   # D
    _report("flash_attention_bwd",
            rl.flash_bwd_work(B, H, kh.shape[1], Sq, hd, q.dtype, causal,
                              kh.shape[2], window))
    return dq, dk, dv


def _ssd_dims(x, dt, B):
    Bsz, S, dih = x.shape
    nh = dt.shape[-1]
    return Bsz, S, nh, dih // nh, B.shape[-1]


def ssd_scan_with_states(x, dt, B, C, A, *, chunk: int,
                         h0: Optional[torch.Tensor] = None):
    Bsz, S, nh, hd, ds = _ssd_dims(x, dt, B)
    y = torch.empty_like(x)
    h = torch.empty((Bsz, nh, ds, hd), dtype=torch.float32, device=x.device)
    states, cb, cum = _ssd.scratch(Bsz, S, nh, hd, ds, chunk, x.device)
    _report("ssd_scan", rl.ssd_work(Bsz, S, chunk, nh, hd, ds, x.dtype,
                                    h0 is not None))
    return y, h, states, cum


def ssd_scan(x, dt, B, C, A, *, chunk: int,
             h0: Optional[torch.Tensor] = None):
    y, h, _, _ = ssd_scan_with_states(x, dt, B, C, A, chunk=chunk, h0=h0)
    return y, h


def ssd_scan_backward(x, dt, B, C, A, h0, states, cum, dy, dh_final, *,
                      chunk: int):
    Bsz, S, nh, hd, ds = _ssd_dims(x, dt, B)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.empty_like(A)
    dh0 = None if h0 is None else torch.empty(
        (Bsz, nh, ds, hd), dtype=torch.float32, device=x.device)
    _ssd.bwd_scratch(Bsz, S, nh, hd, ds, chunk, _ssd.head_groups(nh),
                     x.device)
    _report("ssd_scan_bwd",
            rl.ssd_bwd_work(Bsz, S, chunk, nh, hd, ds, h0 is not None,
                            dh_final is not None))
    return dx, ddt, dB, dC, dA, dh0


def grouped_matmul(x, w, *, backward: bool = False) -> torch.Tensor:
    E, C, d = x.shape
    f = w.shape[2]
    y = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    if y.numel():
        _report("grouped_matmul", rl.gmm_work(E, C, d, f, x.dtype))
    return y


def grouped_matmul_dx(dy, w) -> torch.Tensor:
    E, C, f = dy.shape
    d = w.shape[1]
    dx = torch.empty((E, C, d), dtype=dy.dtype, device=dy.device)
    if dx.numel():      # dx[e] = dy[e] w[e]^T: (C, f) x (f, d)
        _report("grouped_matmul", rl.gmm_work(E, C, f, d, dy.dtype))
    return dx


def grouped_matmul_dw(x, dy) -> torch.Tensor:
    E, C, d = x.shape
    f = dy.shape[2]
    dw = torch.empty((E, d, f), dtype=x.dtype, device=x.device)
    if dw.numel():      # dw[e] = x[e]^T dy[e]: (d, C) x (C, f)
        _report("grouped_matmul", rl.gmm_work(E, d, C, f, x.dtype))
    return dw


def grad_sumsq(grads) -> torch.Tensor:
    numels = [g.numel() for g in grads]
    dev = grads[0].device
    torch.empty((_adamw.chunks_of(numels)[-1],), dtype=torch.float32,
                device=dev)                                    # partials
    out = torch.empty((len(grads),), dtype=torch.float32, device=dev)
    _report("adamw", rl.adamw_sumsq_work(numels, [g.dtype for g in grads]))
    return out


def sum_in_order(x) -> torch.Tensor:
    _report("adamw", rl.adamw_sum_work(x.numel()))
    return torch.empty((), dtype=torch.float32, device=x.device)


def adamw_update(params, grads, ms, vs, decayed, scale, **hyper) -> None:
    _report("adamw", rl.adamw_update_work(
        [p.numel() for p in params], [p.dtype for p in params],
        [g.dtype for g in grads]))


def grad_accumulate(accs, grads, *, mode: str, scale: float = 1.0) -> None:
    _accum.check_args(accs, grads, mode)
    _report("grad_accum", rl.grad_accum_work(
        [a.numel() for a in accs], [g.dtype for g in grads], mode))


def rmsnorm(x, scale, eps, residual=None):
    rows, d = _decode.check_rmsnorm(x, scale, residual)
    y = torch.empty_like(x)
    _report("rmsnorm", rl.rmsnorm_work(rows, d, x.dtype, scale.dtype,
                                       residual is not None))
    return y if residual is None else (torch.empty_like(x), y)


def rope_cache_write(q, k, v, k_cache, v_cache, pos, *, freqs=None,
                     window=None):
    B, H, KV, S, hd = _decode.check_rope_cache(q, k, v, k_cache, v_cache,
                                               freqs)
    _decode.check_position(pos, q.device)
    _report("rope_cache_write", rl.rope_cache_work(
        B, H, KV, hd, q.dtype, k_cache.dtype, freqs is not None))
    return q if freqs is None else torch.empty_like(q)


def decode_attention(q, k_cache, v_cache, *, pos, window=None,
                     logit_cap=0.0, scale=None):
    B, H, KV, S, hd = _decode.check_decode_attention(q, k_cache, v_cache)
    _decode.check_position(pos, q.device)
    _, splits = _decode.split_plan(B, KV, S, _decode.H100_SMS)
    _decode.attention_scratch(B, H, S, hd, splits, q.device)
    rows = rl.decode_rows(S, None if isinstance(pos, torch.Tensor) else pos,
                          window)
    _report("decode_attention", rl.decode_attention_work(
        B, H, KV, rows, hd, q.dtype, k_cache.dtype))
    return torch.empty_like(q)


def ssd_decode_step(z, x, B, C, dt, p, *, h, conv):
    Bsz, nh, hd, ds, K = _decode.ssd_dims(z, x, B, C, dt, p, h, conv)
    _report("ssd_decode_step", rl.ssd_decode_work(Bsz, nh, hd, ds, K,
                                                  x.dtype, conv["x"].dtype))
    return torch.empty_like(x)
