"""Public entry points of the hand-written kernels, by device.

A CUDA tensor goes to the hand-written kernel, whose wrapper checks its
inputs and raises on anything it does not take.  Any other tensor (the
host fission slots' CPU tensors, the ``meta`` tensors of a shape probe)
goes to the plain PyTorch version in :mod:`repro_torch.kernels.ref`.
The choice is the tensor's device and nothing else: no error ever sends
a CUDA tensor to the plain version.

Gradients.  On the CPU autograd runs through the plain versions.  On the
card, flash attention, the SSD scan and the grouped GEMM are
``torch.autograd.Function``s whose backward is a hand-written kernel too
(flash and the SSD scan: their own backward kernels; the grouped GEMM: two
more grouped GEMMs).  The SSD scan's backward takes float32 x, B and C (what
the models feed it): a bfloat16 input that needs a gradient raises
``ValueError``.  The other kernels have no backward: given a CUDA input
that requires grad (with grad enabled) they raise, rather than return a
result that autograd cannot see through.
"""
from __future__ import annotations

import functools
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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors) -> None:
    """Raise if a kernel without a backward would be differentiated."""
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"the {name} kernel has no backward: call it on tensors that "
            "do not require grad, or under torch.no_grad()")


def saxpy(a, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        _no_backward("saxpy", a, x, y)
        return _saxpy.saxpy(a, x, y)
    return ref.saxpy_ref(a, x, y)


def filter_pipeline(img: torch.Tensor, seed: int = 0, **kw) -> torch.Tensor:
    if img.is_cuda:
        _no_backward("filter_pipeline", img)
        return _filter.filter_pipeline(img, seed, **kw)
    return ref.filter_pipeline_ref(img, seed, **kw)


def segmentation(vol: torch.Tensor, **kw) -> torch.Tensor:
    if vol.is_cuda:
        _no_backward("segmentation", vol)
        return _seg.segmentation(vol, **kw)
    return ref.segmentation_ref(vol, **kw)


def nbody_accelerations(pos: torch.Tensor, mass: torch.Tensor, *,
                        targets: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Accelerations on ``targets`` (default: every body) from ``pos``/``mass``."""
    tgt = pos if targets is None else targets
    if tgt.is_cuda:
        _no_backward("nbody", tgt, pos, mass)
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


class _FlashAttention(torch.autograd.Function):
    """The flash kernel with its backward kernel: the forward keeps each
    row's log-sum-exp for the backward to recompute P from.  Both
    directions go through the head-dim padding
    (:func:`~repro_torch.kernels.flash_attention.padded_call`)."""

    @staticmethod
    def forward(ctx, q, k, v, bshd: bool, kw: dict):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _flash.padded_call(
            q, k, v, launch=functools.partial(
                _flash.flash_attention_with_lse, bshd=bshd), **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.bshd, ctx.kw = bshd, kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash.padded_call(
            q, k, v, o, do.contiguous(), lse, launch=functools.partial(
                _flash.flash_attention_backward, bshd=ctx.bshd), **ctx.kw)
        return dq, dk, dv, None, None


def _flash_cuda(q, k, v, bshd: bool, kw: dict) -> torch.Tensor:
    if not _needs_grad(q, k, v):
        fwd = _flash.flash_attention_bshd if bshd else _flash.flash_attention
        return _flash.padded_call(q, k, v, launch=fwd, **kw)
    if kw.get("kv_len") is not None:
        raise ValueError("the flash attention backward does not take kv_len")
    return _FlashAttention.apply(q, k, v, bshd, kw)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    **kw) -> torch.Tensor:
    """(B,H,Sq,hd) x (B,KV,Sk,hd) attention (GQA/causal/window/softcap/
    ``kv_len``), output in q's dtype."""
    if q.is_cuda:
        return _flash_cuda(q, k, v, False, kw)
    return ref.attention_ref(q, k, v, **kw)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         **kw) -> torch.Tensor:
    """Model-layout adapter: (B,S,H,hd)/(B,S,KV,hd) in and out.  The kernel
    reads the model's layout through its strides; the plain version works
    on transposed views."""
    if q.is_cuda:
        return _flash_cuda(q, k, v, True, kw)
    o = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), **kw)
    return o.transpose(1, 2)


class _SSDScan(torch.autograd.Function):
    """The SSD scan with its backward kernel: the forward keeps the chunks'
    starting states and the within-chunk cumsum of dt * A from its
    scratch.  A final-state gradient that autograd does not have (the
    training path never uses h_final) stays None: no zeros are made."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, h0, chunk: int):
        y, h, states, cum = _ssd.ssd_scan_with_states(x, dt, B, C, A,
                                                      chunk=chunk, h0=h0)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, B, C, A, h0, states, cum)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, B, C, A, h0, states, cum = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = _ssd.ssd_scan_backward(
            x, dt, B, C, A, h0, states, cum, dy,
            None if dh is None else dh.contiguous(), chunk=ctx.chunk)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, *, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba2 SSD -> (y in x's dtype, final state float32)."""
    if x.is_cuda:
        if not _needs_grad(x, dt, B, C, A, h0):
            return _ssd.ssd_scan(x, dt, B, C, A, chunk=chunk, h0=h0)
        if x.dtype != torch.float32:
            raise ValueError(f"the SSD scan's backward takes float32 x, B "
                             f"and C, got {x.dtype}")
        return _SSDScan.apply(x, dt, B, C, A, h0, chunk)
    return ref.ssd_scan_ref(x, dt, B, C, A, chunk=chunk, h0=h0)


class _GroupedMatmul(torch.autograd.Function):
    """y[e] = x[e] w[e]; dx[e] = dy[e] w[e]^T and dw[e] = x[e]^T dy[e],
    each through the same kernel on contiguous transposed operands."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _gmm.grouped_matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gmm.grouped_matmul(dy, w.transpose(1, 2).contiguous(),
                                     backward=True)
        if ctx.needs_input_grad[1]:
            dw = _gmm.grouped_matmul(x.transpose(1, 2).contiguous(), dy,
                                     backward=True)
        return dx, dw


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E,C,d) x (E,d,f) -> (E,C,f), one product per expert, summed in
    float32, in x's dtype."""
    if x.is_cuda:
        if _needs_grad(x, w):
            return _GroupedMatmul.apply(x, w)
        return _gmm.grouped_matmul(x, w)
    return ref.grouped_matmul_ref(x, w)


#: launch counters of the kernels, by kernel name
COUNTERS = {c.name: c for c in (_saxpy.launches, _filter.launches,
                                _seg.launches, _nbody.launches,
                                _flash.launches, _ssd.launches,
                                _gmm.launches, _flash.bwd_launches,
                                _ssd.bwd_launches)}
