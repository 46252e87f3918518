"""Public entry points of the hand-written kernels, by device.

A CUDA tensor goes to the hand-written kernel, whose wrapper checks its
inputs and raises on anything it does not take.  Any other tensor (the
host fission slots' CPU tensors, the ``meta`` tensors of a shape probe)
goes to the plain PyTorch version in :mod:`repro_torch.kernels.ref`, but
for the ``meta`` tensors that reach the three LM kernels (flash attention,
the SSD scan, the grouped GEMM), the train step's (AdamW's gradient
norm and update, the microbatch accumulation) and the decode step's
(RMSNorm, rope with the cache write, decode attention, the Mamba2
recurrent step): those take the card's route, autograd Functions
included, with :mod:`repro_torch.kernels.meta`'s stand-ins in place of the launches, so
that a dry-run step counts each kernel by its work formula.  The choice
is the tensor's device and nothing else: no error ever sends a CUDA
tensor to the plain version.

Gradients.  On the CPU autograd runs through the plain versions.  On the
card, flash attention, the SSD scan and the grouped GEMM are
``torch.autograd.Function``s whose backward is a hand-written kernel too
(flash and the SSD scan: their own backward kernels; the grouped GEMM: in
bf16 its dx and dw kernels, otherwise two more forward calls on
transposed copies).  The SSD scan's backward takes float32 x, B and C
(what the models feed it): a bfloat16 input that needs a gradient raises
``ValueError``.  The other kernels have no backward: given a CUDA input
that requires grad (with grad enabled) they raise, rather than return a
result that autograd cannot see through.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import adamw as _adamw
from repro_torch.kernels import decode_step as _decode
from repro_torch.kernels import filter_pipeline as _filter
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import grad_accum as _accum
from repro_torch.kernels import meta as _meta
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


def _kernels(t: torch.Tensor):
    """The wrappers a CUDA tensor's call launches, or for a meta tensor
    their stand-ins; None for any other device (the plain versions)."""
    if t.is_meta:
        return _meta
    return _CARD if t.is_cuda else None


class _FlashAttention(torch.autograd.Function):
    """The flash kernel with its backward kernel: the forward keeps each
    row's log-sum-exp for the backward to recompute P from.  Both
    directions go through the head-dim padding
    (:func:`~repro_torch.kernels.flash_attention.padded_call`).  ``kern``
    holds the wrappers (:func:`_kernels`)."""

    @staticmethod
    def forward(ctx, q, k, v, bshd: bool, kw: dict, kern):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _flash.padded_call(
            q, k, v, launch=functools.partial(
                kern.flash_attention_with_lse, bshd=bshd), **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.bshd, ctx.kw, ctx.kern = bshd, kw, kern
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash.padded_call(
            q, k, v, o, do.contiguous(), lse, launch=functools.partial(
                ctx.kern.flash_attention_backward, bshd=ctx.bshd), **ctx.kw)
        return dq, dk, dv, None, None, None


def _flash_kernel(q, k, v, bshd: bool, kw: dict, kern) -> torch.Tensor:
    if not _needs_grad(q, k, v):
        fwd = kern.flash_attention_bshd if bshd else kern.flash_attention
        return _flash.padded_call(q, k, v, launch=fwd, **kw)
    if kw.get("kv_len") is not None:
        raise ValueError("the flash attention backward does not take kv_len")
    return _FlashAttention.apply(q, k, v, bshd, kw, kern)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    **kw) -> torch.Tensor:
    """(B,H,Sq,hd) x (B,KV,Sk,hd) attention (GQA/causal/window/softcap/
    ``kv_len``), output in q's dtype."""
    kern = _kernels(q)
    if kern is not None:
        return _flash_kernel(q, k, v, False, kw, kern)
    return ref.attention_ref(q, k, v, **kw)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         **kw) -> torch.Tensor:
    """Model-layout adapter: (B,S,H,hd)/(B,S,KV,hd) in and out.  The kernel
    reads the model's layout through its strides; the plain version works
    on transposed views."""
    kern = _kernels(q)
    if kern is not None:
        return _flash_kernel(q, k, v, True, kw, kern)
    o = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), **kw)
    return o.transpose(1, 2)


class _FlashTwoPart(torch.autograd.Function):
    """Attention of one query block over two key blocks, each one flash
    call with its log-sum-exp, merged by the rows' log-sum-exps; the
    backward runs the flash backward kernel on each block with the merged
    output and log-sum-exp, as ring attention does.  Block A is unmasked
    but for its window ``kw_a`` and is seen by the first ``n_a`` query rows
    only (the rest see none of its keys: they are left out of its calls,
    where the kernels would average V over a row without keys); block B is
    causal (``kw_b``)."""

    @staticmethod
    def forward(ctx, q, ka, va, kb, vb, n_a: int, kw_a: dict, kw_b: dict,
                kern):
        q = q.contiguous()
        ka, va, kb, vb = (t.contiguous() for t in (ka, va, kb, vb))
        fwd = functools.partial(kern.flash_attention_with_lse, bshd=True)
        oa, la = _flash.padded_call(q[:, :n_a].contiguous(), ka, va,
                                    launch=fwd, **kw_a)
        ob, lb = _flash.padded_call(q, kb, vb, launch=fwd, **kw_b)
        lse = lb.clone()
        lse[..., :n_a] = torch.logaddexp(la, lb[..., :n_a])    # (B,H,Sq)
        wa = torch.exp(la - lse[..., :n_a]).transpose(1, 2)[..., None]
        wb = torch.exp(lb - lse).transpose(1, 2)[..., None]
        acc = torch.promote_types(q.dtype, torch.float32)
        o = ob.to(acc) * wb
        o[:, :n_a] += oa.to(acc) * wa
        o = o.to(q.dtype)
        ctx.save_for_backward(q, ka, va, kb, vb, o, lse)
        ctx.n_a, ctx.kw_a, ctx.kw_b, ctx.kern = n_a, kw_a, kw_b, kern
        return o

    @staticmethod
    def backward(ctx, do):
        q, ka, va, kb, vb, o, lse = ctx.saved_tensors
        n = ctx.n_a
        bwd = functools.partial(ctx.kern.flash_attention_backward, bshd=True)
        do = do.contiguous()
        dqa, dka, dva = _flash.padded_call(
            q[:, :n].contiguous(), ka, va, o[:, :n].contiguous(),
            do[:, :n].contiguous(), lse[..., :n].contiguous(), launch=bwd,
            **ctx.kw_a)
        dq, dkb, dvb = _flash.padded_call(q, kb, vb, o, do, lse, launch=bwd,
                                          **ctx.kw_b)
        dq = dq.clone()
        dq[:, :n] += dqa
        return dq, dka, dva, dkb, dvb, None, None, None, None


def flash_attention_offset_bshd(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, q_offset: int,
                                window: Optional[int] = None,
                                logit_cap: float = 0.0,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Causal attention of the queries at positions ``q_offset`` ..
    ``q_offset + Sq - 1`` over the keys at 0 .. Sk-1 (model layout,
    (B,Sq,H,hd) x (B,Sk,KV,hd), Sk >= q_offset + Sq): a sequence shard's
    attention.  The kernel's causal mask is aligned at the first query, so
    the keys split in two: those before the block (block A: every one
    before the query, inside the window where there is one, a window of
    its own in A's coordinates) and the block's own (block B: causal as
    the kernel has it), merged by :class:`_FlashTwoPart`.  At offset 0
    this is one flash call."""
    Sq = q.shape[1]
    o_ = int(q_offset)
    kw = dict(logit_cap=logit_cap, scale=scale)
    kern = _kernels(q)
    if kern is None:
        o = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, window=window,
                              q_offset=o_, **kw)
        return o.transpose(1, 2)
    kb, vb = k[:, o_:o_ + Sq], v[:, o_:o_ + Sq]
    kw_b = dict(kw, causal=True, window=window)
    a = max(0, o_ - window + 1) if window is not None else 0
    if o_ == 0 or a >= o_:
        return flash_attention_bshd(q, kb, vb, **kw_b)
    kw_a = dict(kw, causal=False,
                window=None if window is None else a + window - o_)
    # under a window, query i sees a key of block A only while i < window - 1
    n_a = Sq if window is None else min(Sq, window - 1)
    ka, va = k[:, a:o_], v[:, a:o_]
    return _FlashTwoPart.apply(q, ka, va, kb, vb, n_a, kw_a, kw_b, kern)


class _SSDScan(torch.autograd.Function):
    """The SSD scan with its backward kernel: the forward keeps the chunks'
    starting states and the within-chunk cumsum of dt * A from its
    scratch.  A final-state gradient that autograd does not have (the
    training path never uses h_final) stays None: no zeros are made.
    ``kern`` holds the wrappers (:func:`_kernels`)."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, h0, chunk: int, kern):
        y, h, states, cum = kern.ssd_scan_with_states(x, dt, B, C, A,
                                                      chunk=chunk, h0=h0)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, B, C, A, h0, states, cum)
        ctx.chunk, ctx.kern = chunk, kern
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, B, C, A, h0, states, cum = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        grads = ctx.kern.ssd_scan_backward(
            x, dt, B, C, A, h0, states, cum, dy,
            None if dh is None else dh.contiguous(), chunk=ctx.chunk)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None,
                None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, *, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba2 SSD -> (y in x's dtype, final state float32)."""
    kern = _kernels(x)
    if kern is not None:
        if not _needs_grad(x, dt, B, C, A, h0):
            return kern.ssd_scan(x, dt, B, C, A, chunk=chunk, h0=h0)
        if x.dtype != torch.float32:
            raise ValueError(f"the SSD scan's backward takes float32 x, B "
                             f"and C, got {x.dtype}")
        return _SSDScan.apply(x, dt, B, C, A, h0, chunk, kern)
    return ref.ssd_scan_ref(x, dt, B, C, A, chunk=chunk, h0=h0)


class _GroupedMatmul(torch.autograd.Function):
    """y[e] = x[e] w[e]; dx[e] = dy[e] w[e]^T and dw[e] = x[e]^T dy[e].
    In bf16 on rows the TMA takes, each gradient is a backward kernel that
    reads x, w and dy in place; otherwise (float32, other bf16 rows) each
    is the forward kernel on contiguous transposed copies.  The route
    follows dtype and alignment alone.  ``kern`` holds the wrappers
    (:func:`_kernels`)."""

    @staticmethod
    def forward(ctx, x, w, kern):
        ctx.save_for_backward(x, w)
        ctx.kern = kern
        return kern.grouped_matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        kern = ctx.kern
        dy = dy.contiguous()
        dx = dw = None
        if _gmm.backward_in_place(x, w, dy):
            if ctx.needs_input_grad[0]:
                dx = kern.grouped_matmul_dx(dy, w)
            if ctx.needs_input_grad[1]:
                dw = kern.grouped_matmul_dw(x, dy)
            return dx, dw, None
        if ctx.needs_input_grad[0]:
            dx = kern.grouped_matmul(dy, w.transpose(1, 2).contiguous(),
                                     backward=True)
        if ctx.needs_input_grad[1]:
            dw = kern.grouped_matmul(x.transpose(1, 2).contiguous(), dy,
                                     backward=True)
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E,C,d) x (E,d,f) -> (E,C,f), one product per expert, summed in
    float32, in x's dtype."""
    kern = _kernels(x)
    if kern is not None:
        if _needs_grad(x, w):
            return _GroupedMatmul.apply(x, w, kern)
        return kern.grouped_matmul(x, w)
    return ref.grouped_matmul_ref(x, w)


def grad_sumsq(grads) -> torch.Tensor:
    """(n,) float32: each of the gradients' sum of squares (one device)."""
    kern = _kernels(grads[0])
    if kern is not None:
        return kern.grad_sumsq(grads)
    return ref.grad_sumsq_ref(grads)


def sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """0-d: the sum of the float32 vector ``x``, in a fixed order."""
    kern = _kernels(x)
    if kern is not None:
        return kern.sum_in_order(x)
    return ref.sum_in_order_ref(x)


def adamw_update(params, grads, ms, vs, decayed, scale: torch.Tensor,
                 **hyper) -> None:
    """AdamW's step of every parameter in place (``ref.adamw_update_ref``;
    ``hyper``: lr, b1, b2, b1c, b2c, eps, wd)."""
    kern = _kernels(params[0])
    if kern is not None:
        return kern.adamw_update(params, grads, ms, vs, decayed, scale,
                                 **hyper)
    return ref.adamw_update_ref(params, grads, ms, vs, decayed, scale,
                                **hyper)


def grad_accumulate(accs, grads, *, mode: str, scale: float = 1.0) -> None:
    """One microbatch's gradients added into their float32 accumulators in
    place (``ref.grad_accumulate_ref``; ``mode`` first, middle or last,
    the last multiplying by ``scale``)."""
    kern = _kernels(accs[0]) if accs else None
    if kern is not None:
        return kern.grad_accumulate(accs, grads, mode=mode, scale=scale)
    return ref.grad_accumulate_ref(accs, grads, mode=mode, scale=scale)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
            residual: Optional[torch.Tensor] = None):
    """RMSNorm of x over its last dim in x's dtype (``ref.rmsnorm_ref``);
    with a residual, (x + residual, its norm)."""
    kern = _kernels(x)
    if kern is not None:
        _no_backward("rmsnorm", x, scale, residual)
        return kern.rmsnorm(x, scale, eps, residual)
    return ref.rmsnorm_ref(x, scale, eps, residual)


def rope_cache_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor, pos, *,
                     freqs: Optional[torch.Tensor] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """One decode step's q and k rotated at ``pos`` (an int or a 0-d int64
    tensor) by ``freqs``, k and v written into their cache row in place
    (``ref.rope_cache_ref``); returns q."""
    kern = _kernels(q)
    if kern is not None:
        _no_backward("rope_cache_write", q, k, v)
        return kern.rope_cache_write(q, k, v, k_cache, v_cache, pos,
                                     freqs=freqs, window=window)
    return ref.rope_cache_ref(q, k, v, k_cache, v_cache, pos, freqs=freqs,
                              window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos,
                     window: Optional[int] = None, logit_cap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """(B,1,H,hd) attention of one query a slot over the rows of the
    (B,S,KV,hd) caches valid at ``pos`` (``ref.decode_attention_ref``)."""
    kern = _kernels(q)
    if kern is not None:
        _no_backward("decode_attention", q, k_cache, v_cache)
        return kern.decode_attention(q, k_cache, v_cache, pos=pos,
                                     window=window, logit_cap=logit_cap,
                                     scale=scale)
    return ref.decode_attention_ref(q, k_cache, v_cache, pos=pos,
                                    window=window, logit_cap=logit_cap,
                                    scale=scale)


def ssd_decode_step(z, x, B, C, dt, p, *, h: torch.Tensor, conv):
    """The Mamba2 recurrent step of one token past its projections
    (``ref.ssd_decode_step_ref``): y = (C . h + D x) * silu(z), with the
    conv buffers ``conv`` and the float32 state ``h`` updated in place."""
    kern = _kernels(x)
    if kern is not None:
        _no_backward("ssd_decode_step", z, x, B, C, dt,
                     *(p[k] for k in ("dt_bias", "A_log", "D", "conv_x",
                                      "conv_B", "conv_C")))
        return kern.ssd_decode_step(z, x, B, C, dt, p, h=h, conv=conv)
    return ref.ssd_decode_step_ref(z, x, B, C, dt, p, h=h, conv=conv)


class _Card:
    """The card's wrappers of the LM kernels, the train step's and the
    decode step's, under the names of :mod:`repro_torch.kernels.meta`'s
    stand-ins, looked up in their modules at each call (a check may put a
    patched wrapper there)."""

    def __getattr__(self, name: str):
        for module in (_flash, _ssd, _gmm, _adamw, _accum, _decode):
            if hasattr(module, name):
                return getattr(module, name)
        raise AttributeError(name)


_CARD = _Card()


#: launch counters of the kernels, by kernel name
COUNTERS = {c.name: c for c in (_saxpy.launches, _filter.launches,
                                _seg.launches, _nbody.launches,
                                _flash.launches, _ssd.launches,
                                _gmm.launches, _flash.bwd_launches,
                                _ssd.bwd_launches,
                                *_gmm.bwd_kernels.values(),
                                _adamw.launches, _accum.launches,
                                _decode.rms_launches, _decode.rope_launches,
                                _decode.attn_launches,
                                _decode.ssd_launches)}
