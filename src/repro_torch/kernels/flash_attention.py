"""Flash attention on the card, launching ``csrc/flash_attention.cu`` and,
for the gradients, ``csrc/flash_attention_bwd.cu``.

The kernels read q/k/v and write the output through their (batch, head,
sequence) strides, so the model's (B, S, H, hd) layout goes in and comes
out without a transposed copy (:func:`flash_attention_bshd`); only the
head dimension must be contiguous.  The forward can also write each query
row's log-sum-exp (``with_lse``), which the backward
(:func:`flash_attention_backward`: three kernels a call, counted once in
``bwd_launches`` and once in ``bwd_paths`` by path: the tensor cores for
bfloat16, FP32 FMAs for float32) reads to recompute the probabilities.

The kernels are instantiated for the head dims in ``HEAD_DIMS``.  Any
other head dim up to the largest of them runs through
:func:`padded_call`: q, k, v (and o and dO for the backward) get zero
columns up to the next instantiated dim, the scale stays 1/sqrt(true head
dim), and the outputs are sliced back.  Zero columns add nothing to Q K^T,
so P and the log-sum-exp are unchanged, and the padded columns of P V,
dQ, dK and dV are dropped.  Above the largest dim the call raises.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import (DTYPE_CODES, LaunchCounter,
                                        check_launch, library, require,
                                        stream_of)

launches = LaunchCounter("flash_attention")
bwd_launches = LaunchCounter("flash_attention_bwd")
#: backward calls by path, chosen by dtype in the C entry: "mma" (bfloat16:
#: the tensor-core kernels) and "fma" (float32: FP32 FMAs)
bwd_paths = {"mma": LaunchCounter("flash_attention_bwd/mma"),
             "fma": LaunchCounter("flash_attention_bwd/fma")}
#: kernels one backward call launches (D = rowsum(dO o), dK/dV, dQ)
BWD_KERNELS_PER_CALL = 3

#: head dims the kernel is instantiated for (every config of the repo:
#: 64, 80, 128, 256; the smaller ones for the smoke configs)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
#: the largest head dim a call takes (there is nothing to pad it up to)
MAX_HEAD_DIM = HEAD_DIMS[-1]
#: window passed for "no window": ``k > q - 2**30`` holds for every key
NO_WINDOW = 1 << 30
_DTYPES = (torch.float32, torch.bfloat16)


def _check(t: torch.Tensor, name: str, like: Optional[torch.Tensor]) -> None:
    require(t, name, ndim=4, dtypes=_DTYPES, contiguous=False,
            device=None if like is None else like.device)
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dimension")
    if like is not None and t.dtype != like.dtype:
        raise ValueError(f"{name} is {t.dtype}, q is {like.dtype}")


def padded_dim(hd: int) -> int:
    """The instantiated head dim a call at ``hd`` runs at: the smallest of
    ``HEAD_DIMS`` that is at least ``hd``."""
    for d in HEAD_DIMS:
        if d >= hd:
            return d
    raise ValueError(f"head_dim {hd} is above {MAX_HEAD_DIM}, the largest "
                     "head dim the flash kernels take")


def padded_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                *more: torch.Tensor, launch, scale: Optional[float] = None,
                **kw):
    """``launch(q, k, v, *more, scale=..., **kw)`` at an instantiated head
    dim.  At a dim of ``HEAD_DIMS`` this is the call itself.  At another
    dim every 4-D argument (q, k, v, and o and dO for the backward) gets
    zero columns up to :func:`padded_dim`, the scale is fixed at
    1/sqrt(true head dim), and every 4-D result is sliced back to the true
    head dim (contiguous); anything else (lse) passes through unchanged."""
    hd = q.shape[-1]
    hp = padded_dim(hd)
    if hp == hd:
        return launch(q, k, v, *more, scale=scale, **kw)
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    four_d = lambda t: isinstance(t, torch.Tensor) and t.ndim == 4
    args = [F.pad(t, (0, hp - hd)) if four_d(t) else t
            for t in (q, k, v, *more)]
    out = launch(*args, scale=sc, **kw)
    back = [t[..., :hd].contiguous() if four_d(t) else t
            for t in (out if isinstance(out, tuple) else (out,))]
    return tuple(back) if isinstance(out, tuple) else back[0]


def _launch(q, k, v, o, *, lse: Optional[torch.Tensor] = None,
            causal: bool = True, window: Optional[int] = None,
            logit_cap: float = 0.0, scale: Optional[float] = None,
            kv_len: Optional[int] = None) -> None:
    """q/o (B, H, Sq, hd), k/v (B, KV, Sk, hd) views of CUDA tensors; lse
    None or a contiguous (B, H, Sq) float32 tensor."""
    _check(q, "q", None)
    for t, name in ((k, "k"), (v, "v"), (o, "out")):
        _check(t, name, q)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KV, Sk, hd) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if H % KV:
        raise ValueError(f"GQA needs H % KV == 0, got {H} % {KV}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if lse is not None:
        require(lse, "lse", ndim=3, device=q.device)
        if tuple(lse.shape) != (B, H, Sq):
            raise ValueError(f"lse {tuple(lse.shape)} is not (B, H, Sq)")
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    kvl = Sk if kv_len is None else int(kv_len)
    win = NO_WINDOW if window is None else int(window)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3]]
    check_launch(library().flash_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        DTYPE_CODES[q.dtype], B, H, KV, Sq, Sk, hd, *strides, float(sc),
        float(logit_cap or 0.0), int(bool(causal)), win, kvl,
        q.device.index, stream_of(q)), "flash_attention")
    launches.add()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_cap: float = 0.0, scale: Optional[float] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, H, Sq, hd), k/v (B, KV, Sk, hd), float32 or bfloat16 CUDA
    tensors -> (B, H, Sq, hd) in q's dtype."""
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, o, causal=causal, window=window, logit_cap=logit_cap,
            scale=scale, kv_len=kv_len)
    return o


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         **kw) -> torch.Tensor:
    """The model's layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd) ->
    (B, Sq, H, hd), contiguous."""
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            o.transpose(1, 2), **kw)
    return o


def _bhsd(t: torch.Tensor, bshd: bool) -> torch.Tensor:
    return t.transpose(1, 2) if bshd else t


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, bshd: bool = False, **kw
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward, in the (B, H, S, hd) layout or (``bshd``) the model's,
    and each query row's log-sum-exp (B, H, Sq) float32: the backward's
    inputs."""
    qh = _bhsd(q, bshd)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(qh.shape[:3], dtype=torch.float32, device=q.device)
    _launch(qh, _bhsd(k, bshd), _bhsd(v, bshd), _bhsd(o, bshd), lse=lse,
            **kw)
    return o, lse


def flash_attention_backward(q, k, v, o, do, lse, *, bshd: bool = False,
                             causal: bool = True,
                             window: Optional[int] = None,
                             logit_cap: float = 0.0,
                             scale: Optional[float] = None,
                             kv_len: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """dq, dk, dv of the forward ``o = flash_attention(q, k, v)`` given the
    output gradient ``do`` and the forward's ``lse``, in the layout of q
    (``bshd``: the model's).  q, o and do must share their strides, as
    must k and v (the forward's contiguous tensors do); the gradients come
    out with those strides, in q's dtype."""
    if kv_len is not None:
        raise ValueError("the flash attention backward does not take "
                         "kv_len")
    qh, kh, vh, oh, doh = (_bhsd(t, bshd) for t in (q, k, v, o, do))
    _check(qh, "q", None)
    for t, name in ((kh, "k"), (vh, "v"), (oh, "o"), (doh, "do")):
        _check(t, name, qh)
    B, H, Sq, hd = qh.shape
    KV, Sk = kh.shape[1], kh.shape[2]
    if tuple(kh.shape) != (B, KV, Sk, hd) or vh.shape != kh.shape \
            or oh.shape != qh.shape or doh.shape != qh.shape:
        raise ValueError(f"shapes do not fit: q {tuple(qh.shape)}, k "
                         f"{tuple(kh.shape)}, v {tuple(vh.shape)}, o "
                         f"{tuple(oh.shape)}, do {tuple(doh.shape)}")
    if not (qh.stride() == oh.stride() == doh.stride()
            and kh.stride() == vh.stride()):
        raise ValueError("q, o and do must share their strides, and k and v")
    if H % KV:
        raise ValueError(f"GQA needs H % KV == 0, got {H} % {KV}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    require(lse, "lse", ndim=3, device=q.device)
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"lse {tuple(lse.shape)} is not (B, H, Sq)")
    dq = torch.empty_strided(q.shape, q.stride(), dtype=q.dtype,
                             device=q.device)
    dk = torch.empty_strided(k.shape, k.stride(), dtype=k.dtype,
                             device=k.device)
    dv = torch.empty_strided(k.shape, k.stride(), dtype=k.dtype,
                             device=k.device)
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    win = NO_WINDOW if window is None else int(window)
    check_launch(library().flash_attention_bwd(
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), oh.data_ptr(),
        doh.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), D.data_ptr(), DTYPE_CODES[q.dtype], B, H, KV, Sq, Sk,
        hd, *qh.stride()[:3], *kh.stride()[:3], float(sc),
        float(logit_cap or 0.0), int(bool(causal)), win, q.device.index,
        stream_of(q)), "flash_attention_bwd")
    bwd_launches.add()
    bwd_paths["mma" if q.dtype == torch.bfloat16 else "fma"].add()
    return dq, dk, dv
