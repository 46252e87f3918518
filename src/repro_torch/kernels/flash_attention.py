"""Flash attention on the card, launching ``csrc/flash_attention.cu``.

The kernel reads q/k/v and writes the output through their (batch, head,
sequence) strides, so the model's (B, S, H, hd) layout goes in and comes
out without a transposed copy (:func:`flash_attention_bshd`); only the
head dimension must be contiguous.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels._build import (DTYPE_CODES, LaunchCounter,
                                        check_launch, library, require,
                                        stream_of)

launches = LaunchCounter("flash_attention")

#: head dims the kernel is instantiated for (every config of the repo:
#: 64, 80, 128, 256; the smaller ones for the smoke configs)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
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


def _launch(q, k, v, o, *, causal: bool = True,
            window: Optional[int] = None, logit_cap: float = 0.0,
            scale: Optional[float] = None,
            kv_len: Optional[int] = None) -> None:
    """q/o (B, H, Sq, hd), k/v (B, KV, Sk, hd) views of CUDA tensors."""
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
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    kvl = Sk if kv_len is None else int(kv_len)
    win = NO_WINDOW if window is None else int(window)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3]]
    check_launch(library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
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
