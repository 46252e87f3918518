"""Bounds shared by the flash backward's checks (the CPU emulation in
``test_torch_flash_bwd_emu.py``, the card tests in ``test_torch_cuda.py``
and ``chip_smoke.py``'s training phase).  Imports no JAX."""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.ref import attention_probs


def attention_bwd_rounding(q: torch.Tensor, k: torch.Tensor,
                           o: torch.Tensor, do: torch.Tensor, **kw
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elementwise bounds on how far dq and dk move when the backward
    reads the forward's output rounded to its dtype (bf16: within 2^-8 of
    each value), as the flash backward does for D = rowsum(dO o), and not
    the exact output autograd keeps: dS moves by P |dD|, so
    |ddq| <= scale (P |dD|) |K| and |ddk| <= scale (P |dD|)^T |Q| (summed
    over a kv head's query heads).  dv does not read D.  ``kw``: the
    forward's mask, softcap and scale."""
    hd, G = q.shape[-1], q.shape[1] // k.shape[1]
    sc = kw.get("scale") or 1.0 / math.sqrt(hd)
    unit = torch.finfo(o.dtype).eps / 2
    dD = (do.float().abs() * o.float().abs()).sum(-1) * unit   # (B,H,Sq)
    w = attention_probs(q, k, **kw) * dD[..., None]
    eq = sc * torch.einsum("bhqk,bhkd->bhqd", w,
                           k.float().abs().repeat_interleave(G, dim=1))
    ek = sc * torch.einsum("bhqk,bhqd->bhkd", w, q.float().abs())
    ek = ek.reshape(k.shape[0], k.shape[1], G, *ek.shape[2:]).sum(2)
    return eq, ek



def cancelling(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               do: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Copies of q, k, v and dO, (B, H, S, hd) and (B, KV, S, hd) with S
    even, in which kv head 0 and its query heads are built to cancel under
    the causal mask: query rows come in equal pairs and their dO rows in
    opposite ones (row 2m + 1 of q is row 2m, of dO minus row 2m), so the
    two rows' terms nearly cancel in dV (P^T dO) and dK (dS^T Q); keys come
    in near-equal pairs (key 2m + 1 is key 2m plus a tenth of its own
    random row) and their V rows in opposite ones, so the output and D are
    small and the two keys' terms nearly cancel in dQ (dS K).  There a
    single bf16 rounding of P (in dV) or of dS (in dQ and dK) breaks the
    elementwise bound the checks hold the backward to."""
    G, dtype = q.shape[1] // k.shape[1], q.dtype
    q, k, v, do = (t.float().clone() for t in (q, k, v, do))
    q[:, :G, 1::2] = q[:, :G, 0::2]
    do[:, :G, 1::2] = -do[:, :G, 0::2]
    k[:, 0, 1::2] = k[:, 0, 0::2] + 0.1 * k[:, 0, 1::2]
    v[:, 0, 1::2] = -v[:, 0, 0::2]
    return tuple(t.to(dtype) for t in (q, k, v, do))
