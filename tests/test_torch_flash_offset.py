"""A sequence shard's causal attention (``ops.flash_attention_offset_bshd``)
on the CPU: its merge of two flash calls (``ops._FlashTwoPart``) driven by
stand-ins of the kernels' entry points that compute what the kernels
compute — the forward's output and natural-log log-sum-exp, the backward
from P = exp(S - lse) with the kernels' rule for a row that sees no key
(P = 1/Sk, dS = 0: it adds dO/Sk to every dV) — against autograd through
the plain version with the query offset, in float64.  The shard's queries
sit at positions off .. off+Sq-1 over the keys 0 .. off+Sq-1, with no
window, a window past the block and one inside it (whose rows past it
see no key of the keys before the block).  Tolerance 1e-5 of the largest
value: the plain version computes in float32.
"""
import math
import types

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import NEG_INF


def _scores(q, k, causal, window, scale, logit_cap):
    """(B,H,Sq,Sk) masked scores and the mask, q/k in the model layout."""
    qh, kh = q.transpose(1, 2), k.transpose(1, 2)
    H, KV = qh.shape[1], kh.shape[1]
    kh = kh.repeat_interleave(H // KV, dim=1)
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * sc
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    Sq, Sk = s.shape[-2:]
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return s.masked_fill(~mask, NEG_INF), mask


def _with_lse(q, k, v, *, bshd, causal=True, window=None, logit_cap=0.0,
              scale=None, kv_len=None):
    assert bshd and kv_len is None
    s, _ = _scores(q, k, causal, window, scale, logit_cap)
    lse = torch.logsumexp(s, -1)
    H, KV = q.shape[2], k.shape[2]
    vh = v.transpose(1, 2).repeat_interleave(H // KV, dim=1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.exp(s - lse[..., None]), vh)
    return o.transpose(1, 2).to(q.dtype), lse


def _backward(q, k, v, o, do, lse, *, bshd, causal=True, window=None,
              logit_cap=0.0, scale=None, kv_len=None):
    """The backward kernels' arithmetic (no logit cap here)."""
    assert bshd and not logit_cap
    s, mask = _scores(q, k, causal, window, scale, logit_cap)
    H, KV = q.shape[2], k.shape[2]
    G, Sk = H // KV, k.shape[1]
    keyless = ~mask.any(-1)                          # (Sq,)
    p = torch.exp(s - lse[..., None])
    p[..., keyless, :] = 1.0 / Sk                    # the kernels' rule
    dOh, Oh = do.transpose(1, 2), o.transpose(1, 2)
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dP = torch.einsum("bhqd,bhkd->bhqk", dOh, vh)
    D = (dOh * Oh).sum(-1, keepdim=True)
    dS = p * (dP - D)
    dS[..., keyless, :] = 0.0
    dq = torch.einsum("bhqk,bhkd->bhqd", dS, kh) * sc
    dk = torch.einsum("bhqk,bhqd->bhkd", dS, qh) * sc
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dOh)
    B, _, Skv, hd = dk.shape
    fold = lambda t: t.reshape(B, KV, G, Skv, hd).sum(2).transpose(1, 2)
    return dq.transpose(1, 2), fold(dk), fold(dv)


KERN = types.SimpleNamespace(flash_attention_with_lse=_with_lse,
                             flash_attention_backward=_backward)


@pytest.mark.parametrize("off,window", [(160, None), (160, 200), (160, 64),
                                        (40, 64)],
                         ids=["offset", "window_past_block", "window_inside",
                              "window_over_start"])
def test_two_part_merge_matches_plain(off, window, monkeypatch):
    monkeypatch.setattr(ops, "_kernels", lambda t: KERN)
    g = torch.Generator().manual_seed(off + (window or 0))
    Sq, Sk = 96, off + 96
    q, do = (torch.randn(2, Sq, 4, 16, generator=g, dtype=torch.float64)
             for _ in range(2))
    k, v = (torch.randn(2, Sk, 2, 16, generator=g, dtype=torch.float64)
            for _ in range(2))

    def grads(fn):
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
        o = fn(qs, ks, vs)
        return (o, *torch.autograd.grad(o, (qs, ks, vs), do))

    got = grads(lambda q, k, v: ops.flash_attention_offset_bshd(
        q, k, v, q_offset=off, window=window))
    want = grads(lambda q, k, v: ref.attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, q_offset=off).transpose(1, 2))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name

