"""The bf16 flash kernel's arithmetic, emulated on the CPU.

The tensor-core kernel (``csrc/flash_attention.cu``) multiplies bf16 q and
k into float32 scores, takes an online softmax in base 2 over tiles of 64
keys, and multiplies P.V on the tensor cores with P split into two bf16
halves, ``hi = bf16(P)`` and ``lo = bf16(P - hi)``, summed in float32.  The
emulation below repeats that arithmetic in PyTorch and is held to the plain
version ``ref.attention_ref`` under the bound the card checks hold the
kernel to (one bf16 step plus 3e-4, elementwise), on inputs made with numpy
from a seed; one head is built so that V cancels.  On that head a single
bf16 rounding of P breaks the bound, which is why the kernel splits it.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

NEG_INF = -2.0 ** 30
LOG2E = 1.4426950408889634
BK = 64
TOL = 3e-4


def emulate(q, k, v, *, causal=True, window=None, logit_cap=0.0,
            kv_len=None, split=True):
    """q (B, H, Sq, hd), k/v (B, KV, Sk, hd) bf16 -> (B, H, Sq, hd) bf16,
    as the kernel computes it (every key tile visited)."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    kv_len = Sk if kv_len is None else kv_len
    window = 2 ** 30 if window is None else window
    out = torch.empty(q.shape, dtype=torch.bfloat16)
    qi = torch.arange(Sq)[:, None]
    for b in range(B):
        for h in range(H):
            kvh = h // (H // KV)
            qf = q[b, h].float()
            m = torch.full((Sq, 1), NEG_INF)
            l = torch.zeros((Sq, 1))
            acc = torch.zeros((Sq, hd))
            for k0 in range(0, Sk, BK):
                kj = torch.arange(k0, k0 + BK)[None, :]
                kt = torch.zeros((BK, hd))
                vt = torch.zeros((BK, hd))
                n = min(BK, Sk - k0)
                kt[:n] = k[b, kvh, k0:k0 + n].float()
                vt[:n] = v[b, kvh, k0:k0 + n].float()
                s = qf @ kt.T                      # float32 sums of bf16
                if logit_cap > 0:
                    s = (logit_cap * LOG2E) * torch.tanh(s * (scale
                                                              / logit_cap))
                else:
                    s = s * (scale * LOG2E)
                ok = (kj < kv_len) & (kj > qi - window)
                if causal:
                    ok = ok & (kj <= qi)
                s = torch.where(ok, s, torch.tensor(NEG_INF))
                s = torch.where(kj < Sk, s, torch.tensor(-math.inf))
                m_new = torch.maximum(m, s.max(-1, keepdim=True).values)
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                hi = p.bfloat16().float()
                pv = hi @ vt
                if split:
                    pv = pv + (p - hi).bfloat16().float() @ vt
                acc = acc * corr + pv
                m = m_new
            out[b, h] = (acc / l.clamp_min(1e-30)).bfloat16()
    return out


def excess(got, want):
    """Largest |got - want| / (2^-7 |want| + 3e-4): <= 1 within the bound."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (2.0 ** -7 * want.abs() + TOL)).max().item()


def inputs(seed, Sq=80, Sk=80, hd=16):
    """Head 0 random; head 1 built so that V cancels: every query sees
    keys 0 and 1 at scores 2.0 and 1.59375 (P about 0.6 and 0.4) and the
    rest at -10, with V rows 4, -6 and 0, so each output is ~1e-3 from
    terms of ~2.4."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, 2, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((1, 2, Sk, hd)).astype(np.float32)
    v = rng.standard_normal((1, 2, Sk, hd)).astype(np.float32)
    q[0, 1] = 0.0
    q[0, 1, :, 0] = 1.0
    k[0, 1] = 0.0
    k[0, 1, :, 0] = -40.0          # scale 1/4: scores -10
    k[0, 1, 0, 0] = 8.0            # 2.0
    k[0, 1, 1, 0] = 6.375          # 1.59375
    v[0, 1] = 0.0
    v[0, 1, 0] = 4.0
    v[0, 1, 1] = -6.0
    return tuple(torch.from_numpy(a).bfloat16() for a in (q, k, v))


@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=False, kv_len=70),
    dict(causal=True, window=16, logit_cap=20.0),
    dict(causal=True, window=8, kv_len=20),       # fully masked rows
], ids=["causal", "kv_len", "window_softcap", "fully_masked"])
def test_split_p_emulation_within_bf16_bound(kw):
    q, k, v = inputs(0)
    want = ref.attention_ref(q, k, v, **kw)
    assert excess(emulate(q, k, v, **kw), want) <= 1.0


def test_cancelling_head_needs_the_split():
    """Non-causal, so every query row of head 1 cancels: with P split the
    emulation is within the bound; with P rounded once to bf16 it is not."""
    q, k, v = inputs(1)
    want = ref.attention_ref(q, k, v, causal=False)
    assert want[0, 1].float().abs().max().item() < 0.01   # it cancels
    split = emulate(q, k, v, causal=False)
    once = emulate(q, k, v, causal=False, split=False)
    assert excess(split[:, 1], want[:, 1]) <= 1.0
    assert excess(once[:, 1], want[:, 1]) > 1.0
