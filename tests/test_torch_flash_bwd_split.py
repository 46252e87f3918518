"""The bf16 flash backward's arithmetic, emulated on the CPU.

The tensor-core kernels of ``csrc/flash_attention_bwd.cu`` (bf16 path)
multiply bf16 operands into float32 sums on ``mma.sync``: S = Q K^T and
dP = dO V^T; then P = 2^(log2(e) (scale S - lse)) from the forward's
natural-log log-sum-exp (softcapped: cap tanh(scale S / cap) in place of
scale S), and dS = P (dP - D) (times 1 - tanh^2) with D = rowsum(dO o) from
the bf16 output.  dV = P^T dO, dK = scale dS^T Q and dQ = scale dS K take P
and dS split into hi = bf16(x) and lo = bf16(x - hi), both halves
multiplied and summed in float32; each gradient is rounded once to bf16.
Rows whose every key is masked take P = 1/Sk and dS = 0.

The emulation repeats that arithmetic on whole matrices (the kernels'
tiles change only the order of the float32 sums, which
``test_torch_flash_bwd_emu.py`` follows tile by tile) and is held to
autograd through ``ref.attention_ref`` and to ``jax.vjp`` of the JAX
package's ``blockwise_attention``, on inputs made with numpy from a seed,
under the card checks' elementwise bound: one bf16 step (2^-7 of the
value) plus 1e-4 x max |g|, plus for dq and dk how far D moves with the
output rounded to bf16 (``flash_bwd_bounds.attention_bwd_rounding``).  On
a head built so that its terms cancel (``flash_bwd_bounds.cancelling``) a
single bf16 rounding of P, or of dS, breaks that bound, which is why the
kernels split both.
"""
import math

import numpy as np
import pytest
import torch

from flash_bwd_bounds import attention_bwd_rounding, cancelling
from repro_torch.kernels import ref
from test_torch_flash_bwd_emu import forward_lse, jax_grads, plain_grads

LOG2E = 1.4426950408889634
NO_WINDOW = 1 << 30
TOL = 1e-4
BF16_STEP = 2.0 ** -7


def halves(x, split):
    """x as the bf16 operands the kernels multiply: hi and lo, or hi."""
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()] if split else [hi]


def emulate(q, k, v, o, do, lse, *, causal=True, window=None, logit_cap=0.0,
            split_p=True, split_ds=True):
    """dq, dk, dv (bf16) as the tensor-core kernels compute them from bf16
    q/o/do (B, H, Sq, hd), k/v (B, KV, Sk, hd) and the forward's lse
    (B, H, Sq); ``split_p`` / ``split_ds``: P / dS as hi + lo halves (the
    kernels) or rounded once to bf16."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    win = NO_WINDOW if window is None else window
    kf = k.float().repeat_interleave(G, 1)
    vf = v.float().repeat_interleave(G, 1)
    s = q.float() @ kf.transpose(-1, -2)
    deriv = 1.0
    if logit_cap > 0:
        th = torch.tanh(s * (scale / logit_cap))
        x = (logit_cap * LOG2E) * th
        deriv = 1.0 - th * th
    else:
        x = s * (scale * LOG2E)
    p = torch.exp2(x - lse[..., None] * LOG2E)
    D = (do.float() * o.float()).sum(-1)
    ds = p * (do.float() @ vf.transpose(-1, -2) - D[..., None]) * deriv
    qi, kj = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    ok = kj > qi - win
    if causal:
        ok = ok & (kj <= qi)
    keyless = ~ok.any(-1, keepdim=True)
    p = torch.where(ok, p, torch.where(keyless, torch.tensor(1.0 / Sk),
                                       torch.tensor(0.0)))
    ds = torch.where(ok, ds, torch.tensor(0.0))
    dv = sum(h.transpose(-1, -2) @ do.float() for h in halves(p, split_p))
    dk = scale * sum(h.transpose(-1, -2) @ q.float()
                     for h in halves(ds, split_ds))
    dq = scale * sum(h @ kf for h in halves(ds, split_ds))
    by_kv = lambda t: t.reshape(B, KV, G, Sk, hd).sum(2)
    return dq.bfloat16(), by_kv(dk).bfloat16(), by_kv(dv).bfloat16()


def inputs(B, H, KV, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                     ).bfloat16()
    return mk(B, H, Sq, hd), mk(B, KV, Sk, hd), mk(B, KV, Sk, hd), \
        mk(B, H, Sq, hd)


def excess(got, want, rounding):
    """The largest share of the elementwise bound over dq, dk and dv, and
    over the elements of each: at most 1 within it."""
    out = []
    for g, w, r in zip(got, want, (*rounding, 0.0)):
        bound = TOL * w.abs().max() + BF16_STEP * w.abs() + r
        out.append(((g.float() - w).abs() / bound).max().item())
    return out


def run(q, k, v, do, kw, **split):
    """The emulation's gradients and the bound's rounding term, from the
    plain forward's bf16 output and float32 lse."""
    o = ref.attention_ref(q, k, v, **kw)
    got = emulate(q, k, v, o, do, forward_lse(q, k, **kw), **kw, **split)
    return got, attention_bwd_rounding(q, k, o, do, **kw)


CASES = [
    # (B, H, KV, Sq, Sk, hd, kw)
    (1, 4, 2, 96, 96, 32, dict(causal=True)),
    (1, 4, 2, 77, 77, 32, dict(causal=True, window=20)),
    (2, 2, 2, 64, 64, 64, dict(causal=True, logit_cap=5.0)),
    (1, 4, 2, 70, 70, 16, dict(causal=False, window=16, logit_cap=3.0)),
    (1, 2, 2, 48, 48, 16, dict(causal=False)),
]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,kw", CASES,
                         ids=["causal", "window_ragged", "softcap",
                              "window_softcap_noncausal", "noncausal"])
def test_split_emulation_matches_autograd(B, H, KV, Sq, Sk, hd, kw):
    q, k, v, do = inputs(B, H, KV, Sq, Sk, hd, seed=0)
    got, rounding = run(q, k, v, do, kw)
    want = plain_grads(q, k, v, do, **kw)
    assert max(excess(got, want, rounding)) <= 1.0


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,kw", CASES[:3],
                         ids=["causal", "window_ragged", "softcap"])
def test_split_emulation_matches_jax_vjp(B, H, KV, Sq, Sk, hd, kw):
    q, k, v, do = inputs(B, H, KV, Sq, Sk, hd, seed=1)
    got, rounding = run(q, k, v, do, kw)
    want = jax_grads(q, k, v, do, **kw)
    assert max(excess(got, want, rounding)) <= 1.0


@pytest.mark.parametrize("kw,Sq,Sk", [(dict(causal=False, window=8), 40, 24),
                                      (dict(causal=True, window=4), 36, 20),
                                      (dict(causal=True, window=0), 24, 24)],
                         ids=["noncausal_past_keys", "causal_past_keys",
                              "no_window"])
def test_split_emulation_rows_without_keys(kw, Sq, Sk):
    """Rows that see no key: P = 1/Sk into dV, nothing into dQ or dK."""
    q, k, v, do = inputs(1, 4, 2, Sq, Sk, 16, seed=2)
    got, rounding = run(q, k, v, do, kw)
    want = plain_grads(q, k, v, do, **kw)
    assert max(excess(got, want, rounding)) <= 1.0


def cancelling_inputs():
    """GQA 4/2, causal, 128 rows, kv head 0 and its query heads built to
    cancel."""
    return cancelling(*inputs(1, 4, 2, 128, 128, 32, seed=3))


def test_cancelling_head_within_bound_with_the_split():
    q, k, v, do = cancelling_inputs()
    kw = dict(causal=True)
    got, rounding = run(q, k, v, do, kw)
    want = plain_grads(q, k, v, do, **kw)
    assert max(excess(got, want, rounding)) <= 1.0


@pytest.mark.parametrize("rounded", ["p", "ds"])
def test_cancelling_head_breaks_the_bound_with_one_rounding(rounded):
    """P rounded once to bf16 moves dV, dS rounded once moves dQ and dK,
    past the bound on the cancelling head."""
    q, k, v, do = cancelling_inputs()
    kw = dict(causal=True)
    got, rounding = run(q, k, v, do, kw, **{f"split_{rounded}": False})
    want = plain_grads(q, k, v, do, **kw)
    dq, dk, dv = excess(got, want, rounding)
    if rounded == "p":
        assert dv > 1.0 and max(dq, dk) <= 1.0
    else:
        assert dq > 1.0 and dk > 1.0 and dv <= 1.0
