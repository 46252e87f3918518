"""The flash backward kernel's algorithm, emulated on the CPU.

``csrc/flash_attention_bwd.cu`` computes dQ, dK and dV in three passes:
D = rowsum(dO o); a pass over key tiles (per kv head, walking the query
heads of its group and the query tiles that can see the tile) that
recomputes P = exp(S - lse) from the forward's per-row log-sum-exp and
accumulates dV += P^T dO and dK += dS^T Q, dS = P (dP - D) (times
1 - tanh^2 under the softcap); and a pass over query tiles that
accumulates dQ += dS K over the key tiles its rows can see.  Rows whose
every key is masked take P = 1/Sk (the forward averages V over all keys)
and dS = 0; when a call has such rows every query tile is visited.  All
of it in float32 from the inputs (float32 or bfloat16), each gradient
rounded once to the input's dtype.

The emulation repeats that tiling, skipping and arithmetic in PyTorch and
is held to autograd through ``ref.attention_ref`` and to ``jax.vjp`` of
the JAX package's ``blockwise_attention`` on the same inputs (made with
numpy from a seed), causal, windowed and softcapped, GQA 4/2, a ragged
sequence, and rows without keys.  Tolerances: float32, max |err| <= 1e-4 x
max |g| (the same float32 function summed in another order: tile by tile
here, whole rows there); bf16 inputs, each element within one bf16 step
(2^-7 of its value) of the float32 gradient of the same bf16 inputs plus
that bound, plus, for dq and dk, how far D moves with the output rounded
to bf16 (``flash_bwd_bounds.attention_bwd_rounding``), as the card checks
hold the kernel.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_bwd_bounds import attention_bwd_rounding
from repro.models.attention import blockwise_attention
from repro_torch.kernels import ref

NO_WINDOW = 1 << 30
TOL = 1e-4
BF16_STEP = 2.0 ** -7


def tiles(hd):
    """(keys a dK/dV block, query rows a tile), as the kernel's Tile<HD>."""
    return (64 if hd <= 64 else 32 if hd <= 128 else 16,
            64 if hd <= 64 else 32)


def keyless(i, Sk, causal, window):
    lo = max(0, i - window + 1)
    hi = min(i, Sk - 1) if causal else Sk - 1
    return lo > hi


def p_and_ds(q, k, v, do, lse, D, q0, k0, *, Sq, Sk, causal, window, cap,
             scale):
    """The kernel's P and dS of one (query tile, key tile), float32."""
    s = (q @ k.T) * scale
    deriv = torch.ones_like(s)
    if cap > 0:
        t = torch.tanh(s / cap)
        s, deriv = cap * t, 1 - t * t
    dp = do @ v.T
    qi = torch.arange(q0, q0 + q.shape[0])[:, None]
    kj = torch.arange(k0, k0 + k.shape[0])[None, :]
    ok = (qi < Sq) & (kj < Sk) & (kj > qi - window)
    if causal:
        ok &= kj <= qi
    no_key = torch.tensor([i < Sq and keyless(i, Sk, causal, window)
                           for i in range(q0, q0 + q.shape[0])])[:, None]
    p = torch.where(ok, torch.exp(s - lse[:, None]),
                    torch.where(no_key & (kj < Sk),
                                torch.tensor(1.0 / Sk), torch.tensor(0.0)))
    ds = torch.where(ok, p * (dp - D[:, None]) * deriv, torch.tensor(0.0))
    return p, ds


def rows(t, r0, n, limit):
    """Rows [r0, r0 + n) of a (S, hd) tensor as float32, zeros past limit."""
    out = torch.zeros((n, t.shape[1]))
    m = max(0, min(limit, r0 + n) - r0)
    out[:m] = t[r0:r0 + m].float()
    return out


def emulate_backward(q, k, v, o, do, lse, *, causal=True, window=None,
                     logit_cap=0.0, scale=None):
    """dq, dk, dv (in q's dtype) as the three kernels compute them;
    q/o/do (B, H, Sq, hd), k/v (B, KV, Sk, hd), lse (B, H, Sq) float32."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    BK, BQ = tiles(hd)
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    win = NO_WINDOW if window is None else window
    kw = dict(Sq=Sq, Sk=Sk, causal=causal, window=win, cap=logit_cap,
              scale=sc)
    all_keyed = win >= 1 and Sq - 1 < Sk + win - 1
    D = (do.float() * o.float()).sum(-1)                        # pass 1
    dq = torch.zeros(q.shape, dtype=torch.float32)
    dk = torch.zeros(k.shape, dtype=torch.float32)
    dv = torch.zeros(k.shape, dtype=torch.float32)
    for b in range(B):
        for kvh in range(KV):                                   # pass 2
            for k0 in range(0, Sk, BK):
                kt, vt = rows(k[b, kvh], k0, BK, Sk), rows(v[b, kvh], k0,
                                                           BK, Sk)
                q_begin, q_end = 0, Sq
                if all_keyed:
                    k_last = min(k0 + BK, Sk) - 1
                    if causal:
                        q_begin = k0
                    q_end = min(q_end, k_last + win)
                    q_begin = q_begin // BQ * BQ
                acc_k = torch.zeros((BK, hd))
                acc_v = torch.zeros((BK, hd))
                for g in range(G):                              # GQA sum
                    h = kvh * G + g
                    for q0 in range(q_begin, q_end, BQ):
                        qt = rows(q[b, h], q0, BQ, Sq)
                        dot = rows(do[b, h], q0, BQ, Sq)
                        ls = rows(lse[b, h][:, None], q0, BQ, Sq)[:, 0]
                        Dt = rows(D[b, h][:, None], q0, BQ, Sq)[:, 0]
                        p, ds = p_and_ds(qt, kt, vt, dot, ls, Dt, q0, k0,
                                         **kw)
                        acc_v += p.T @ dot
                        acc_k += ds.T @ qt
                n = min(BK, Sk - k0)
                dk[b, kvh, k0:k0 + n] = (acc_k * sc)[:n]
                dv[b, kvh, k0:k0 + n] = acc_v[:n]
        for h in range(H):                                      # pass 3
            kvh = h // G
            for q0 in range(0, Sq, BQ):
                qt = rows(q[b, h], q0, BQ, Sq)
                dot = rows(do[b, h], q0, BQ, Sq)
                ls = rows(lse[b, h][:, None], q0, BQ, Sq)[:, 0]
                Dt = rows(D[b, h][:, None], q0, BQ, Sq)[:, 0]
                q_last = min(q0 + BQ, Sq) - 1
                k_begin = max(0, q0 - win + 1) // BK * BK
                k_end = min(Sk, q_last + 1) if causal else Sk
                acc = torch.zeros((BQ, hd))
                for k0 in range(k_begin, k_end, BK):
                    kt = rows(k[b, kvh], k0, BK, Sk)
                    vt = rows(v[b, kvh], k0, BK, Sk)
                    _, ds = p_and_ds(qt, kt, vt, dot, ls, Dt, q0, k0, **kw)
                    acc += ds @ kt
                n = min(BQ, Sq - q0)
                dq[b, h, q0:q0 + n] = (acc * sc)[:n]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def forward_lse(q, k, *, causal=True, window=None, logit_cap=0.0,
                scale=None):
    """Each row's log-sum-exp of its masked scores, float32, as the forward
    kernel writes it (masked scores -2^30)."""
    Sq, Sk, hd = q.shape[2], k.shape[2], q.shape[3]
    G = q.shape[1] // k.shape[1]
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(G, 1)) * sc
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return torch.logsumexp(s.masked_fill(~mask, ref.NEG_INF), -1)


def inputs(B, H, KV, Sq, Sk, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return (mk(B, H, Sq, hd).to(dtype), mk(B, KV, Sk, hd).to(dtype),
            mk(B, KV, Sk, hd).to(dtype), mk(B, H, Sq, hd).to(dtype))


def plain_grads(q, k, v, do, **kw):
    """Autograd through ``ref.attention_ref`` in float32 from the same
    (possibly bf16-valued) inputs."""
    qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    o = ref.attention_ref(qf, kf, vf, **kw)
    return torch.autograd.grad(o, (qf, kf, vf), do.float())


def jax_grads(q, k, v, do, **kw):
    """``jax.vjp`` of the JAX package's attention, (B, S, H, hd) layout."""
    f = lambda a, b, c: blockwise_attention(a, b, c, **kw)
    t = lambda x: jnp.asarray(x.float().transpose(1, 2).numpy())
    _, vjp = jax.vjp(f, t(q), t(k), t(v))
    return [torch.from_numpy(np.asarray(g)).transpose(1, 2)
            for g in vjp(t(do))]


CASES = [
    # (B, H, KV, Sq, Sk, hd, kw)
    (1, 4, 2, 100, 100, 16, dict(causal=True)),
    (1, 4, 2, 77, 77, 32, dict(causal=True, window=20)),
    (2, 4, 2, 90, 90, 64, dict(causal=True, logit_cap=5.0)),
    (1, 4, 2, 70, 70, 80, dict(causal=False, window=16, logit_cap=3.0)),
    (1, 2, 2, 40, 40, 128, dict(causal=False)),
]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,kw", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_backward_matches_autograd(B, H, KV, Sq, Sk, hd, kw, dtype):
    q, k, v, do = inputs(B, H, KV, Sq, Sk, hd, dtype)
    o = ref.attention_ref(q, k, v, **kw)
    lse = forward_lse(q, k, **kw)
    got = emulate_backward(q, k, v, o, do, lse, **kw)
    want = plain_grads(q, k, v, do, **kw)
    rounding = (*attention_bwd_rounding(q, k, o, do, **kw), 0.0)
    for name, g, w, r in zip("qkv", got, want, rounding):
        assert g.dtype == dtype
        err = (g.float() - w).abs()
        bound = TOL * w.abs().max()
        if dtype == torch.bfloat16:
            bound = bound + BF16_STEP * w.abs() + r
        assert (err <= bound).all(), (name, err.max().item())


@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,kw", CASES[:4])
def test_emulated_backward_matches_jax_vjp(B, H, KV, Sq, Sk, hd, kw):
    q, k, v, do = inputs(B, H, KV, Sq, Sk, hd, torch.float32, seed=1)
    o = ref.attention_ref(q, k, v, **kw)
    got = emulate_backward(q, k, v, o, do, forward_lse(q, k, **kw), **kw)
    want = jax_grads(q, k, v, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert (g - w).abs().max() <= TOL * w.abs().max(), name


@pytest.mark.parametrize("causal,window,Sq,Sk", [(False, 8, 40, 24),
                                                 (True, 4, 36, 20),
                                                 (True, 0, 24, 24)])
def test_rows_without_keys(causal, window, Sq, Sk):
    """Rows that see no key (the query runs past the keys' window, or a
    window of 0) average V in the forward: their gradient reaches only dV,
    and every query tile is visited."""
    kw = dict(causal=causal, window=window)
    q, k, v, do = inputs(1, 4, 2, Sq, Sk, 16, torch.float32, seed=2)
    assert any(keyless(i, Sk, causal, window) for i in range(Sq))
    o = ref.attention_ref(q, k, v, **kw)
    got = emulate_backward(q, k, v, o, do, forward_lse(q, k, **kw), **kw)
    want = plain_grads(q, k, v, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert (g - w).abs().max() <= TOL * max(w.abs().max(), 1e-6), name
