"""The port's plain versions of the LM kernels (``attention_ref``,
``ssd_scan_ref``) against the JAX package's Pallas kernels, run through
``repro.kernels.ops`` (interpreted on the CPU), on the same numpy inputs
made from a seed.  Tolerances as ``tests/test_kernels.py``: 3e-4 in
float32, 3e-2 in bfloat16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

F32_TOL = 3e-4
BF16_TOL = 3e-2


def gen(i):
    return np.random.default_rng(200 + i)


def qkv(B, H, KV, Sq, Sk, hd, i=0):
    r = gen(i)
    return (r.standard_normal((B, H, Sq, hd)).astype(np.float32),
            r.standard_normal((B, KV, Sk, hd)).astype(np.float32),
            r.standard_normal((B, KV, Sk, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (B, H, KV, Sq, Sk, hd), kwargs
    ((1, 2, 2, 64, 64, 16), dict(causal=True)),
    ((1, 2, 2, 64, 64, 80), dict(causal=True)),                # zamba2's hd
    ((2, 4, 2, 48, 48, 32), dict(causal=True)),                # GQA 2:1
    ((1, 4, 1, 32, 64, 16), dict(causal=False)),               # MQA, Sq != Sk
    ((1, 2, 2, 64, 64, 16), dict(causal=True, window=16)),
    ((1, 2, 2, 64, 64, 16), dict(causal=True, logit_cap=20.0)),
    ((1, 2, 2, 64, 64, 16), dict(causal=False, kv_len=40)),
    # rows q >= 27 keep no key (window 8 below q, kv_len 20): they average V
    ((1, 2, 2, 64, 64, 16), dict(causal=True, window=8, kv_len=20)),
]


@pytest.mark.parametrize("shape,kw", FLASH_CASES,
                         ids=["causal", "hd80", "gqa", "mqa_full", "window",
                              "softcap", "kv_len", "fully_masked_rows"])
def test_attention_ref_matches_pallas(shape, kw):
    q, k, v = qkv(*shape)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=32,
        block_k=32, **kw))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw).numpy()
    assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_fully_masked_rows_average_v():
    """NEG_INF = -2^30, not -inf: a row with no key left averages V."""
    q, k, v = qkv(1, 2, 2, 64, 64, 16, i=1)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=8,
                              kv_len=20)
    assert torch.isfinite(out).all()
    mean_v = torch.from_numpy(v).mean(dim=2)
    assert_allclose(out[:, :, 40].numpy(), mean_v.numpy(), rtol=1e-5,
                    atol=1e-5)


def test_attention_ref_bf16_matches_pallas():
    q, k, v = qkv(1, 4, 4, 64, 64, 80, i=2)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jops.flash_attention(qb, kb, vb, block_q=32,
                                           block_k=32).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    assert_allclose(got.float().numpy(), want, rtol=BF16_TOL, atol=BF16_TOL)


def test_bshd_adapter_matches_pallas():
    """The model-layout adapter: (B,S,H,hd) in and out."""
    q, k, v = (a.transpose(0, 2, 1, 3).copy()
               for a in qkv(2, 4, 2, 48, 48, 16, i=3))
    want = np.asarray(jops.flash_attention_bshd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=16, block_k=16))
    got = ops.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    assert tuple(got.shape) == q.shape
    assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

def ssd_inputs(B, S, nh, hd, ds, i=0):
    r = gen(10 + i)
    x = (r.standard_normal((B, S, nh * hd)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, S, nh)))).astype(np.float32)
    Bm = (r.standard_normal((B, S, ds)) * 0.5).astype(np.float32)
    Cm = (r.standard_normal((B, S, ds)) * 0.5).astype(np.float32)
    A = (-np.exp(r.standard_normal(nh) * 0.3)).astype(np.float32)
    return x, dt, Bm, Cm, A


@pytest.mark.parametrize("shape", [
    # B, S, nh, hd, ds, chunk
    (1, 36, 2, 8, 8, 12),        # chunk not a power of two
    (2, 30, 4, 8, 16, 10),
    (1, 40, 2, 16, 16, 40),      # one chunk
], ids=["chunk12", "chunk10_b2", "one_chunk"])
def test_ssd_scan_ref_matches_pallas(shape):
    B, S, nh, hd, ds, chunk = shape
    arrs = ssd_inputs(B, S, nh, hd, ds)
    wy, wh = jops.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk)
    gy, gh = ops.ssd_scan(*map(torch.from_numpy, arrs), chunk=chunk)
    assert_allclose(gy.numpy(), np.asarray(wy), rtol=F32_TOL, atol=F32_TOL)
    assert_allclose(gh.numpy(), np.asarray(wh), rtol=F32_TOL, atol=F32_TOL)


def test_ssd_scan_h0_chaining_matches_pallas():
    """A 24-position head (chunk 12) then a 7-position tail (chunk 7)
    chained through h0, against the Pallas kernel on the whole sequence
    cut the same way."""
    arrs = ssd_inputs(1, 31, 2, 8, 8, i=1)
    head = [a[:, :24] for a in arrs[:4]] + [arrs[4]]
    tail = [a[:, 24:] for a in arrs[:4]] + [arrs[4]]
    jy1, jh1 = jops.ssd_scan(*map(jnp.asarray, head), chunk=12)
    jy2, jh2 = jops.ssd_scan(*map(jnp.asarray, tail), chunk=7, h0=jh1)
    ty1, th1 = ops.ssd_scan(*map(torch.from_numpy, head), chunk=12)
    ty2, th2 = ops.ssd_scan(*map(torch.from_numpy, tail), chunk=7, h0=th1)
    got = torch.cat([ty1, ty2], 1).numpy()
    assert_allclose(got, np.concatenate([jy1, jy2], 1), rtol=F32_TOL,
                    atol=F32_TOL)
    assert_allclose(th2.numpy(), np.asarray(jh2), rtol=F32_TOL, atol=F32_TOL)
    # and the chain equals one pass over the whole sequence
    wy, wh = ops.ssd_scan(*map(torch.from_numpy, arrs), chunk=31)
    assert_allclose(got, wy.numpy(), rtol=F32_TOL, atol=F32_TOL)
    assert_allclose(th2.numpy(), wh.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_ssd_scan_ref_keeps_the_kernel_contract():
    arrs = [torch.from_numpy(a) for a in ssd_inputs(1, 30, 2, 8, 8)]
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.ssd_scan_ref(*arrs, chunk=8)
    y, h = ref.ssd_scan_ref(arrs[0].to(torch.bfloat16), *arrs[1:], chunk=10)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
