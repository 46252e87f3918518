"""The SSD kernel's arithmetic, emulated on the CPU.

The chunk-parallel kernel (``csrc/ssd_scan.cu``) computes, per chunk: C.Bᵀ
once for all heads; per head the within-chunk cumsum of dt·A, the chunk's
own end state Bᵀ·(exp(cum_last - cum)·dt·x); then the state passing over
the chunks, h = exp(cum_last)·h + S_c; then the outputs from the chunk's
starting state plus the masked diagonal, y = exp(cum_q)·C·h_start +
(C·Bᵀ ∘ L)·(dt·x), with L = exp(cum_q - cum_k) selected to 0 above the
diagonal.  Its three products run on the tensor cores in TF32 with every
operand split into hi = tf32(v) and lo = tf32(v - hi), both rounded to
nearest (10 mantissa bits), and issued as lo·hi + hi·lo + hi·hi.  The bf16
path stages x, B and C to float32 and takes the same products (bf16 values
are exact in TF32, so their lo parts are 0).

The emulation below repeats those phases and that rounding in PyTorch and
is held to the plain version ``ref.ssd_scan_ref`` and to the JAX package's
Pallas kernel (interpreted on the CPU) under the card checks' bound:
3e-4 x max(1, max |y|) for y and likewise for h_final; bf16 y one bf16 step
more, elementwise.  Inputs are made with numpy from a seed.  One case is
built so that large terms cancel: there one TF32 pass breaks the bound and
the split keeps it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref

torch.set_num_threads(1)

SSD_TOL = 3e-4
BF16_STEP = 2.0 ** -7


def tf32(t):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def product(a, b, split=True):
    """a @ b in float32 from TF32 operands: lo·hi + hi·lo + hi·hi when
    split, else one pass hi·hi."""
    ah, bh = tf32(a), tf32(b)
    if not split:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def emulate(x, dt, B, C, A, *, chunk, h0=None, split=True):
    """The kernel's phases on (Bsz, S, nh*hd) x, (Bsz, S, nh) dt, (Bsz, S,
    ds) B/C, (nh,) A -> (y in x's dtype, h_final float32)."""
    Bsz, S, dih = x.shape
    nh = dt.shape[-1]
    hd, ds = dih // nh, B.shape[-1]
    xf = x.float().reshape(Bsz, S, nh, hd)
    Bf, Cf, dtf = B.float(), C.float(), dt.float()
    h = (torch.zeros((Bsz, nh, ds, hd)) if h0 is None else h0.float())
    y = torch.empty((Bsz, S, nh, hd))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        Bc, Cc = Bf[:, sl], Cf[:, sl]                      # (Bsz, Q, ds)
        cb = product(Cc, Bc.transpose(1, 2), split)        # once per chunk
        cum = torch.cumsum(dtf[:, sl] * A.float(), dim=1)  # (Bsz, Q, nh)
        last = cum[:, -1]                                  # (Bsz, nh)
        # the chunk's own end state, then the state passing
        w = torch.exp(last[:, None] - cum) * dtf[:, sl]    # (Bsz, Q, nh)
        wx = (w[..., None] * xf[:, sl]).permute(0, 2, 1, 3)
        s_c = product(Bc.transpose(1, 2)[:, None], wx, split)
        start = h
        h = h * torch.exp(last)[..., None, None] + s_c
        # outputs: carried term, then the masked diagonal (selected)
        diff = (cum[:, :, None, :] - cum[:, None, :, :]).permute(0, 3, 1, 2)
        L = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
        P = cb[:, None] * L                                # (Bsz, nh, Q, Q)
        xdt = (xf[:, sl] * dtf[:, sl, :, None]).permute(0, 2, 1, 3)
        y_off = product(Cc[:, None], start, split) \
            * torch.exp(cum).permute(0, 2, 1)[..., None]
        y[:, sl] = (y_off + product(P, xdt, split)).permute(0, 2, 1, 3)
    return y.reshape(Bsz, S, dih).to(x.dtype), h


def inputs(Bsz, S, nh, hd, ds, *, seed=0, decay=0.3, a_shift=0.0):
    """numpy inputs from a seed: A = -exp(N(a_shift, decay²))."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((Bsz, S, nh * hd)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((Bsz, S, nh)))).astype(np.float32)
    Bm = (r.standard_normal((Bsz, S, ds)) * 0.5).astype(np.float32)
    Cm = (r.standard_normal((Bsz, S, ds)) * 0.5).astype(np.float32)
    A = (-np.exp(a_shift + r.standard_normal(nh) * decay)).astype(np.float32)
    return x, dt, Bm, Cm, A


def excess(got, want, step=0.0):
    """Largest |got - want| / (step |want| + 3e-4 x max(1, max |want|)):
    at most 1 within the bound."""
    got, want = got.float(), want.float()
    scale = SSD_TOL * max(1.0, want.abs().max().item())
    return ((got - want).abs() / (step * want.abs() + scale)).max().item()


def pallas(arrs, chunk, h0=None):
    y, h = jops.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk,
                         h0=None if h0 is None else jnp.asarray(h0))
    return torch.from_numpy(np.array(y)), torch.from_numpy(np.array(h))


CASES = [
    # (Bsz, S, nh, hd, ds, chunk), inputs' keywords
    ((1, 96, 2, 16, 16, 16), {}),
    ((1, 96, 3, 32, 16, 12), {}),
    ((1, 98, 4, 16, 32, 7), {}),
    ((2, 64, 2, 16, 32, 16), {}),                        # batch 2
    ((1, 64, 2, 16, 16, 16), dict(a_shift=3.0)),          # strong decay
    ((1, 64, 2, 32, 16, 32), dict(a_shift=-9.0)),         # weak decay
]


@pytest.mark.parametrize("shape,kw", CASES,
                         ids=["chunk16", "chunk12", "chunk7", "batch2",
                              "strong_decay", "weak_decay"])
def test_split_emulation_matches_plain_and_pallas(shape, kw):
    Bsz, S, nh, hd, ds, chunk = shape
    arrs = inputs(Bsz, S, nh, hd, ds, seed=S + chunk, **kw)
    x, dt, Bm, Cm, A = map(torch.from_numpy, arrs)
    y, h = emulate(x, dt, Bm, Cm, A, chunk=chunk)
    wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=chunk)
    py, ph = pallas(arrs, chunk)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    for want_y, want_h in ((wy, wh), (py, ph)):
        assert excess(y, want_y) <= 1.0
        assert excess(h, want_h) <= 1.0


def test_strong_decay_underflows_and_stays_finite():
    """exp(cum_q - cum_k) underflows to 0 a few positions back, and
    exp(cum_k - cum_q) above the diagonal overflows: selected, never
    multiplied by a mask, so no inf·0."""
    arrs = inputs(1, 64, 2, 16, 16, seed=5, a_shift=3.0)
    x, dt, Bm, Cm, A = map(torch.from_numpy, arrs)
    cum = torch.cumsum(dt[0, :16] * A, 0)
    assert torch.exp(cum[-1] - cum[0]).min() == 0.0
    assert torch.isinf(torch.exp(cum[0] - cum[-1])).any()
    y, h = emulate(x, dt, Bm, Cm, A, chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()


def test_ragged_tail_chained_through_h0():
    """A 96-position head in chunks of 16, then a 13-position tail as one
    chunk of 13 through h0, against the recurrence over the whole 109."""
    arrs = inputs(1, 109, 2, 16, 32, seed=7)
    x, dt, Bm, Cm, A = map(torch.from_numpy, arrs)
    y1, h1 = emulate(x[:, :96], dt[:, :96], Bm[:, :96], Cm[:, :96], A,
                     chunk=16)
    y2, h2 = emulate(x[:, 96:], dt[:, 96:], Bm[:, 96:], Cm[:, 96:], A,
                     chunk=13, h0=h1)
    wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=1)
    assert excess(torch.cat([y1, y2], 1), wy) <= 1.0
    assert excess(h2, wh) <= 1.0
    head = [a[:, :96] for a in arrs[:4]] + [arrs[4]]
    tail = [a[:, 96:] for a in arrs[:4]] + [arrs[4]]
    py1, ph1 = pallas(head, 16)
    py2, ph2 = pallas(tail, 13, h0=ph1.numpy())
    assert excess(torch.cat([y1, y2], 1), torch.cat([py1, py2], 1)) <= 1.0
    assert excess(h2, ph2) <= 1.0


def test_bf16_inputs_within_one_bf16_step():
    """bf16 x, B, C: y in bf16 within one bf16 step plus the float32
    bound of the plain version on the same bf16 inputs; h to 3e-4."""
    arrs = inputs(1, 64, 2, 32, 16, seed=11)
    x, dt, Bm, Cm, A = map(torch.from_numpy, arrs)
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    y, h = emulate(xb, dt, Bb, Cb, A, chunk=16)
    wy, wh = ref.ssd_scan_ref(xb, dt, Bb, Cb, A, chunk=16)
    assert y.dtype == torch.bfloat16
    assert excess(y, wy, BF16_STEP) <= 1.0
    assert excess(h, wh) <= 1.0
    # the bf16 operands are exact in TF32: their lo parts are 0
    assert torch.equal(tf32(xb.float()), xb.float())


def cancelling_inputs(seed=13, S=64, nh=2, hd=16, ds=16, big=8.0):
    """B and C whose first two components are large and cancel in C·B:
    C[q, 0:2] = (a_q, a_q + d_q), B[k, 0:2] = (b_k, -b_k), with a, b ~ big
    and d small, so each C·B term is ~big² while their sum is ~big·d.  The
    state's first two rows cancel the same way in C·h."""
    r = np.random.default_rng(seed)
    x, dt, Bm, Cm, A = inputs(1, S, nh, hd, ds, seed=seed)
    a = (big + r.random(S)).astype(np.float32)
    b = (big + r.random(S)).astype(np.float32)
    d = (r.standard_normal(S) * 0.01).astype(np.float32)
    Cm[0, :, 0], Cm[0, :, 1] = a, a + d
    Bm[0, :, 0], Bm[0, :, 1] = b, -b
    return x, dt, Bm, Cm, A


def test_cancelling_terms_need_the_split():
    """With large terms that cancel, one TF32 pass (11 bits an operand)
    leaves y far outside 3e-4 x max(1, max |y|); the hi/lo split keeps it
    inside, against the plain version and the Pallas kernel."""
    arrs = cancelling_inputs()
    x, dt, Bm, Cm, A = map(torch.from_numpy, arrs)
    wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=16)
    py, _ = pallas(arrs, 16)
    split, _ = emulate(x, dt, Bm, Cm, A, chunk=16)
    once, _ = emulate(x, dt, Bm, Cm, A, chunk=16, split=False)
    assert excess(split, wy) <= 1.0 and excess(split, py) <= 1.0
    assert excess(once, wy) > 1.0
