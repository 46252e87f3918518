"""The SSD-scan backward kernel's algorithm, emulated on the CPU.

``csrc/ssd_scan_bwd.cu`` computes the gradient of the chunked SSD scan
from the forward's chunk-start states and its within-chunk cumsum of
dt * A, in eight launches:

  0. the within-chunk cumsum of dt * A again, in double, once per (batch,
     chunk, head);
  1. C.B^T of each chunk (shared by the heads);
  2. per (chunk, head) D_c = sum_q e_q C_q (x) dy_q, e_q = exp(cum_q);
  3. the reverse state pass over the chunks: g starts at dh_final (or 0),
     each chunk's g (the gradient of its end state) replaces its D_c, and
     g <- exp(cum_last) g + D_c; what reaches chunk 0 is dh0;
  4. per (query tile, group of heads), the heads in order: e_q <dy_q,
     C_q h_c> from the product C_q . h_c, and dC's state term sum over
     (head, e) of e_q dy_q[e] h_c[., e] into the group's share;
  5. per (key tile, group of heads), the heads in order:
     du_k = r_k (B_k . g) + sum_{q>=k} G[q,k] dy_q with G = (C B^T) o L,
     L[q,k] = exp(cum_q - cum_k) selected to 0 above the diagonal,
     r_k = exp(cum_last - cum_k); dx = dt du, ddt gets <x, du>;
     T_k = <u_k, r_k (B_k . g)> (u = dt x, as staged: hi + lo); dB's
     state term sum over
     (head, e) of r_k u_k[e] g[., e]; and dG = dy u^T formed once per
     (head, query tile), dCB_h = dG o L summed over the group's heads, and
     M = dCB_h o (C B^T), whose row sums (by key tile) and column sums are
     taken from the same bits of each entry, k < q;
  6. per (chunk, head) d cum (rows - columns of M, the state terms, at the
     last position e_last <h_c, g> + sum_k T_k), its reverse cumsum dla,
     ddt += A dla, and this chunk's share of dA, sum dla dt;
  7. dCB summed over the groups in order, dB_k = sum_q dCB[q,k] C_q and
     dC_q = sum_k dCB[q,k] B_k plus the groups' state terms; dA summed
     over batch and chunks in order (no atomics anywhere).

Every product runs on the tensor cores as mma.sync m16n8k8 in TF32 with
each operand split into hi = tf32(v) and lo = tf32(v - hi), issued per
8-deep step as lo.hi, hi.lo, hi.hi into a float32 accumulator.  The
emulation repeats that decomposition, its 64-row tiles, its groups of
heads (``ssd_scan.head_groups``), its fixed-order sums and that rounding
(``tf32`` of ``tests/test_torch_ssd_split.py``, the forward's emulation) in
PyTorch, float32, and is held to autograd through the port's
``ref.ssd_scan_ref`` and to ``jax.vjp`` of the JAX package's
``repro.kernels.ref.ssd_scan_ref`` on the same inputs (made with numpy from
a seed): chunks of 16 and of sizes that are no multiple of 64, head_dim and
d_state of 16 and 64, h0 and dh_final each present and absent, a ragged
tail chained through h0 as ``ssd_prefill`` calls it, and a decay so strong
(dt * A near -30 within a chunk) that exp(cum_q - cum_k) above the
diagonal overflows.  Tolerance: max |err| <= 1e-4 x max |g| for each
gradient (the same float32 function summed in another order: chunk by
chunk and tile by tile here, token by token there).  Two cases show why
the design is as it is: with large terms that cancel, one TF32 pass breaks
the bound and the split keeps it; and under strong decay at chunk 256, M's
row and column sums taken from two products rounded apart (dG, and the
transposed u dy^T issued pass by pass) break dA's bound, which the shared
bits keep.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.ssd_scan import head_groups
from test_torch_ssd_split import cancelling_inputs, tf32

TOL = 1e-4
TILE = 64
NAMES = ("dx", "ddt", "dB", "dC", "dA", "dh0")


def forward_states(x, dt, B, C, A, h0, chunk):
    """What the forward kernel keeps for the backward: the within-chunk
    cumsum of dt * A (Bsz, nh, S) and each chunk's starting state (Bsz,
    nc, nh, ds, hd)."""
    Bsz, S, dih = x.shape
    nh, ds = dt.shape[-1], B.shape[-1]
    hd, nc = dih // nh, S // chunk
    cum = (dt * A).reshape(Bsz, nc, chunk, nh).cumsum(2)
    cum = cum.permute(0, 3, 1, 2).reshape(Bsz, nh, S)
    xs = x.reshape(Bsz, S, nh, hd)
    h = torch.zeros(Bsz, nh, ds, hd) if h0 is None else h0.clone()
    states = torch.zeros(Bsz, nc, nh, ds, hd)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        a = cum[:, :, sl]                                   # (Bsz, nh, Q)
        w = torch.exp(a[:, :, -1:] - a) * dt[:, sl].transpose(1, 2)
        states[:, c] = h
        own = torch.einsum("bqs,bhq,bqhe->bhse", B[:, sl], w, xs[:, sl])
        h = torch.exp(a[:, :, -1])[..., None, None] * h + own
    return cum, states


def mma(a, b, split=True, by_step=True):
    """a @ b as the kernels' tensor-core products form it: per 8-deep step
    of the depth, lo(a).hi(b), hi(a).lo(b), hi(a).hi(b) into a float32
    accumulator (split), or hi(a).hi(b) alone (one TF32 pass).
    ``by_step=False`` issues the same passes pass by pass over the whole
    depth instead, as a product laid out otherwise might: the same
    function, each entry rounded apart."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    passes = ((al, bh), (ah, bl), (ah, bh)) if split else ((ah, bh),)
    steps = [slice(k, k + 8) for k in range(0, a.shape[1], 8)]
    order = ([(s, p) for s in steps for p in passes] if by_step
             else [(s, p) for p in passes for s in steps])
    acc = torch.zeros(a.shape[0], b.shape[1])
    for s, (x, y) in order:
        acc = acc + x[:, s] @ y[s]
    return acc


def tile(t, r0, limit):
    """Rows [r0, r0 + 64) of a 2-D tensor, zeros past ``limit``."""
    out = torch.zeros((TILE, t.shape[1]), dtype=t.dtype)
    n = max(0, min(limit, r0 + TILE) - r0)
    out[:n] = t[r0:r0 + n]
    return out


def vec(t, r0, limit):
    """The same for a 1-D tensor."""
    return tile(t[:, None], r0, limit)[:, 0]


def padded(t, chunk):
    """A chunk's rows in whole 64-row tiles, zeros past ``chunk``."""
    return torch.cat([tile(t, r0, chunk) for r0 in range(0, chunk, TILE)])


def below(q0, k0):
    """k < q within one (query tile, key tile): the pairs whose M terms
    reach d cum (the diagonal's cancel, and are left out)"""
    return (torch.arange(k0, k0 + TILE)[None, :]
            < torch.arange(q0, q0 + TILE)[:, None])


def chunk_cum(dt, a):
    """A chunk's cumsum of dt * a, summed in float64 as the first kernel
    sums it: exponents are differences of cums, which float32 would carry
    at |cum| x 2^-24 of absolute error."""
    return (dt.double() * float(a)).cumsum(0)


def decay(a64, q0, k0, chunk):
    """L of one (query tile, key tile) from the chunk's float64 cum:
    exp(cum_q - cum_k) rounded to float32 where k <= q < chunk, selected
    (never multiplied) to 0 elsewhere."""
    qi = torch.arange(q0, q0 + TILE)[:, None]
    kj = torch.arange(k0, k0 + TILE)[None, :]
    keep = (kj <= qi) & (qi < chunk)
    c = torch.zeros(max(chunk, q0 + TILE, k0 + TILE), dtype=torch.float64)
    c[:chunk] = a64
    diff = c[q0:q0 + TILE][:, None] - c[k0:k0 + TILE][None, :]
    return torch.where(keep, torch.exp(torch.where(
        keep, diff, torch.tensor(0.0, dtype=torch.float64)).float()),
        torch.tensor(0.0))


def emulate_backward(x, dt, B, C, A, h0, states, cum, dy, dh_final, chunk,
                     split=True, shared_bits=True, groups=None):
    """(dx, ddt, dB, dC, dA, dh0) as the kernels compute them; dh0 is None
    when h0 is.  ``split=False``: every product in one TF32 pass;
    ``shared_bits=False``: M's column sums from a second product of dG,
    the transposed u dy^T issued pass by pass, each entry rounded apart
    from the row sums'.  ``groups``: of heads, as the caller passes them to
    the kernel (``head_groups`` unless given)."""
    Bsz, S, dih = x.shape
    nh, ds = dt.shape[-1], B.shape[-1]
    hd, nc = dih // nh, S // chunk
    n_t = -(-chunk // TILE)
    qp = n_t * TILE
    groups = groups or head_groups(nh)
    per = -(-nh // groups)
    mm = lambda a, b: mma(a, b.contiguous(), split)
    zero = torch.tensor(0.0)
    xs, dys = x.reshape(Bsz, S, nh, hd), dy.reshape(Bsz, S, nh, hd)
    dx = torch.zeros(Bsz, S, nh, hd)
    ddt = torch.zeros(Bsz, S, nh)
    dB = torch.zeros(Bsz, S, ds)
    dC = torch.zeros(Bsz, S, ds)
    dA_part = torch.zeros(Bsz, nc, nh)
    g_end = torch.zeros(Bsz, nc, nh, ds, hd)
    dh0 = None if h0 is None else torch.zeros(Bsz, nh, ds, hd)
    # 0. the cumsum in double
    a64 = torch.zeros(Bsz, nc, nh, chunk, dtype=torch.float64)
    for b in range(Bsz):
        for c in range(nc):
            for h in range(nh):
                a64[b, c, h] = chunk_cum(dt[b, c * chunk:(c + 1) * chunk, h],
                                         A[h])
    # 2.-3. D_c, then the reverse state pass
    for b in range(Bsz):
        for h in range(nh):
            g = (torch.zeros(ds, hd) if dh_final is None
                 else dh_final[b, h].clone())
            for c in reversed(range(nc)):
                sl = slice(c * chunk, (c + 1) * chunk)
                e = padded(torch.exp(a64[b, c, h].float())[:, None],
                           chunk)[:, 0]
                D = mm((padded(C[b, sl], chunk) * e[:, None]).T,
                       padded(dys[b, sl, h], chunk))
                g_end[b, c, h] = g
                g = torch.exp(cum[b, h, c * chunk + chunk - 1]) * g + D
            if dh0 is not None:
                dh0[b, h] = g
    for b in range(Bsz):
        for c in range(nc):
            r0 = c * chunk
            sl = slice(r0, r0 + chunk)
            Cc, Bc = padded(C[b, sl], chunk), padded(B[b, sl], chunk)
            # 1. C.B^T, tiles at or below the diagonal
            cb = torch.zeros(qp, qp)
            for qt in range(n_t):
                for kt in range(qt + 1):
                    q0, k0 = qt * TILE, kt * TILE
                    cb[q0:q0 + TILE, k0:k0 + TILE] = mm(
                        Cc[q0:q0 + TILE], Bc[k0:k0 + TILE].T)
            # 4. query tiles: e_q <dy_q, C_q h_c>, dC's state term by group
            R = torch.zeros(nh, qp)
            dCs = torch.zeros(groups, qp, ds)
            for qt in range(n_t):
                q0 = qt * TILE
                Cq = Cc[q0:q0 + TILE]
                for h in range(nh):
                    hc = states[b, c, h]
                    dyq = tile(dys[b, sl, h], q0, chunk)
                    e = torch.where(torch.arange(q0, q0 + TILE) < chunk,
                                    torch.exp(vec(a64[b, c, h], q0, chunk)
                                              .float()), zero)
                    R[h, q0:q0 + TILE] = e * (dyq * mm(Cq, hc)).sum(1)
                    dCs[h // per, q0:q0 + TILE] += e[:, None] * mm(dyq, hc.T)
            # 5. key tiles: du, T, dB's state term, dG once, dCB, M
            dCBp = torch.zeros(groups, qp, qp)
            dBs = torch.zeros(groups, qp, ds)
            rowp = torch.zeros(nh, n_t, qp)
            col = torch.zeros(nh, qp)
            T = torch.zeros(nh, qp)
            for kt in range(n_t):
                k0 = kt * TILE
                Bk = Bc[k0:k0 + TILE]
                for h in range(nh):
                    a = a64[b, c, h]
                    r = torch.where(torch.arange(k0, k0 + TILE) < chunk,
                                    torch.exp((a[-1] - vec(a, k0, chunk))
                                              .float()), zero)
                    dtc = dt[b, sl, h]
                    xk = tile(xs[b, sl, h], k0, chunk)
                    uk = xk * vec(dtc, k0, chunk)[:, None]
                    g = g_end[b, c, h]
                    du = mm(Bk, g) * r[:, None]
                    # T from u as staged: hi + lo
                    us = tf32(uk) + tf32(uk - tf32(uk))
                    T[h, k0:k0 + TILE] = (us * du).sum(1)
                    dBs[h // per, k0:k0 + TILE] += mm(uk, g.T) * r[:, None]
                    colk = torch.zeros(TILE)
                    for qt in range(kt, n_t):
                        q0 = qt * TILE
                        L = decay(a, q0, k0, chunk)
                        CB = cb[q0:q0 + TILE, k0:k0 + TILE]
                        dyq = tile(dys[b, sl, h], q0, chunk)
                        dCBh = mm(dyq, uk.T) * L
                        M = dCBh * CB
                        Mc = M if shared_bits else (mma(
                            uk, dyq.T.contiguous(), split,
                            by_step=False).T * L) * CB
                        keep = below(q0, k0)
                        rowp[h, kt, q0:q0 + TILE] = torch.where(
                            keep, M, zero).sum(1)
                        colk += torch.where(keep, Mc, zero).sum(0)
                        dCBp[h // per, q0:q0 + TILE, k0:k0 + TILE] += dCBh
                        du += mm((CB * L).T, dyq)
                    n = min(TILE, chunk - k0)
                    rows = slice(r0 + k0, r0 + k0 + n)
                    dx[b, rows, h] = (du * vec(dtc, k0, chunk)[:, None])[:n]
                    ddt[b, rows, h] = (xk * du).sum(1)[:n]
                    col[h, k0:k0 + TILE] = colk
            # 6. d cum by position, its reverse cumsum, plus the exclusive
            # cumsum of T and e_last <h_c, g>
            for h in range(nh):
                hg = torch.exp(a64[b, c, h, -1].float()) * (
                    states[b, c, h] * g_end[b, c, h]).sum()
                da = (-col[h] + R[h])[:chunk]
                for kt in range(n_t):
                    da = da + rowp[h, kt, :chunk]
                Th = T[h, :chunk]
                dla = (Th.cumsum(0) - Th + hg) + da.flip(0).cumsum(0).flip(0)
                ddt[b, sl, h] += A[h] * dla
                dA_part[b, c, h] = (dla * dt[b, sl, h]).sum()
            # 7. dCB and the state terms summed over the groups in order,
            # then dB and dC
            dCB, dBsum, dCsum = dCBp[0].clone(), dBs[0].clone(), dCs[0].clone()
            for grp in range(1, groups):
                dCB += dCBp[grp]
                dBsum += dBs[grp]
                dCsum += dCs[grp]
            for t in range(n_t):
                t0 = t * TILE
                accB = torch.zeros(TILE, ds)
                for qt in range(t, n_t):
                    q0 = qt * TILE
                    accB += mm(dCB[q0:q0 + TILE, t0:t0 + TILE].T,
                               Cc[q0:q0 + TILE])
                accC = torch.zeros(TILE, ds)
                for kt in range(t + 1):
                    k0 = kt * TILE
                    accC += mm(dCB[t0:t0 + TILE, k0:k0 + TILE],
                               Bc[k0:k0 + TILE])
                n = min(TILE, chunk - t0)
                dB[b, r0 + t0:r0 + t0 + n] = (accB + dBsum[t0:t0 + TILE])[:n]
                dC[b, r0 + t0:r0 + t0 + n] = (accC + dCsum[t0:t0 + TILE])[:n]
    dA = torch.zeros(nh)
    for b in range(Bsz):
        for c in range(nc):
            dA += dA_part[b, c]
    return dx.reshape(Bsz, S, dih), ddt, dB, dC, dA, dh0


def inputs(Bsz, S, nh, hd, ds, *, h0, dh_final, seed=0, a_scale=0.3,
           a_mult=1.0):
    """x, dt, B, C, A, h0, dy, dh_final as numpy float32 (h0 / dh_final
    None where absent)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, B, C = f(Bsz, S, nh * hd) * 0.5, f(Bsz, S, ds) * 0.5, \
        f(Bsz, S, ds) * 0.5
    dt = np.log1p(np.exp(f(Bsz, S, nh))).astype(np.float32)
    A = (-np.exp(f(nh) * a_scale) * a_mult).astype(np.float32)
    dy = f(Bsz, S, nh * hd)
    return (x, dt, B, C, A, f(Bsz, nh, ds, hd) if h0 else None, dy,
            f(Bsz, nh, ds, hd) if dh_final else None)


def as_torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def plain_grads(x, dt, B, C, A, h0, dy, dh_final, chunk):
    """Autograd through the port's token-by-token ``ref.ssd_scan_ref``."""
    xs = [t.clone().requires_grad_(True) for t in (x, dt, B, C, A)]
    h0r = None if h0 is None else h0.clone().requires_grad_(True)
    y, h = ref.ssd_scan_ref(*xs, chunk=chunk, h0=h0r)
    outs, grads = [y], [dy]
    if dh_final is not None:
        outs, grads = [y, h], [dy, dh_final]
    wrt = xs + ([] if h0r is None else [h0r])
    got = torch.autograd.grad(outs, wrt, grads)
    return (*got[:5], None if h0r is None else got[5])


def jax_grads(x, dt, B, C, A, h0, dy, dh_final, chunk):
    """``jax.vjp`` of the JAX package's ``ssd_scan_ref``."""
    if h0 is None:
        f = lambda *a: jref.ssd_scan_ref(*a, chunk=chunk)
        args = (x, dt, B, C, A)
    else:
        f = lambda *a: jref.ssd_scan_ref(*a[:5], chunk=chunk, h0=a[5])
        args = (x, dt, B, C, A, h0)
    (y, h), vjp = jax.vjp(f, *map(jnp.asarray, args))
    dh = np.zeros(h.shape, np.float32) if dh_final is None else dh_final
    got = [torch.from_numpy(np.asarray(g)) for g in
           vjp((jnp.asarray(dy), jnp.asarray(dh)))]
    return (*got[:5], got[5] if h0 is not None else None)


def emulate(x, dt, B, C, A, h0, dy, dh_final, chunk, **kw):
    cum, states = forward_states(x, dt, B, C, A, h0, chunk)
    return emulate_backward(x, dt, B, C, A, h0, states, cum, dy, dh_final,
                            chunk, **kw)


def worst(got, want):
    """The largest max |err| / (TOL x max |want|) over the gradients, and
    its gradient's name."""
    shares = {}
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert torch.isfinite(g).all(), name
        shares[name] = ((g - w).abs().max() / (TOL * w.abs().max())).item()
    name = max(shares, key=shares.get)
    return shares[name], name


def assert_close(got, want):
    share, name = worst(got, want)
    assert share <= 1.0, (name, share)


CASES = [
    # (Bsz, S, nh, hd, ds, chunk, h0, dh_final)
    (1, 64, 2, 16, 16, 16, False, False),
    (2, 96, 2, 16, 64, 16, True, True),
    (1, 200, 2, 64, 16, 100, True, False),
    (1, 232, 2, 64, 64, 232, False, True),
    (2, 256, 3, 64, 64, 128, True, True),
    (1, 140, 2, 16, 16, 70, False, False),
]
IDS = ["chunk16", "chunk16_b2_h0_dh", "chunk100_h0", "chunk232_dh",
       "chunk128_b2_h0_dh", "chunk70"]


@pytest.mark.parametrize("Bsz,S,nh,hd,ds,chunk,h0,dh", CASES, ids=IDS)
def test_emulated_backward_matches_autograd(Bsz, S, nh, hd, ds, chunk, h0,
                                            dh):
    args = as_torch(inputs(Bsz, S, nh, hd, ds, h0=h0, dh_final=dh,
                           seed=chunk))
    assert_close(emulate(*args, chunk), plain_grads(*args, chunk))


@pytest.mark.parametrize("Bsz,S,nh,hd,ds,chunk,h0,dh", CASES[:4],
                         ids=IDS[:4])
def test_emulated_backward_matches_jax_vjp(Bsz, S, nh, hd, ds, chunk, h0,
                                           dh):
    arrays = inputs(Bsz, S, nh, hd, ds, h0=h0, dh_final=dh, seed=chunk + 1)
    assert_close(emulate(*as_torch(arrays), chunk),
                 jax_grads(*arrays, chunk))


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_groups_of_heads_match_autograd(groups):
    """Three heads in one group, in groups of two and one, and one a
    group: dCB and the state terms of dB and dC summed over a group's
    heads in order, then over the groups in order."""
    args = as_torch(inputs(2, 256, 3, 64, 64, h0=True, dh_final=True,
                           seed=groups))
    assert_close(emulate(*args, 128, groups=groups), plain_grads(*args, 128))


@pytest.mark.parametrize("groups", [2, 4])
def test_ragged_groups_of_heads_match_autograd(groups):
    """Five heads in groups of ceil(5 / groups): 3 + 2, and 2 + 2 + 1 with
    a fourth group that holds no head and adds zeros."""
    args = as_torch(inputs(2, 256, 5, 32, 32, h0=True, dh_final=True,
                           seed=groups + 10))
    assert_close(emulate(*args, 128, groups=groups), plain_grads(*args, 128))


@pytest.mark.parametrize("tail", [1, 37, 100])
def test_chained_tail_matches_autograd(tail):
    """A 256-position call in chunks of 128, then a ragged tail as one
    chunk of its own started from the first call's final state, as
    ``ssd_prefill`` chains it: the tail's dh0 is the first call's
    dh_final."""
    S = 256
    x, dt, B, C, A, _, dy, _ = as_torch(inputs(1, S + tail, 2, 16, 64,
                                               h0=False, dh_final=False,
                                               seed=tail))
    head = (x[:, :S], dt[:, :S], B[:, :S], C[:, :S], A)
    tail_in = (x[:, S:], dt[:, S:], B[:, S:], C[:, S:], A)
    cum1, st1 = forward_states(*head, None, 128)
    h1 = ref.ssd_scan_ref(*head, chunk=128)[1]
    cum2, st2 = forward_states(*tail_in, h1, tail)
    g2 = emulate_backward(*tail_in, h1, st2, cum2, dy[:, S:], None, tail)
    g1 = emulate_backward(*head, None, st1, cum1, dy[:, :S], g2[5], 128)
    got = (torch.cat([g1[0], g2[0]], 1), torch.cat([g1[1], g2[1]], 1),
           torch.cat([g1[2], g2[2]], 1), torch.cat([g1[3], g2[3]], 1),
           g1[4] + g2[4], None)
    assert_close(got, plain_grads(x, dt, B, C, A, None, dy, None, 1))


@pytest.mark.parametrize("hd,ds", [(16, 16), (64, 64)])
def test_strong_decay_gives_no_nan(hd, ds):
    """dt * A near -30 a position (A = -40): exp(cum_q - cum_k) above the
    diagonal would overflow and 0 x inf is NaN, so L is selected, not
    masked."""
    args = as_torch(inputs(1, 128, 2, hd, ds, h0=True, dh_final=True,
                           seed=hd, a_scale=0.0, a_mult=40.0))
    cum, _ = forward_states(*args[:6], 64)
    assert cum.min() < -1000.0
    got = emulate(*args, 64)
    assert all(torch.isfinite(g).all() for g in got)
    assert_close(got, plain_grads(*args, 64))


def test_cancelling_terms_need_the_split():
    """B and C whose first two components are large and cancel in C.B
    (``cancelling_inputs`` of the forward's emulation): one TF32 pass of
    every product leaves the gradients far outside 1e-4 x max |g|; the hi/lo
    split keeps every one inside."""
    x, dt, Bm, Cm, A = cancelling_inputs()
    dy = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    args = as_torch([x, dt, Bm, Cm, A, None, dy, None])
    want = plain_grads(*args, 16)
    assert_close(emulate(*args, 16), want)
    assert worst(emulate(*args, 16, split=False), want)[0] > 1.0


def test_shared_bits_keep_dA_under_strong_decay():
    """A x 40 at chunk 256: M's row sums and column sums taken from the same
    bits of each entry keep dA within 1e-4 x max |dA|; the column sums from
    a second product of dG (the transposed u dy^T, its passes issued pass
    by pass, so each entry is rounded apart from the row sums') break dA's
    bound, by more than 10x."""
    args = as_torch(inputs(1, 256, 2, 64, 64, h0=True, dh_final=True,
                           seed=1, a_scale=0.0, a_mult=40.0))
    want = plain_grads(*args, 256)
    assert_close(emulate(*args, 256), want)
    share, name = worst(emulate(*args, 256, shared_bits=False), want)
    assert (name, share > 10.0) == ("dA", True)
