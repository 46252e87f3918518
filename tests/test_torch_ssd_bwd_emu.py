"""The SSD-scan backward kernel's algorithm, emulated on the CPU.

``csrc/ssd_scan_bwd.cu`` computes the gradient of the chunked SSD scan
from the forward's chunk-start states and its within-chunk cumsum of
dt * A, in seven launches:

  0. C.B^T of each chunk (shared by the heads);
  1. per (chunk, head) D_c = sum_q e_q C_q (x) dy_q, e_q = exp(cum_q);
  2. the reverse state pass over the chunks: g starts at dh_final (or 0),
     each chunk's g (the gradient of its end state) replaces its D_c, and
     g <- exp(cum_last) g + D_c; what reaches chunk 0 is dh0;
  3. per key tile: du_k = sum_{q>=k} G[q,k] dy_q + r_k (B_k . g) with
     G = (C B^T) o L, L[q,k] = exp(cum_q - cum_k) selected to 0 above the
     diagonal, r_k = exp(cum_last - cum_k); dx = dt du, ddt gets <x, du>;
     dG = dy u^T (u = dt x), dCB_h = dG o L, and this head's
     dB_k = sum_q dCB_h[q,k] C_q + r_k (g . u_k); column sums of
     M = dCB_h o (C B^T) and T_k = r_k <B_k (x) u_k, g> for d cum;
  4. per query tile: this head's dC_q = sum_k dCB_h[q,k] B_k
     + e_q (h_c . dy_q); row sums of M and e_q <dy_q, C_q h_c>; on the
     chunk's last tile e_last <h_c, g>;
  5. per (chunk, head) d cum (rows - columns of M, the state terms, at the
     last position e_last <h_c, g> + sum_k T_k), its reverse cumsum dla,
     ddt += A dla, and this chunk's share of dA, sum dla dt;
  6. dB and dC summed over the heads, dA over batch and chunks, in a fixed
     order (no atomics).

The emulation repeats that decomposition, its 64-row tiles and its
reduction order in PyTorch, float32, and is held to autograd through the
port's ``ref.ssd_scan_ref`` and to ``jax.vjp`` of the JAX package's
``repro.kernels.ref.ssd_scan_ref`` on the same inputs (made with numpy from
a seed): chunks of 16 and of sizes that are no multiple of 64, head_dim and
d_state of 16 and 64, h0 and dh_final each present and absent, a ragged
tail chained through h0 as ``ssd_prefill`` calls it, and a decay so strong
(dt * A near -30 within a chunk) that exp(cum_q - cum_k) above the
diagonal overflows.  Tolerance: max |err| <= 1e-4 x max |g| for each
gradient (the same float32 function summed in another order: chunk by
chunk and tile by tile here, token by token there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

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


def tile(t, r0, limit):
    """Rows [r0, r0 + 64) of a 2-D tensor, zeros past ``limit``."""
    out = torch.zeros((TILE, t.shape[1]), dtype=t.dtype)
    n = max(0, min(limit, r0 + TILE) - r0)
    out[:n] = t[r0:r0 + n]
    return out


def vec(t, r0, limit):
    """The same for a 1-D tensor."""
    return tile(t[:, None], r0, limit)[:, 0]


def below(q0, k0):
    """k < q within one (query tile, key tile): the pairs whose M terms
    reach d cum (the diagonal's cancel, and are left out)"""
    return (torch.arange(k0, k0 + TILE)[None, :]
            < torch.arange(q0, q0 + TILE)[:, None])


def chunk_cum(dt, a):
    """A chunk's cumsum of dt * a, summed in float64 as the kernels sum it
    (load_chunk): exponents are differences of cums, which float32 would
    carry at |cum| x 2^-24 of absolute error."""
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


def emulate_backward(x, dt, B, C, A, h0, states, cum, dy, dh_final, chunk):
    """(dx, ddt, dB, dC, dA, dh0) as the kernels compute them; dh0 is None
    when h0 is."""
    Bsz, S, dih = x.shape
    nh, ds = dt.shape[-1], B.shape[-1]
    hd, nc = dih // nh, S // chunk
    n_t = -(-chunk // TILE)
    xs, dys = x.reshape(Bsz, S, nh, hd), dy.reshape(Bsz, S, nh, hd)
    dx = torch.zeros(Bsz, S, nh, hd)
    ddt = torch.zeros(Bsz, S, nh)
    daK, daQ, Tk = (torch.zeros(Bsz, nh, S) for _ in range(3))
    hg = torch.zeros(Bsz, nc, nh)
    dB_h = torch.zeros(Bsz, nc, nh, chunk, ds)
    dC_h = torch.zeros(Bsz, nc, nh, chunk, ds)
    dA_part = torch.zeros(Bsz, nc, nh)
    g_end = torch.zeros(Bsz, nc, nh, ds, hd)
    dh0 = None if h0 is None else torch.zeros(Bsz, nh, ds, hd)
    for b in range(Bsz):
        for h in range(nh):
            # 1.-2. D_c, then the reverse state pass
            g = (torch.zeros(ds, hd) if dh_final is None
                 else dh_final[b, h].clone())
            for c in reversed(range(nc)):
                sl = slice(c * chunk, (c + 1) * chunk)
                e = torch.exp(chunk_cum(dt[b, sl, h], A[h]).float())
                D = (C[b, sl] * e[:, None]).T @ dys[b, sl, h]
                g_end[b, c, h] = g
                g = torch.exp(cum[b, h, c * chunk + chunk - 1]) * g + D
            if dh0 is not None:
                dh0[b, h] = g
    for b in range(Bsz):
        for c in range(nc):
            r0 = c * chunk
            Cc, Bc = C[b, r0:r0 + chunk], B[b, r0:r0 + chunk]
            for h in range(nh):
                a64 = chunk_cum(dt[b, r0:r0 + chunk, h], A[h])
                last = a64[-1]
                dtc = dt[b, r0:r0 + chunk, h]
                xc, dyc = xs[b, r0:r0 + chunk, h], dys[b, r0:r0 + chunk, h]
                u = xc * dtc[:, None]
                g, hc = g_end[b, c, h], states[b, c, h]
                # 3. key tiles
                for kt in range(n_t):
                    k0 = kt * TILE
                    r = torch.where(torch.arange(k0, k0 + TILE) < chunk,
                                    torch.exp((last - vec(a64, k0, chunk))
                                              .float()), torch.tensor(0.0))
                    Bk, uk = tile(Bc, k0, chunk), tile(u, k0, chunk)
                    du = (Bk @ g) * r[:, None]
                    dBk = (uk @ g.T) * r[:, None]
                    T = (Bk * dBk).sum(1)
                    col = torch.zeros(TILE)
                    for qt in range(kt, n_t):
                        q0 = qt * TILE
                        L = decay(a64, q0, k0, chunk)
                        CB = tile(Cc, q0, chunk) @ Bk.T
                        dyq = tile(dyc, q0, chunk)
                        du += (CB * L).T @ dyq
                        dCB = (dyq @ uk.T) * L
                        col += torch.where(below(q0, k0), dCB * CB,
                                           torch.tensor(0.0)).sum(0)
                        dBk += dCB.T @ tile(Cc, q0, chunk)
                    n = min(TILE, chunk - k0)
                    sl = slice(r0 + k0, r0 + k0 + n)
                    dx[b, sl, h] = (du * vec(dtc, k0, chunk)[:, None])[:n]
                    ddt[b, sl, h] = (tile(xc, k0, chunk) * du).sum(1)[:n]
                    dB_h[b, c, h, k0:k0 + n] = dBk[:n]
                    daK[b, h, sl] = -col[:n]
                    Tk[b, h, sl] = T[:n]
                # 4. query tiles
                for qt in range(n_t):
                    q0 = qt * TILE
                    e = torch.where(torch.arange(q0, q0 + TILE) < chunk,
                                    torch.exp(vec(a64, q0, chunk).float()),
                                    torch.tensor(0.0))
                    Cq, dyq = tile(Cc, q0, chunk), tile(dyc, q0, chunk)
                    dCq = (dyq @ hc.T) * e[:, None]
                    R = (Cq * dCq).sum(1)
                    row = torch.zeros(TILE)
                    for kt in range(qt + 1):
                        k0 = kt * TILE
                        L = decay(a64, q0, k0, chunk)
                        Bk = tile(Bc, k0, chunk)
                        CB = Cq @ Bk.T
                        dCB = (dyq @ tile(u, k0, chunk).T) * L
                        row += torch.where(below(q0, k0), dCB * CB,
                                           torch.tensor(0.0)).sum(1)
                        dCq += dCB @ Bk
                    n = min(TILE, chunk - q0)
                    dC_h[b, c, h, q0:q0 + n] = dCq[:n]
                    daQ[b, h, r0 + q0:r0 + q0 + n] = (row + R)[:n]
                    if q0 + TILE >= chunk:
                        hg[b, c, h] = torch.exp(last.float()) * (hc * g).sum()
                # 5. d cum by position, its reverse cumsum, plus the
                # exclusive cumsum of T and e_last <h_c, g>
                sl = slice(r0, r0 + chunk)
                da = daK[b, h, sl] + daQ[b, h, sl]
                dla = (da.flip(0).cumsum(0).flip(0) + Tk[b, h, sl].cumsum(0)
                       - Tk[b, h, sl] + hg[b, c, h])
                ddt[b, sl, h] += A[h] * dla
                dA_part[b, c, h] = (dla * dtc).sum()
    # 6. fixed-order sums over the heads, and over batch and chunks
    dB = torch.zeros(Bsz, S, ds)
    dC = torch.zeros(Bsz, S, ds)
    for h in range(nh):
        dB += dB_h[:, :, h].reshape(Bsz, S, ds)
        dC += dC_h[:, :, h].reshape(Bsz, S, ds)
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


def emulate(x, dt, B, C, A, h0, dy, dh_final, chunk):
    cum, states = forward_states(x, dt, B, C, A, h0, chunk)
    return emulate_backward(x, dt, B, C, A, h0, states, cum, dy, dh_final,
                            chunk)


def assert_close(got, want):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        assert torch.isfinite(g).all(), name
        assert err <= TOL * scale, (name, err, scale)


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
