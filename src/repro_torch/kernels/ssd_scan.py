"""The Mamba2 SSD chunk scan on the card, launching ``csrc/ssd_scan.cu``
(four kernels a call: C.B^T per chunk, each chunk's own end state, the
state passing over the chunks, the outputs), and its gradient, launching
``csrc/ssd_scan_bwd.cu`` (eight kernels a call: the within-chunk cumsum in
double, C.B^T, each chunk's own state gradient, the reverse state pass,
query tiles and key tiles by groups of heads, d cum, dB and dC from dCB
summed over the groups), every product on the tensor cores in split TF32."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import (DTYPE_CODES, LaunchCounter,
                                        check_launch, library, require,
                                        stream_of)

launches = LaunchCounter("ssd_scan")
bwd_launches = LaunchCounter("ssd_scan_bwd")

MAX_CHUNK = 256          # positions of a chunk
MAX_DIM = 128            # head_dim and d_state, each a multiple of 16
#: kernels one call launches
KERNELS_PER_CALL = 4
BWD_KERNELS_PER_CALL = 8
#: heads one block of the backward's query and key kernels walks (the last
#: group may hold fewer)
GROUP_HEADS = 4
_DTYPES = (torch.float32, torch.bfloat16)


def scratch(Bsz: int, S: int, nh: int, hd: int, ds: int, chunk: int,
            device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' float32 scratch: each chunk's end state, then its
    starting state (Bsz, S/chunk, nh, ds, hd); C.B^T of each chunk in whole
    64 x 64 tiles (Bsz, S/chunk, qp, qp), qp = chunk rounded up to 64; the
    within-chunk cumsum of dt * A (Bsz, nh, S)."""
    nc, qp = S // chunk, -(-chunk // 64) * 64
    return (torch.empty((Bsz, nc, nh, ds, hd), dtype=torch.float32,
                        device=device),
            torch.empty((Bsz, nc, qp, qp), dtype=torch.float32,
                        device=device),
            torch.empty((Bsz, nh, S), dtype=torch.float32, device=device))


def _check(x, dt, B, C, A, chunk, h0, dtypes=_DTYPES):
    """The inputs' checks; returns (Bsz, S, nh, hd, ds)."""
    require(x, "x", ndim=3, dtypes=dtypes)
    dev = x.device
    require(dt, "dt", ndim=3, device=dev)
    require(B, "B", ndim=3, device=dev, dtypes=(x.dtype,))
    require(C, "C", ndim=3, device=dev, dtypes=(x.dtype,))
    require(A, "A", ndim=1, device=dev)
    Bsz, S, dih = x.shape
    nh, ds = dt.shape[-1], B.shape[-1]
    if tuple(dt.shape) != (Bsz, S, nh) or dih % nh:
        raise ValueError(f"dt {tuple(dt.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    hd = dih // nh
    if tuple(B.shape) != (Bsz, S, ds) or C.shape != B.shape \
            or tuple(A.shape) != (nh,):
        raise ValueError(f"B {tuple(B.shape)}, C {tuple(C.shape)}, A "
                         f"{tuple(A.shape)} do not fit x {tuple(x.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"S={S} must be a multiple of chunk={chunk}, "
                         f"1 <= chunk <= {MAX_CHUNK}")
    for name, n in (("head_dim", hd), ("d_state", ds)):
        if n % 16 or not 16 <= n <= MAX_DIM:
            raise ValueError(f"{name} {n} must be a multiple of 16 "
                             f"up to {MAX_DIM}")
    if h0 is not None:
        require(h0, "h0", ndim=4, device=dev)
        if tuple(h0.shape) != (Bsz, nh, ds, hd):
            raise ValueError(f"h0 {tuple(h0.shape)} is not "
                             f"{(Bsz, nh, ds, hd)}")
    return Bsz, S, nh, hd, ds


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t``, or a copy that starts on 16 bytes (the kernels read four
    elements at a time)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan_with_states(x: torch.Tensor, dt: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor, A: torch.Tensor,
                         *, chunk: int, h0: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan`, also returning what the kernels leave in their
    scratch for the backward: each chunk's starting state (Bsz, S/chunk,
    nh, ds, hd) and the within-chunk cumsum of dt * A (Bsz, nh, S)."""
    Bsz, S, nh, hd, ds = _check(x, dt, B, C, A, chunk, h0)
    dev = x.device
    x, B, C, h0 = (_aligned(t) for t in (x, B, C, h0))
    y = torch.empty_like(x)
    h = torch.empty((Bsz, nh, ds, hd), dtype=torch.float32, device=dev)
    states, cb, cum = scratch(Bsz, S, nh, hd, ds, chunk, dev)
    check_launch(library().ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h.data_ptr(), states.data_ptr(), cb.data_ptr(), cum.data_ptr(),
        DTYPE_CODES[x.dtype], Bsz, S, nh, hd, ds, chunk, dev.index,
        stream_of(x)), "ssd_scan")
    launches.add()
    return y, h, states, cum


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, A: torch.Tensor, *, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD on contiguous CUDA tensors.

    x (Bsz, S, nh*hd) and B/C (Bsz, S, ds) float32 or bfloat16 (one dtype);
    dt (Bsz, S, nh), A (nh,) and h0 (Bsz, nh, ds, hd) float32.  Returns
    y (Bsz, S, nh*hd) in x's dtype and the final state (Bsz, nh, ds, hd)
    float32.  S must be a multiple of ``chunk`` (1..256).
    """
    y, h, _, _ = ssd_scan_with_states(x, dt, B, C, A, chunk=chunk, h0=h0)
    return y, h


def head_groups(nh: int) -> int:
    """How many groups of heads the backward's query and key kernels take,
    each walking its heads in order and summing dCB and the state terms of
    dB and dC over them: GROUP_HEADS heads a group, the last ragged."""
    return max(1, -(-nh // GROUP_HEADS))


def bwd_scratch(Bsz: int, S: int, nh: int, hd: int, ds: int, chunk: int,
                groups: int, device):
    """The backward's scratch, one float32 allocation: C.B^T (Bsz, nc, qp,
    qp); the chunks' end-state gradients (Bsz, nc, nh, ds, hd); the
    within-chunk cumsum in double (Bsz, nh, S); each group's dCB tiles at or
    below the diagonal (Bsz, nc, groups, n_t (n_t + 1) / 2, 64, 64) and its
    shares of dB's and dC's state terms (Bsz, nc, groups, qp, ds); d cum's
    parts by key (Bsz, nh, S), by query and half of 64 columns (Bsz, nh, 2,
    S), T (Bsz, nh, S), and by key tile and half of its columns (Bsz, nh,
    n_t, 2, S); <h_c, g> by warp of the state pass (Bsz, nc, nh, ds * hd /
    128); dA's shares (Bsz, nc, nh).  qp is the chunk rounded up to 64, n_t =
    qp / 64.  Each part starts on 256 bytes."""
    nc, n_t = S // chunk, -(-chunk // 64)
    qp = n_t * 64
    sizes = [Bsz * nc * qp * qp, Bsz * nc * nh * ds * hd, 2 * Bsz * nh * S,
             Bsz * nc * groups * n_t * (n_t + 1) // 2 * 64 * 64,
             Bsz * nc * groups * qp * ds, Bsz * nc * groups * qp * ds,
             Bsz * nh * S, 2 * Bsz * nh * S, Bsz * nh * S,
             2 * Bsz * nh * n_t * S, Bsz * nc * nh * ds * hd // 128,
             Bsz * nc * nh]
    offsets, n = [], 0
    for size in sizes:
        offsets.append(n)
        n += -(-size // 64) * 64
    buf = torch.empty(max(n, 1), dtype=torch.float32, device=device)
    return buf, [buf.data_ptr() + 4 * o for o in offsets]


def ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, A: torch.Tensor,
                      h0: Optional[torch.Tensor], states: torch.Tensor,
                      cum: torch.Tensor, dy: torch.Tensor,
                      dh_final: Optional[torch.Tensor], *, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
    """The gradient of :func:`ssd_scan` for the output gradients ``dy``
    (like x) and ``dh_final`` (Bsz, nh, ds, hd, or None for zero), from the
    inputs and the ``states`` and ``cum`` :func:`ssd_scan_with_states`
    returned.  Every tensor float32 and contiguous.  Returns (dx, ddt, dB,
    dC, dA, dh0), float32; dh0 is None when ``h0`` is."""
    Bsz, S, nh, hd, ds = _check(x, dt, B, C, A, chunk, h0,
                                dtypes=(torch.float32,))
    dev = x.device
    nc = S // chunk
    require(states, "states", ndim=5, device=dev)
    require(cum, "cum", ndim=3, device=dev)
    require(dy, "dy", ndim=3, device=dev)
    if tuple(states.shape) != (Bsz, nc, nh, ds, hd) \
            or tuple(cum.shape) != (Bsz, nh, S) or dy.shape != x.shape:
        raise ValueError(f"states {tuple(states.shape)}, cum "
                         f"{tuple(cum.shape)}, dy {tuple(dy.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if dh_final is not None:
        require(dh_final, "dh_final", ndim=4, device=dev)
        if tuple(dh_final.shape) != (Bsz, nh, ds, hd):
            raise ValueError(f"dh_final {tuple(dh_final.shape)} is not "
                             f"{(Bsz, nh, ds, hd)}")
    x, B, C, states, dy, dh_final = (_aligned(t) for t in (
        x, B, C, states, dy, dh_final))
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.empty_like(A)
    dh0 = None if h0 is None else torch.empty(
        (Bsz, nh, ds, hd), dtype=torch.float32, device=dev)
    groups = head_groups(nh)
    buf, parts = bwd_scratch(Bsz, S, nh, hd, ds, chunk, groups, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    check_launch(library().ssd_scan_bwd(
        *map(ptr, (x, dt, B, C, A, states, cum, dy, dh_final, dx, ddt, dB,
                   dC, dA, dh0)), *parts, Bsz, S, nh, hd, ds, chunk, groups,
        dev.index, stream_of(x)), "ssd_scan_bwd")
    bwd_launches.add()
    return dx, ddt, dB, dC, dA, dh0
