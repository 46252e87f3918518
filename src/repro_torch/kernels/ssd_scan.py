"""The Mamba2 SSD chunk scan on the card, launching ``csrc/ssd_scan.cu``
(four kernels a call: C.B^T per chunk, each chunk's own end state, the
state passing over the chunks, the outputs)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import (DTYPE_CODES, LaunchCounter,
                                        check_launch, library, require,
                                        stream_of)

launches = LaunchCounter("ssd_scan")

MAX_CHUNK = 256          # positions of a chunk
MAX_DIM = 128            # head_dim and d_state, each a multiple of 16
#: kernels one call launches
KERNELS_PER_CALL = 4
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
    require(x, "x", ndim=3, dtypes=_DTYPES)
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
    # the kernels read x, B, C and h0 four elements at a time: a view that
    # does not start on 16 bytes is copied to one that does
    x, B, C = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, B, C))
    if h0 is not None and h0.data_ptr() % 16:
        h0 = h0.clone()
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
    return y, h
