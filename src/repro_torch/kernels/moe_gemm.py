"""The MoE grouped GEMM on the card, launching ``csrc/moe_gemm.cu``.

bfloat16 goes to the TMA + wgmma kernel when its rows suit the TMA (16-byte
row strides and bases: ``d % 8 == 0``, ``f % 8 == 0``, x and w on 16
bytes); any other bf16 shape or view goes, by that check alone, to the
WMMA kernel.  Each of the two is counted apart (``bf16_launches``) besides
the kernel's total (``launches``).  The backward of ``y[e] = x[e] w[e]``
is two more calls of the same kernel, ``dx[e] = dy[e] w[e]^T`` and
``dw[e] = x[e]^T dy[e]`` on contiguous transposed operands
(``repro_torch.kernels.ops``); those calls are also counted in
``bwd_launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (DTYPE_CODES, LaunchCounter,
                                        check_launch, library, require,
                                        stream_of)

launches = LaunchCounter("grouped_matmul")
#: bfloat16 launches by kernel: "tma" (TMA + wgmma) and "wmma" (rows the
#: TMA cannot take)
bf16_launches = {"tma": LaunchCounter("grouped_matmul/tma"),
                 "wmma": LaunchCounter("grouped_matmul/wmma")}
#: launches made for a gradient (dx or dw), also counted in ``launches``
bwd_launches = LaunchCounter("grouped_matmul/backward")

_DTYPES = (torch.float32, torch.bfloat16)


def tma_rows(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the TMA can read x (E, C, d) and w (E, d, f): 16-byte row
    strides and 16-byte aligned bases (y is allocated aligned)."""
    d, f = x.shape[2], w.shape[2]
    return (d > 0 and d % 8 == 0 and f % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, *,
                   backward: bool = False) -> torch.Tensor:
    """x (E, C, d) and w (E, d, f), contiguous CUDA tensors of one dtype,
    float32 or bfloat16 -> y (E, C, f) in x's dtype, ``y[e] = x[e] @ w[e]``
    summed in float32.  ``backward``: the call computes a gradient (counted
    in ``bwd_launches`` too)."""
    require(x, "x", ndim=3, dtypes=_DTYPES)
    require(w, "w", ndim=3, device=x.device, dtypes=(x.dtype,))
    E, C, d = x.shape
    if w.shape[0] != E or w.shape[1] != d:
        raise ValueError(f"w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}: expected ({E}, {d}, f)")
    f = w.shape[2]
    y = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    if not y.numel():
        return y
    lib, dev, stream = library(), x.device.index, stream_of(x)
    if x.dtype == torch.bfloat16 and not tma_rows(x, w):
        check_launch(lib.grouped_matmul_wmma_fwd(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), E, C, d, f, dev,
            stream), "grouped_matmul (wmma)")
        bf16_launches["wmma"].add()
    else:
        check_launch(lib.grouped_matmul_fwd(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), DTYPE_CODES[x.dtype],
            E, C, d, f, dev, stream), "grouped_matmul")
        if x.dtype == torch.bfloat16:
            bf16_launches["tma"].add()
    launches.add()
    if backward:
        bwd_launches.add()
    return y
