"""The MoE grouped GEMM on the card, launching ``csrc/moe_gemm.cu``.

bfloat16 goes to the TMA + wgmma kernel when its rows suit the TMA (16-byte
row strides and bases: ``d % 8 == 0``, ``f % 8 == 0``, x and w on 16
bytes); any other bf16 shape or view goes, by that check alone, to the
WMMA kernel.  Each of the two is counted apart (``bf16_launches``) besides
the kernel's total (``launches``).

The backward of ``y[e] = x[e] w[e]`` is ``dx[e] = dy[e] w[e]^T`` and
``dw[e] = x[e]^T dy[e]``.  In bf16, on rows the TMA can take, each is a
kernel of its own (:func:`grouped_matmul_dx`, :func:`grouped_matmul_dw`)
that reads dy, w and x where they lie, through tensor maps that give
wgmma each operand K-major or MN-major: no transposed copy is made.  Any
other backward (float32, bf16 rows the TMA cannot take) is two calls of
:func:`grouped_matmul` on contiguous transposed copies
(``repro_torch.kernels.ops``).  Every gradient launch is counted in
``bwd_launches`` and ``launches``; the two backward kernels also in
``bwd_kernels`` by product.
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
#: launches of the backward kernels by product (bf16 rows the TMA takes;
#: each also in ``bwd_launches`` and ``launches``)
bwd_kernels = {"dx": LaunchCounter("grouped_matmul_dx"),
               "dw": LaunchCounter("grouped_matmul_dw")}

_DTYPES = (torch.float32, torch.bfloat16)


def tma_rows(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the TMA can read x (E, C, d) and w (E, d, f): 16-byte row
    strides and 16-byte aligned bases (y is allocated aligned)."""
    d, f = x.shape[2], w.shape[2]
    return (d > 0 and d % 8 == 0 and f % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def backward_in_place(x: torch.Tensor, w: torch.Tensor,
                      dy: torch.Tensor) -> bool:
    """Whether the backward kernels take y = x w's gradient dy: bf16, and
    rows the TMA can read in x, w and dy (16-byte row strides and bases;
    the outputs are allocated aligned)."""
    return (x.dtype == torch.bfloat16 and tma_rows(x, w)
            and dy.data_ptr() % 16 == 0)


def _backward_rows(a: torch.Tensor, b: torch.Tensor, names) -> None:
    """Wrapper-side checks of a backward kernel's two operands: contiguous
    bf16 CUDA tensors of 3 dimensions on one device, rows the TMA reads."""
    require(a, names[0], ndim=3, dtypes=(torch.bfloat16,))
    require(b, names[1], ndim=3, device=a.device, dtypes=(torch.bfloat16,))
    if (a.shape[2] % 8 or b.shape[2] % 8 or a.data_ptr() % 16
            or b.data_ptr() % 16):
        raise ValueError(f"{names[0]} {tuple(a.shape)} and {names[1]} "
                         f"{tuple(b.shape)}: the backward kernels read rows "
                         "of a multiple of 8 elements from 16-byte aligned "
                         "bases")


def grouped_matmul_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dy (E, C, f) and w (E, d, f), contiguous bf16 CUDA tensors with
    d % 8 == 0, f % 8 == 0 and 16-byte aligned bases -> dx (E, C, d),
    ``dx[e] = dy[e] @ w[e]^T`` summed in float32, w read in place."""
    _backward_rows(dy, w, ("dy", "w"))
    E, C, f = dy.shape
    d = w.shape[1]
    if w.shape[0] != E or w.shape[2] != f or d % 8:
        raise ValueError(f"w {tuple(w.shape)} does not fit dy "
                         f"{tuple(dy.shape)}: expected ({E}, d, {f}), "
                         "d % 8 == 0")
    dx = torch.empty((E, C, d), dtype=dy.dtype, device=dy.device)
    if dx.numel():
        check_launch(library().grouped_matmul_dx(
            dy.data_ptr(), w.data_ptr(), dx.data_ptr(), E, C, d, f,
            dy.device.index, stream_of(dy)), "grouped_matmul_dx")
        _count("dx")
    return dx


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """x (E, C, d) and dy (E, C, f), contiguous bf16 CUDA tensors with
    d % 8 == 0, f % 8 == 0 and 16-byte aligned bases -> dw (E, d, f),
    ``dw[e] = x[e]^T @ dy[e]`` summed in float32, x read in place."""
    _backward_rows(x, dy, ("x", "dy"))
    E, C, d = x.shape
    if dy.shape[:2] != x.shape[:2]:
        raise ValueError(f"dy {tuple(dy.shape)} does not fit x "
                         f"{tuple(x.shape)}: expected ({E}, {C}, f)")
    f = dy.shape[2]
    dw = torch.empty((E, d, f), dtype=x.dtype, device=x.device)
    if dw.numel():
        check_launch(library().grouped_matmul_dw(
            x.data_ptr(), dy.data_ptr(), dw.data_ptr(), E, C, d, f,
            x.device.index, stream_of(x)), "grouped_matmul_dw")
        _count("dw")
    return dw


def _count(product: str) -> None:
    bwd_kernels[product].add()
    bwd_launches.add()
    launches.add()


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
