"""The MoE grouped GEMM on the card, launching ``csrc/moe_gemm.cu``."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (DTYPE_CODES, LaunchCounter,
                                        check_launch, library, require,
                                        stream_of)

launches = LaunchCounter("grouped_matmul")

_DTYPES = (torch.float32, torch.bfloat16)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, d) and w (E, d, f), contiguous CUDA tensors of one dtype,
    float32 or bfloat16 -> y (E, C, f) in x's dtype, ``y[e] = x[e] @ w[e]``
    summed in float32."""
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
    check_launch(library().grouped_matmul_fwd(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), DTYPE_CODES[x.dtype],
        E, C, d, f, x.device.index, stream_of(x)), "grouped_matmul")
    launches.add()
    return y
