"""saxpy on the card — the paper's Map benchmark (BLAS single-precision
``a*x + y``), launching ``csrc/saxpy.cu``."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (LaunchCounter, check_launch, library,
                                        require, stream_of)

launches = LaunchCounter("saxpy")


def saxpy(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """a scalar, x/y contiguous float32 CUDA tensors of one shape -> a*x + y."""
    require(x, "x")
    require(y, "y", device=x.device)
    if x.shape != y.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ")
    z = torch.empty_like(x)
    check_launch(library().saxpy_f32(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), float(a), x.numel(),
        x.device.index, stream_of(x)), "saxpy")
    launches.add()
    return z
