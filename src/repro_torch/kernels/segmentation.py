"""Segmentation on the card — the paper's 3-D Map benchmark: a gray volume
to {0, 128, 255} by two thresholds, launching ``csrc/segmentation.cu``."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (LaunchCounter, check_launch, library,
                                        require, stream_of)

launches = LaunchCounter("segmentation")


def segmentation(vol: torch.Tensor, *, lo: float = 85.0,
                 hi: float = 170.0) -> torch.Tensor:
    """vol: contiguous float32 CUDA tensor of any shape (a slice of whole
    planes) -> segmented volume of the same shape."""
    require(vol, "vol")
    out = torch.empty_like(vol)
    check_launch(library().segmentation_f32(
        vol.data_ptr(), out.data_ptr(), vol.numel(), float(lo), float(hi),
        vol.device.index, stream_of(vol)), "segmentation")
    launches.add()
    return out
