"""Fused filter pipeline on the card — the paper's Pipeline benchmark:
hash noise -> clip -> solarize -> mirror, launching
``csrc/filter_pipeline.cu``."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (LaunchCounter, check_launch, library,
                                        require, stream_of)

launches = LaunchCounter("filter_pipeline")

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def filter_pipeline(img: torch.Tensor, seed: int = 0, *,
                    noise_scale: float = 8.0,
                    solarize_threshold: float = 128.0) -> torch.Tensor:
    """img (H, W) contiguous float32 CUDA tensor in [0, 255] -> filtered
    (H, W).  Row ids of the noise hash are local to ``img``."""
    require(img, "img", ndim=2)
    seed = int(seed)
    if not INT32_MIN <= seed <= INT32_MAX:
        raise ValueError(f"seed {seed} does not fit int32")
    H, W = img.shape
    if H > INT32_MAX or W > INT32_MAX:
        raise ValueError(f"image {H}x{W} too large for int32 row/col ids")
    out = torch.empty_like(img)
    check_launch(library().filter_pipeline_f32(
        img.data_ptr(), out.data_ptr(), H, W, seed, float(noise_scale),
        float(solarize_threshold), img.device.index, stream_of(img)),
        "filter_pipeline")
    launches.add()
    return out
