"""Direct-sum N-body accelerations on the card — the paper's Loop
benchmark body, launching ``csrc/nbody.cu``."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (LaunchCounter, check_launch, library,
                                        require, stream_of)

SOFTENING = 1e-3
INT32_MAX = (1 << 31) - 1

launches = LaunchCounter("nbody")


def nbody_accelerations(targets: torch.Tensor, pos: torch.Tensor,
                        mass: torch.Tensor, *,
                        softening: float = SOFTENING) -> torch.Tensor:
    """Accelerations on ``targets`` (n_i, 3) from the bodies ``pos``
    (N, 3) of ``mass`` (N,); all contiguous float32 on one CUDA device."""
    require(targets, "targets", ndim=2)
    require(pos, "pos", ndim=2, device=targets.device)
    require(mass, "mass", ndim=1, device=targets.device)
    if targets.shape[1] != 3 or pos.shape[1] != 3:
        raise ValueError("targets and pos must be (n, 3)")
    if mass.shape[0] != pos.shape[0]:
        raise ValueError(f"mass has {mass.shape[0]} bodies, pos "
                         f"{pos.shape[0]}")
    if max(targets.shape[0], pos.shape[0]) > INT32_MAX // 3:
        raise ValueError("too many bodies for int32 indexing")
    acc = torch.empty_like(targets)
    check_launch(library().nbody_acc_f32(
        targets.data_ptr(), targets.shape[0], pos.data_ptr(), mass.data_ptr(),
        pos.shape[0], acc.data_ptr(), float(softening), targets.device.index,
        stream_of(targets)), "nbody")
    launches.add()
    return acc
