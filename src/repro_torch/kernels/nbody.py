"""Direct-sum N-body accelerations on the card — the paper's Loop
benchmark body, launching ``csrc/nbody.cu`` (a call packs the sources,
sweeps them over a grid of target tiles and source splits, and, with more
than one split, adds the partial sums in split order)."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels._build import (LaunchCounter, check_launch, library,
                                        require, stream_of)

SOFTENING = 1e-3
INT32_MAX = (1 << 31) - 1

#: the sweep's shape as ``csrc/nbody.cu`` is built (kThreads, kTargets,
#: kTile there)
THREADS = 128
TARGETS_PER_THREAD = 4
TILE = 128
#: blocks an SM the plan aims to give the sweep: enough equal blocks that
#: no SM runs many more tile sweeps than another, few enough splits that
#: their reduction stays short (``chip_kernel_shapes.py nbody`` times 4, 8,
#: 16 and 32)
BLOCKS_PER_SM = 16
#: a call with fewer sources is not split: its splits would hold a tile or
#: a few, and the second launch would cost more than it saves
SPLIT_MIN_SOURCES = 2048

launches = LaunchCounter("nbody")


class Plan(NamedTuple):
    """How a call is launched: ``row_blocks`` tiles of ``targets_per_block``
    targets, times ``splits`` source ranges of ``split_len`` sources (a
    whole number of tiles; the last range may be shorter) over ``n_j``
    sources."""
    targets_per_block: int
    row_blocks: int
    splits: int
    split_len: int
    n_j: int

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.splits

    @property
    def ranges(self) -> Tuple[Tuple[int, int], ...]:
        """Each split's sources, [start, end)."""
        return tuple((s * self.split_len,
                      min(self.n_j, (s + 1) * self.split_len))
                     for s in range(self.splits))


def launch_plan(n_i: int, n_j: int, sms: int, *,
                targets_per_block: int = THREADS * TARGETS_PER_THREAD,
                tile: int = TILE,
                blocks_per_sm: int = BLOCKS_PER_SM) -> Plan:
    """The grid for ``n_i`` targets against ``n_j`` sources on a card of
    ``sms`` SMs: enough source splits of whole tiles to give
    ``blocks_per_sm`` blocks an SM (at most one a tile), none where the
    target tiles alone do or where ``n_j`` is below ``SPLIT_MIN_SOURCES``.
    (The keywords are the sweep's build constants; other values are for
    builds made with others.)"""
    if n_i < 1 or n_j < 1 or sms < 1:
        raise ValueError(f"no plan for {n_i} targets, {n_j} sources, "
                         f"{sms} SMs")
    rows = -(-n_i // targets_per_block)
    tiles = -(-n_j // tile)
    want = blocks_per_sm * sms
    splits = 1
    if n_j >= SPLIT_MIN_SOURCES and rows < want:
        splits = min(-(-want // rows), tiles)
    split_tiles = tiles // splits
    splits = -(-tiles // split_tiles)
    return Plan(targets_per_block, rows, splits, split_tiles * tile, n_j)


def scratch_rows(n_i: int, n_j: int, splits: int, tile: int = TILE) -> int:
    """float4s of a call's scratch: the packed sources, ``n_j`` rounded up
    to a tile, then with more than one split the (splits, n_i) partial
    sums."""
    return -(-n_j // tile) * tile + (splits * n_i if splits > 1 else 0)


def nbody_accelerations(targets: torch.Tensor, pos: torch.Tensor,
                        mass: torch.Tensor, *,
                        softening: float = SOFTENING) -> torch.Tensor:
    """Accelerations on ``targets`` (n_i, 3) from the bodies ``pos``
    (N, 3) of ``mass`` (N,); all contiguous float32 on one CUDA device."""
    require(targets, "targets", ndim=2)
    dev = targets.device
    require(pos, "pos", ndim=2, device=dev)
    require(mass, "mass", ndim=1, device=dev)
    if targets.shape[1] != 3 or pos.shape[1] != 3:
        raise ValueError("targets and pos must be (n, 3)")
    if mass.shape[0] != pos.shape[0]:
        raise ValueError(f"mass has {mass.shape[0]} bodies, pos "
                         f"{pos.shape[0]}")
    n_i, n_j = targets.shape[0], pos.shape[0]
    if max(n_i, n_j) > INT32_MAX // 3:
        raise ValueError("too many bodies for int32 indexing")
    acc = torch.empty_like(targets)
    if n_i == 0:
        return acc
    splits, split_len, scratch = 1, TILE, None
    if n_j:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = launch_plan(n_i, n_j, sms)
        splits, split_len = plan.splits, plan.split_len
        # the call's own scratch, on its stream: two slots' calls at once
        # on two streams never share one
        scratch = torch.empty((scratch_rows(n_i, n_j, splits), 4),
                              dtype=torch.float32, device=dev)
    check_launch(library().nbody_acc_f32(
        targets.data_ptr(), n_i, pos.data_ptr(), mass.data_ptr(), n_j,
        acc.data_ptr(), float(softening),
        None if scratch is None else scratch.data_ptr(), splits, split_len,
        dev.index, stream_of(targets)), "nbody")
    launches.add()
    return acc
