"""Kernel-occupancy model — work-group sizing for a CUDA GPU (paper Sec. 3.1).

The paper computes GPU kernel occupancy from the usual constraining
factors: work-groups per compute unit, local memory per work-group, and
registers per thread; the autotuner then orders candidate work-group sizes
by non-increasing occupancy and filters those under a configurable
threshold (default 80%).  This module is that model, for a CUDA card:

  * a work-group is a thread block: a multiple of the 32-thread warp and
    at most ``max_threads_per_block`` (1024) threads;
  * its shared memory (``local_mem_per_item`` bytes per element) must fit
    ``sharedMemPerBlockOptin``;
  * resident blocks per SM are the least of the thread, block-slot,
    register and shared-memory limits; occupancy is the resident warps
    over the SM's warp slots, scaled down when the grid has fewer blocks
    than the card has SMs.

The limits are read from ``torch.cuda.get_device_properties`` when a card
is present, else they are the H100 SXM figures below.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.core.spec import KernelSpec

DEFAULT_THRESHOLD = 0.80
#: registers per thread assumed for a kernel whose spec gives none
DEFAULT_REGS_PER_THREAD = 32


@dataclasses.dataclass(frozen=True)
class GpuLimits:
    """Per-SM resource limits of one CUDA device."""

    name: str
    sms: int
    warp: int = 32
    max_threads_per_block: int = 1024
    max_threads_per_sm: int = 2048
    max_blocks_per_sm: int = 32
    regs_per_sm: int = 65536
    smem_per_sm: int = 233472
    smem_per_block_optin: int = 232448


#: NVIDIA H100 SXM: 132 SMs, 65,536 registers and 227 KB (232,448 bytes)
#: of opt-in shared memory per block (NVIDIA data sheet and Hopper
#: white paper); 2,048 threads, 32 blocks and 228 KB of shared memory per
#: SM (CUDA programming guide, compute capability 9.0).
HOPPER_H100_SXM = GpuLimits(name="H100 SXM (data sheet)", sms=132)


def gpu_limits(device: int = 0) -> GpuLimits:
    """Limits of CUDA device ``device``; the H100 SXM figures without a card."""
    if not torch.cuda.is_available():
        return HOPPER_H100_SXM
    p = torch.cuda.get_device_properties(device)
    h = HOPPER_H100_SXM
    return GpuLimits(
        name=p.name, sms=p.multi_processor_count, warp=p.warp_size,
        max_threads_per_sm=p.max_threads_per_multi_processor,
        regs_per_sm=getattr(p, "regs_per_multiprocessor", h.regs_per_sm),
        smem_per_sm=p.shared_memory_per_multiprocessor,
        smem_per_block_optin=getattr(p, "shared_memory_per_block_optin",
                                     h.smem_per_block_optin))


@dataclasses.dataclass(frozen=True)
class BlockScore:
    wgs: int
    occupancy: float
    smem_bytes: int
    blocks_per_sm: int


def _smem_footprint(spec: KernelSpec, wgs: int) -> int:
    """Shared-memory bytes of one block."""
    return int(wgs * spec.work_per_thread * spec.local_mem_per_item)


def occupancy(spec: KernelSpec, wgs: int, *, grid_blocks: int = 1,
              cores: int = 1, limits: Optional[GpuLimits] = None,
              regs_per_thread: int = DEFAULT_REGS_PER_THREAD) -> BlockScore:
    if wgs < 1:
        raise ValueError("wgs must be >= 1")
    lim = limits or gpu_limits()
    smem = _smem_footprint(spec, wgs)
    if wgs > lim.max_threads_per_block or smem > lim.smem_per_block_optin:
        return BlockScore(wgs=wgs, occupancy=0.0, smem_bytes=smem,
                          blocks_per_sm=0)
    warps = -(-wgs // lim.warp)             # a partial warp holds a slot
    blocks = min(lim.max_blocks_per_sm,
                 lim.max_threads_per_sm // (warps * lim.warp),
                 lim.regs_per_sm // (regs_per_thread * warps * lim.warp))
    if smem:
        blocks = min(blocks, lim.smem_per_sm // smem)
    warp_slots = lim.max_threads_per_sm // lim.warp
    occ = blocks * warps / warp_slots
    par_score = min(1.0, grid_blocks / max(cores, 1))
    return BlockScore(wgs=wgs, occupancy=min(occ * par_score, 1.0),
                      smem_bytes=smem, blocks_per_sm=blocks)


def candidates(spec: KernelSpec, domain_size: int, *, cores: int = 1,
               threshold: float = DEFAULT_THRESHOLD,
               max_candidates: int = 12,
               limits: Optional[GpuLimits] = None) -> List[BlockScore]:
    """Valid block sizes in non-increasing occupancy order (paper filter).

    Candidates are the power-of-two warp multiples up to the block limit
    (and the domain size).  If no candidate clears the threshold the
    best-occupancy one is returned alone (paper footnote 2).
    """
    lim = limits or gpu_limits()
    if spec.work_group_size is not None:
        # kernel is bound to a particular size (paper Sec. 2.1)
        blocks = max(1, domain_size // max(spec.work_group_size, 1))
        return [occupancy(spec, spec.work_group_size, grid_blocks=blocks,
                          cores=cores, limits=lim)]
    sizes: List[int] = []
    w = lim.warp
    while w <= lim.max_threads_per_block:
        if w <= domain_size or not sizes:
            sizes.append(w)
        w *= 2
    scored = []
    for s in sizes:
        blocks = max(1, domain_size // s)
        scored.append(occupancy(spec, s, grid_blocks=blocks, cores=cores,
                                limits=lim))
    scored.sort(key=lambda b: (-b.occupancy, -b.wgs))
    ok = [b for b in scored if b.occupancy >= threshold]
    return (ok or scored[:1])[:max_candidates]
