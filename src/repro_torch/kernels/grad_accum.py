"""The microbatch gradient accumulation on the card, launching
``csrc/grad_accum.cu`` over every gradient tensor of a microbatch at once.

No TPU kernel stands behind it: the JAX package's train step scans its
microbatches under ``jit`` (``runtime/train.py`` ``_accumulate_grads``),
and XLA fuses the float32 accumulation into the scan's body.  One wrapper,
one call into the library a microbatch:

  * :func:`grad_accumulate` — every float32 accumulator in place from its
    gradient, in one of three modes: ``first`` (``acc = 0 + g``, the
    accumulator not read), ``middle`` (``acc = acc + g``) and ``last``
    (``acc = (acc + g) * scale``), the eager loop's float32 arithmetic
    op for op (``ref.grad_accumulate_ref``).

The tensors go to the kernel as :mod:`~repro_torch.kernels.adamw`'s device
table (accumulator and gradient addresses, elements, the gradient's dtype
flag, first chunk), built on the host at each call and copied from pinned
memory without waiting.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels._build import (LaunchCounter, check_launch, library,
                                        stream_of)
from repro_torch.kernels.adamw import (_FLOATS, CHUNK, G_BF16, _bf16, _check,
                                       _table)

launches = LaunchCounter("grad_accum")

#: the kernel's modes (``csrc/grad_accum.cu``)
MODES = {"first": 0, "middle": 1, "last": 2}


def check_args(accs: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               mode: str) -> None:
    """Refuse with ``ValueError`` lists of different lengths, no tensors, or
    a mode the kernel does not have (every device's check)."""
    if len(accs) != len(grads) or not accs:
        raise ValueError(f"grad_accumulate takes one gradient an "
                         f"accumulator, at least one: {len(accs)} "
                         f"accumulators, {len(grads)} gradients")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")


def grad_accumulate(accs: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor], *, mode: str,
                    scale: float = 1.0) -> None:
    """Add each ``grads[i]`` into the float32 ``accs[i]`` in place, in
    ``mode`` (``scale``, the host's float ``1.0 / M``, is used by ``last``
    alone).  Gradients float32 or bf16 of their accumulator's shape; all
    contiguous, on one CUDA device."""
    check_args(accs, grads, mode)
    dev = _check([(f"accs[{i}]", a, (torch.float32,), None)
                  for i, a in enumerate(accs)]
                 + [(f"grads[{i}]", g, _FLOATS, a.shape)
                    for i, (g, a) in enumerate(zip(grads, accs))])
    table, chunks = _table([(a.data_ptr(), g.data_ptr(), 0, 0)
                            for a, g in zip(accs, grads)],
                           [a.numel() for a in accs],
                           [G_BF16 * _bf16(g) for g in grads], dev)
    check_launch(library().grad_accum(
        table.data_ptr(), len(accs), CHUNK, chunks, MODES[mode], scale,
        dev.index, stream_of(accs[0])), "grad_accum")
    launches.add()
