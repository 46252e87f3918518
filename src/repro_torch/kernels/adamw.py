"""AdamW's gradient norm and update on the card, launching
``csrc/adamw.cu`` over every parameter tensor of a step at once.

No TPU kernel stands behind these: the JAX package's train step is
jitted whole and XLA fuses ``optim/adamw.py``'s norm and update.  Three
wrappers, each one call into the library:

  * :func:`grad_sumsq` — each gradient's float32 sum of squares (a block a
    chunk into a partials buffer, then a block a tensor: both in a fixed
    order, so the same gradients give the same bits);
  * :func:`sum_in_order` — the sum of a float32 vector in a fixed order
    (the per-tensor sums, after the sharded norm's all-reduce);
  * :func:`adamw_update` — p, m and v in place, the eager loop's float32
    arithmetic op for op.

The tensors go to the kernels as a table of addresses, sizes, dtypes,
decay flags and first chunks, built on the host at each call (gradients
are new tensors every step) and copied to the card from pinned memory
without waiting: one launch covers any number of tensors, with no limit on
a kernel's argument size and no host synchronisation.  PyTorch's caching
host allocator keeps the pinned block until the copy has run.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels._build import (LaunchCounter, check_launch, library,
                                        require, stream_of)

launches = LaunchCounter("adamw")

#: elements a block takes (a multiple of the kernels' 8 a thread a step)
CHUNK = 16384
#: a table row's flags (``csrc/adamw.cu``)
P_BF16, G_BF16, DECAY = 1, 2, 4
_FLOATS = (torch.float32, torch.bfloat16)


def chunks_of(numels: Sequence[int]) -> List[int]:
    """Each tensor's first chunk, and the total after the last."""
    starts, total = [], 0
    for n in numels:
        starts.append(total)
        total += -(-int(n) // CHUNK)
    return starts + [total]


def _table(tensors: Sequence[Tuple], numels: Sequence[int],
           flags: Sequence[int], device: torch.device
           ) -> Tuple[torch.Tensor, int]:
    """The device table of (p, g, m, v addresses, elements, flags, first
    chunk, 0) rows, and the chunks in all."""
    starts = chunks_of(numels)
    rows = [[*ptrs, n, f, s, 0]
            for ptrs, n, f, s in zip(tensors, numels, flags, starts)]
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True), starts[-1]


def _bf16(t: torch.Tensor) -> bool:
    return t.dtype == torch.bfloat16


def _check(tensors) -> torch.device:
    """Refuse with ``ValueError`` any ``(name, tensor, dtypes, shape)`` of
    another dtype or shape, not contiguous, or not on the first one's CUDA
    device (dtype, contiguity and shape are checked first, on any device);
    returns that device."""
    for name, t, dtypes, shape in tensors:
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be "
                             f"{' or '.join(str(d) for d in dtypes)}, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and t.shape != shape:
            raise ValueError(f"{name} {tuple(t.shape)} differs from "
                             f"{tuple(shape)}")
    dev = tensors[0][1].device
    for name, t, dtypes, _ in tensors:
        require(t, name, device=dev, dtypes=dtypes)
    return dev


def grad_sumsq(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """(n,) float32: each gradient's sum of squares.  ``grads``: contiguous
    float32 or bf16 CUDA tensors on one device."""
    if not grads:
        raise ValueError("grad_sumsq needs at least one gradient")
    dev = _check([(f"grads[{i}]", g, _FLOATS, None)
                  for i, g in enumerate(grads)])
    numels = [g.numel() for g in grads]
    table, chunks = _table([(0, g.data_ptr(), 0, 0) for g in grads], numels,
                           [G_BF16 * _bf16(g) for g in grads], dev)
    partials = torch.empty((chunks,), dtype=torch.float32, device=dev)
    out = torch.empty((len(grads),), dtype=torch.float32, device=dev)
    check_launch(library().adamw_sumsq(
        table.data_ptr(), len(grads), CHUNK, chunks, partials.data_ptr(),
        out.data_ptr(), dev.index, stream_of(grads[0])), "adamw_sumsq")
    launches.add()
    return out


def sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """0-d float32: the sum of the float32 vector ``x`` in a fixed
    order."""
    require(x, "x", ndim=1)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    check_launch(library().adamw_sum(x.data_ptr(), x.numel(),
                                     out.data_ptr(), x.device.index,
                                     stream_of(x)), "adamw_sum")
    launches.add()
    return out


def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor], decayed: Sequence[bool],
                 scale: torch.Tensor, *, lr: float, b1: float, b2: float,
                 b1c: float, b2c: float, eps: float, wd: float) -> None:
    """One AdamW step of every ``params[i]`` in place, with its gradient
    ``grads[i]`` times ``scale`` (a 0-d float32 tensor on the card) and its
    float32 moments ``ms[i]``, ``vs[i]`` (updated in place); weight decay
    where ``decayed[i]``.  p and g float32 or bf16, contiguous, all of one
    shape a tensor, on one device."""
    n = len(params)
    if not (len(grads) == len(ms) == len(vs) == len(decayed) == n) or not n:
        raise ValueError(f"adamw_update takes as many grads, moments and "
                         f"flags as params ({n}, at least one): "
                         f"{len(grads)}, {len(ms)}, {len(vs)}, "
                         f"{len(decayed)}")
    f32 = (torch.float32,)
    dev = _check([(f"params[{i}]", p, _FLOATS, None)
                  for i, p in enumerate(params)]
                 + [(f"{name}[{i}]", t, dtypes, p.shape)
                    for name, ts, dtypes in (("grads", grads, _FLOATS),
                                             ("ms", ms, f32), ("vs", vs, f32))
                    for i, (t, p) in enumerate(zip(ts, params))]
                 + [("scale", scale, f32, ())])
    table, chunks = _table(
        [(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
         for p, g, m, v in zip(params, grads, ms, vs)],
        [p.numel() for p in params],
        [P_BF16 * _bf16(p) | G_BF16 * _bf16(g) | DECAY * bool(d)
         for p, g, d in zip(params, grads, decayed)], dev)
    check_launch(library().adamw_update(
        table.data_ptr(), n, CHUNK, chunks, scale.data_ptr(), lr, b1, 1 - b1,
        b2, 1 - b2, b1c, b2c, eps, wd, dev.index,
        stream_of(params[0])), "adamw_update")
    launches.add()
