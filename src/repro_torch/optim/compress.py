"""Gradient compression: int8 quantisation with error feedback.

The port's counterpart of the JAX package's ``optim/compress.py``, on
dicts of tensors keyed by parameter name (a scale to each leaf of the JAX
package's tree, see :func:`shared_scale`).  The scale is agreed across the
data-parallel group first (an all-reduce MAX of each tensor's amax, the
JAX ``pmax``), every rank quantises with that same scale, and the int8
gradients are summed in int32 (the JAX ``psum``), so
``mean = q_sum * scale / n`` is the exact mean of the quantised per-rank
gradients; each rank's quantisation error stays in its own error-feedback
state.  ``repro_torch.runtime.train.make_dp_train_step_int8`` runs the
collectives.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import param_path

Tree = Dict[str, torch.Tensor]


class CompressionState(NamedTuple):
    error: Tree          # residual feedback (float32, the gradients' keys)


def init_compression(grads_like: Tree) -> CompressionState:
    return CompressionState(error={
        k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for k, g in grads_like.items()})


def quantize_int8(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8.  Returns (q, scale); x ~ q * scale."""
    if scale is None:
        scale = torch.clamp(x.abs().max(), min=1e-30) / 127.0
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def shared_scale(grads: Tree, state: CompressionState, *,
                 reduce: bool = False,
                 group: Optional[dist.ProcessGroup] = None) -> Tree:
    """Per-tensor scales, agreed across the process group (one all-reduce
    MAX of every amax at once) when ``reduce`` is set.  A scale belongs to
    a leaf of the JAX package's tree: the layers' tensors of one name
    (``layers.0.attn.wq``, ``layers.1.attn.wq``, ...) are one stacked leaf
    there, so they share the largest of their amaxes."""
    names = list(grads)
    if not names:
        return {}
    amax = torch.stack([torch.max(torch.abs(grads[k].float()
                                            + state.error[k]))
                        for k in names])
    if reduce:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    leaf = {}
    for i, k in enumerate(names):
        leaf.setdefault(param_path(k), []).append(i)
    scales = torch.clamp(amax, min=1e-30) / 127.0
    out = {}
    for idx in leaf.values():
        s = scales[idx].max() if len(idx) > 1 else scales[idx[0]]
        out.update({names[i]: s for i in idx})
    return out


def compress_gradients(grads: Tree, state: CompressionState, scales: Tree
                       ) -> Tuple[Tree, CompressionState]:
    """Quantise (grads + carried error) with the given per-tensor scales."""
    q, err = {}, {}
    for k, g in grads.items():
        corrected = g.float() + state.error[k]
        q[k], _ = quantize_int8(corrected, scales[k])
        err[k] = corrected - dequantize_int8(q[k], scales[k])
    return q, CompressionState(error=err)


def decompress_sum(q_sum: Tree, scales: Tree, n_shards: int) -> Tree:
    """Decode a sum of same-scale int8 gradients into the mean gradient."""
    return {k: qs.to(torch.float32) * (scales[k] / n_shards)
            for k, qs in q_sum.items()}
