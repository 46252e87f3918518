"""AdamW with decoupled weight decay, global-norm clipping, float32 state.

The port's counterpart of the JAX package's ``optim/adamw.py``, written on
tensors (``torch.optim.AdamW`` decays and clips otherwise).  Parameters,
gradients and the moments are dicts keyed by the port's parameter names
(``LM.named_parameters()``); parameters may live in bf16, the moments ``m``
and ``v`` are float32, and each update is computed in float32 and cast back
to the parameter's dtype.  Where the JAX package returns new arrays, the
update here writes the parameters and the moments in place (the JAX train
step donates its state).  On a mesh the parameters are DTensors: the
moments take their placements (ZeRO-1 where the parameters are FSDP
sharded, as the reference's inherit their shardings), the update runs on
this rank's blocks and the gradient norm sums the blocks' squares over the
mesh axes each parameter is split over.

The JAX step is jitted whole and XLA fuses the norm and the update; here
both go through :mod:`repro_torch.kernels.ops` over every tensor at once:
on the card three hand-written kernel calls a step (each gradient's sum of
squares, their sum in a fixed order, the update), on the CPU the plain
loop (``kernels/ref.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.models import spmd

Schedule = Callable[[torch.Tensor], torch.Tensor]
Tree = Dict[str, torch.Tensor]


def split_name(name: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """A port parameter's place in the JAX package's tree, which keeps each
    layer's leaves stacked under one name: (its path, its index in the
    stacked leaf).  ``layers.3.mamba.1.ssm.A_log`` -> ((layers, mamba,
    ssm, A_log), (3, 1)); ``embed.tokens`` -> ((embed, tokens), ())."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def param_path(name: str) -> str:
    """The JAX package's path of a port parameter, "/"-joined
    (``layers/mamba/ssm/A_log``)."""
    return "/".join(split_name(name)[0])


def global_norm(tree: Tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf: each leaf's sum of squares,
    added in the leaves' order."""
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(ops.sum_in_order(ops.grad_sumsq(leaves)))


class OptState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: Tree                  # first moment (float32)
    v: Tree                  # second moment (float32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[float, Schedule] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0            # 0 disables clipping
    # decay mask: params whose lower-cased path contains any of these are
    # exempt from weight decay.  The match is the JAX package's, case and
    # all: its paths are lower-cased first, so "A_log" and "D" never match
    # and those leaves are decayed there, and here.
    no_decay: Tuple[str, ...] = ("norm", "scale", "bias", "dt_bias",
                                 "A_log", "D")

    def lr_at(self, step) -> torch.Tensor:
        if callable(self.lr):
            return torch.as_tensor(self.lr(step), dtype=torch.float32)
        return torch.tensor(self.lr, dtype=torch.float32)


class AdamW:
    """init/update pair closed over a config."""

    def __init__(self, config: AdamWConfig = AdamWConfig()):
        self.config = config

    def init(self, params: Tree) -> OptState:
        return OptState(
            step=torch.zeros((), dtype=torch.int32),
            m={k: _zeros_f32(p) for k, p in params.items()},
            v={k: _zeros_f32(p) for k, p in params.items()})

    def decayed(self, name: str) -> bool:
        key = param_path(name).lower()
        return not any(s in key for s in self.config.no_decay)

    @torch.no_grad()
    def update(self, grads: Tree, state: OptState, params: Tree
               ) -> Tuple[Tree, OptState, torch.Tensor]:
        """Returns (params, new_state, grad_norm); ``params`` and the
        moments are updated in place."""
        c = self.config
        step = state.step + 1
        gnorm = (_sharded_norm(grads, params)
                 if any(spmd.is_sharded(p) for p in params.values())
                 else global_norm(grads))
        if c.grad_clip and c.grad_clip > 0:
            scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        # the step's scalars, float32 values computed on the host (the step
        # count lives there): no copy to the device, no synchronisation
        sf = step.to(torch.float32)
        lr = float(c.lr_at(step))
        b1c = float(1.0 - torch.pow(torch.tensor(c.b1, dtype=torch.float32),
                                    sf))
        b2c = float(1.0 - torch.pow(torch.tensor(c.b2, dtype=torch.float32),
                                    sf))
        names = list(params)
        if names:
            ops.adamw_update(
                [spmd.block(params[k]) for k in names],
                [spmd.block(grads[k]) for k in names],
                [spmd.block(state.m[k]) for k in names],
                [spmd.block(state.v[k]) for k in names],
                [self.decayed(k) for k in names], scale, lr=lr, b1=c.b1,
                b2=c.b2, b1c=b1c, b2c=b2c, eps=c.eps, wd=c.weight_decay)
        return params, OptState(step=step, m=state.m, v=state.v), gnorm


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros of ``p``'s shape, and of its placements if it is a
    DTensor."""
    if not spmd.is_sharded(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        torch.zeros_like(p.to_local(), dtype=torch.float32), p.device_mesh,
        p.placements, run_check=False, shape=p.shape, stride=p.stride())


def _sharded_norm(grads: Tree, params: Tree) -> torch.Tensor:
    """The float32 L2 norm of gradients given as this rank's blocks of
    DTensor parameters: each block's sum of squares, summed over the mesh
    axes its parameter is split over (one all-reduce per set of axes),
    then all added in the parameters' order, as ``global_norm`` adds them
    (so on one rank the two give the same bits)."""
    from torch.distributed.tensor import Shard
    names = list(params)
    sq = ops.grad_sumsq([spmd.block(grads[k]) for k in names])
    by_axes: Dict[tuple, list] = {}
    mesh = None
    for i, name in enumerate(names):
        p = params[name]
        if spmd.is_sharded(p):
            mesh = p.device_mesh
            axes = tuple(a for a, pl in zip(mesh.mesh_dim_names,
                                            p.placements)
                         if isinstance(pl, Shard))
            if axes:
                by_axes.setdefault(axes, []).append(i)
    if by_axes:
        each = list(sq.unbind(0))
        for axes, idx in by_axes.items():
            summed = spmd.all_reduce(torch.stack([each[i] for i in idx]),
                                     mesh, axes)
            for j, i in enumerate(idx):
                each[i] = summed[j]
        sq = torch.stack(each)
    return torch.sqrt(ops.sum_in_order(sq))
