"""AdamW with decoupled weight decay, global-norm clipping, float32 state.

The port's counterpart of the JAX package's ``optim/adamw.py``, written on
tensors (``torch.optim.AdamW`` decays and clips otherwise).  Parameters,
gradients and the moments are dicts keyed by the port's parameter names
(``LM.named_parameters()``); parameters may live in bf16, the moments ``m``
and ``v`` are float32, and each update is computed in float32 and cast back
to the parameter's dtype.  Where the JAX package returns new arrays, the
update here writes the parameters and the moments in place (the JAX train
step donates its state).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple, Union

import torch

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
    """The float32 L2 norm over every leaf."""
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


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
            m={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()},
            v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()})

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
        gnorm = global_norm(grads)
        if c.grad_clip and c.grad_clip > 0:
            scale = torch.clamp(c.grad_clip / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32)
        # the step's scalars, float32 values computed on the host (the step
        # count lives there): no copy to the device, no synchronisation
        sf = step.to(torch.float32)
        lr = float(c.lr_at(step))
        b1c = float(1.0 - torch.pow(torch.tensor(c.b1, dtype=torch.float32),
                                    sf))
        b2c = float(1.0 - torch.pow(torch.tensor(c.b2, dtype=torch.float32),
                                    sf))
        for name, p in params.items():
            g = grads[name].float() * scale.to(p.device)
            m, v = state.m[name], state.v[name]
            m.mul_(c.b1).add_(g, alpha=1 - c.b1)
            v.mul_(c.b2).add_(g * g, alpha=1 - c.b2)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + c.eps)
            pf = p.float()
            if self.decayed(name):
                delta.add_(pf, alpha=c.weight_decay)
            p.copy_(pf - lr * delta)
        return params, OptState(step=step, m=state.m, v=state.v), gnorm
