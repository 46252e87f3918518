"""Substrate layers: parameter definitions, norms, MLPs, rotary embeddings.

Every block publishes a *parameter definition* tree (``ParamDef`` leaves:
shape, logical axis names, init scale), as in the JAX package.  A
:class:`Params` module holds one parameter per leaf under the leaf's name
(a nested dict becomes a child ``Params``), so the port's parameters carry
the JAX package's names and per-layer shapes.  They are drawn from an
explicit ``torch.Generator`` with the JAX package's scale rules; the
numbers differ from JAX's (another generator), so parity tests carry JAX
parameters across with :func:`repro_torch.models.convert.from_jax_params`.

The functions below take tensors and ``Params`` and mirror the JAX
package's ``models/layers.py`` one for one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig

NEG_INF = -2.0 ** 30


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    scale: float = 1.0          # stddev multiplier (0 => zeros, -1 => ones)


Defs = Dict[str, Any]            # nested dict of ParamDef


def init_param(d: ParamDef, *, dtype: torch.dtype, device,
               generator: torch.Generator) -> torch.Tensor:
    """One parameter by the JAX package's rule (``init_tree``): scale 0
    gives zeros, -1 ones, otherwise a normal draw of standard deviation
    ``scale / sqrt(fan_in)`` with ``fan_in`` the second-to-last dimension
    (the last for a vector), drawn in float32 and cast."""
    if d.scale == 0.0:
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.scale == -1.0:
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / math.sqrt(max(fan_in, 1))
    w = torch.randn(d.shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def new_parameter(d: ParamDef, *, dtype: torch.dtype, device=None,
                  generator: Optional[torch.Generator] = None
                  ) -> nn.Parameter:
    """One parameter of ``d``, drawn by :func:`init_param` with a generator
    and left uninitialised without one; it does not require grad (the
    trainer turns that on)."""
    t = (init_param(d, dtype=dtype, device=device, generator=generator)
         if generator is not None
         else torch.empty(d.shape, dtype=dtype, device=device))
    return nn.Parameter(t, requires_grad=False)


class Params(nn.Module):
    """Parameters mirroring a ``ParamDef`` tree, read as ``p["name"]`` or
    ``p.name``.  Without a generator they are left uninitialised (to be
    filled by a conversion)."""

    def __init__(self, defs: Defs, *, dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name, d in defs.items():
            if isinstance(d, ParamDef):
                self.register_parameter(name, new_parameter(
                    d, dtype=dtype, device=device, generator=generator))
            else:
                self.add_module(name, Params(d, dtype=dtype, device=device,
                                             generator=generator))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_def(d: int) -> Defs:
    return {"scale": ParamDef((d,), (None,), -1.0)}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated silu/gelu or squared-ReLU)
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None,
             mlp_axis: str = "mlp") -> Defs:
    f = d_ff or cfg.d_ff
    d = cfg.d_model
    defs: Defs = {"w_in": ParamDef((d, f), ("embed", mlp_axis)),
                  "w_out": ParamDef((f, d), (mlp_axis, "embed"))}
    if cfg.gated_mlp:
        defs["w_gate"] = ParamDef((d, f), ("embed", mlp_axis))
    return defs


def activate(h: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(h)
    if kind == "gelu":                        # jax.nn.gelu is the tanh form
        return F.gelu(h, approximate="tanh")
    if kind == "relu2":                       # nemotron squared-ReLU
        r = F.relu(h)
        return r * r
    raise ValueError(kind)


def mlp(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = activate(h, cfg.activation) * (x @ p["w_gate"])
    else:
        h = activate(h, cfg.activation)
    return h @ p["w_out"]


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    ang = positions.to(torch.float32)[..., None] * freqs       # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2 logit soft-capping; no-op when cap == 0."""
    if cap and cap > 0:
        return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_defs(cfg: ModelConfig) -> Defs:
    V = cfg.padded_vocab
    defs: Defs = {"tokens": ParamDef((V, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, V), ("embed", "vocab"))
    return defs


def embed(tokens: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    e = p["tokens"][tokens]
    if cfg.tie_embeddings:
        e = e * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=e.dtype)               # gemma scaling
    return e


def unembed(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    w = p["tokens"].T if cfg.tie_embeddings else p["unembed"]
    logits = softcap(x @ w.to(x.dtype), cfg.final_softcap)
    return mask_padded_vocab(logits, cfg)


def mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-2^30 on the padded tail ids so sampling never sees them."""
    V, Vp = cfg.vocab, cfg.padded_vocab
    if Vp == V:
        return logits
    ids = torch.arange(Vp, device=logits.device)
    return logits.masked_fill(ids >= V, NEG_INF)
