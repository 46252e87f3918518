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

from repro_torch.kernels import ref
from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (Rules, local_shape, placements_for,
                                         sharding_for, spec_for)

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
        #: each parameter's logical axis names, by its name here
        self.logical: Dict[str, Tuple[Optional[str], ...]] = {}
        for name, d in defs.items():
            if isinstance(d, ParamDef):
                self.logical[name] = d.logical
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
    return ref.rmsnorm_rows(x, spmd.local(scale), eps)


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
    L = spmd.current()
    if L is not None:
        return _mlp_sharded(L, x, p, cfg)
    return _mlp(x, p["w_in"], p["w_gate"] if "w_gate" in p else None,
                p["w_out"], cfg)


def _mlp(x, w_in, w_gate, w_out, cfg: ModelConfig) -> torch.Tensor:
    h = x @ w_in
    if w_gate is not None:
        h = activate(h, cfg.activation) * (x @ w_gate)
    else:
        h = activate(h, cfg.activation)
    return h @ w_out


def _mlp_sharded(L, x: torch.Tensor, p: Params, cfg: ModelConfig
                 ) -> torch.Tensor:
    """On a mesh: column- then row-parallel over the model axis where the
    rules shard ``mlp`` (the hidden dim), on this rank's rows otherwise."""
    gate = "w_gate" in p
    if L.tp_dim(p["w_in"]) == 1:
        col, row = {L.tp: 1}, {L.tp: 0}
        y = _mlp(L.enter_tp(x), L.param(p["w_in"], col),
                 L.param(p["w_gate"], col) if gate else None,
                 L.param(p["w_out"], row), cfg)
        return L.exit_tp(y)
    return _mlp(x, L.param(p["w_in"]),
                L.param(p["w_gate"]) if gate else None,
                L.param(p["w_out"]), cfg)


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
    return ref.rotate_ref(x, positions,
                          rope_frequencies(x.shape[-1], theta, x.device))


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
    L = spmd.current()
    if L is not None:
        e = _embed_sharded(L.with_seq(False), tokens, p["tokens"])
    else:
        e = p["tokens"][tokens]
    if cfg.tie_embeddings:
        e = e * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=e.dtype)               # gemma scaling
    return e


def _embed_sharded(L, tokens: torch.Tensor, table) -> torch.Tensor:
    """The rows of ``tokens`` on a mesh: each rank looks up the ids of its
    vocabulary shard (zeros elsewhere) and the shards' rows are summed
    over the model axis (exact: one of them is not zero)."""
    if L.tp_dim(table) != 0:
        return L.param(table)[tokens]
    w = L.param(table, {L.tp: 0})
    Vl = w.shape[0]
    ids = tokens.long() - L.tp_rank * Vl
    own = (ids >= 0) & (ids < Vl)
    e = w[ids.clamp(0, Vl - 1)] * own[..., None].to(w.dtype)
    return L.reduce_tp(e)


def unembed_weight(L, p: Params, cfg: ModelConfig) -> torch.Tensor:
    """(d, V/model) on a mesh where the rules shard the vocabulary over the
    model axis, (d, V) otherwise."""
    if cfg.tie_embeddings:
        tab = p["tokens"]
        return L.param(tab, {L.tp: 0} if L.tp_dim(tab) == 0 else None).T
    w = p["unembed"]
    return L.param(w, {L.tp: 1} if L.tp_dim(w) == 1 else None)


def vocab_sharded(p: Params, cfg: ModelConfig, L) -> bool:
    """Whether the unembedding runs vocabulary-parallel: the rules split
    the vocabulary over a model axis of more than one rank."""
    w = p["tokens"] if cfg.tie_embeddings else p["unembed"]
    return (L.tp_size > 1
            and L.tp_dim(w) == (0 if cfg.tie_embeddings else 1))


def unembed(x: torch.Tensor, p: Params, cfg: ModelConfig) -> torch.Tensor:
    w = p["tokens"].T if cfg.tie_embeddings else p["unembed"]
    logits = softcap(x @ w.to(x.dtype), cfg.final_softcap)
    return mask_padded_vocab(logits, cfg)


def mask_padded_vocab(logits: torch.Tensor, cfg: ModelConfig,
                      offset: int = 0) -> torch.Tensor:
    """-2^30 on the padded tail ids so sampling never sees them; the last
    dim holds ids ``offset`` on (a vocabulary shard's)."""
    V, Vp = cfg.vocab, cfg.padded_vocab
    if Vp == V:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device) + offset
    return logits.masked_fill(ids >= V, NEG_INF)


# ---------------------------------------------------------------------------
# Parameter trees and their placements on a mesh
# ---------------------------------------------------------------------------

def _walk(defs: Defs, fn):
    return {k: (fn(v) if isinstance(v, ParamDef) else _walk(v, fn))
            for k, v in defs.items()}


def shape_tree(defs: Defs, dtype=torch.bfloat16):
    """The ``meta`` tensors of a ParamDef tree (the reference's
    ``ShapeDtypeStruct``\\ s)."""
    return _walk(defs, lambda d: torch.empty(d.shape, dtype=dtype,
                                             device="meta"))


def sharding_tree(defs: Defs, mesh, rules: Rules):
    """The :class:`~repro_torch.models.sharding.NamedSharding` of every
    leaf of a ParamDef tree by the rules."""
    return _walk(defs, lambda d: sharding_for(d.shape, d.logical, mesh,
                                              rules))


def param_logical(model: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """Every parameter's logical axis names, by its name in ``model``."""
    out: Dict[str, Tuple[Optional[str], ...]] = {}
    for mname, mod in model.named_modules():
        for pname, lg in getattr(mod, "logical", {}).items():
            out[f"{mname}.{pname}" if mname else pname] = lg
    return out


def place_params(model: nn.Module, mesh, rules: Rules) -> nn.Module:
    """Turn every parameter of ``model`` into a DTensor on ``mesh`` placed
    by its logical names, in place: a ``meta`` parameter becomes this
    rank's shard on ``meta`` (no data), any other is split from the whole
    tensor every rank holds (no communication: every rank must hold the
    same values); a DTensor parameter is redistributed where its
    placements differ."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    logical = param_logical(model)
    for name, p in list(model.named_parameters()):
        if name not in logical:
            raise KeyError(f"{name} has no logical axis names")
        spec = spec_for(tuple(p.shape), logical[name], mesh, rules)
        pl = placements_for(spec, mesh)
        if isinstance(p, DTensor):
            if list(p.placements) == pl:
                continue
            dt = p.detach().redistribute(mesh, pl)
        elif p.is_meta:
            loc = torch.empty(local_shape(p.shape, spec, mesh),
                              dtype=p.dtype, device="meta")
            dt = DTensor.from_local(loc, mesh, pl, run_check=False,
                                    shape=p.shape, stride=p.stride())
        else:
            dt = distribute_tensor(p.detach(), mesh, pl, src_data_rank=None)
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
    return model
