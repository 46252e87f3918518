"""Carry a JAX-package parameter tree into the port's modules.

The JAX package keeps parameters as a nested dict of stacked arrays.  For
the hybrid family ``layers`` is ``{"mamba": leaves of shape (g, m, ...),
"attn": leaves of shape (g, ...)}``; for the plain stack (the moe family)
``layers`` is one block's tree with leaves of shape (L, ...).
:func:`from_jax_params` takes that tree as numpy arrays (``jax.device_get``
of it, or any array-likes ``numpy.asarray`` accepts) and returns an
:class:`~repro_torch.models.lm.LM` holding the same numbers: group ``i``'s
Mamba2 block ``j`` from index ``[i, j]`` and its attention block from
``[i]``, or block ``i`` of the plain stack from ``[i]``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params
from repro_torch.models.lm import LM


def _fill(module: Params, tree: Dict[str, Any], index: tuple,
          where: str) -> None:
    for name, value in tree.items():
        if name not in module:
            raise KeyError(f"{where}{name}: not a parameter of the port")
        if isinstance(value, dict):
            _fill(module[name], value, index, f"{where}{name}.")
            continue
        arr = np.asarray(value)[index] if index else np.asarray(value)
        param = module[name]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{where}{name}: shape {arr.shape} does not "
                             f"match the port's {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    missing = [n for n in list(module._parameters) + list(module._modules)
               if n not in tree]
    if missing:
        raise KeyError(f"{where}: no value for {missing}")


def from_jax_params(cfg: ModelConfig, tree: Dict[str, Any], *,
                    dtype: torch.dtype = torch.float32,
                    device: Optional[Any] = None) -> LM:
    """An ``LM`` of ``cfg`` holding the JAX package's parameters ``tree``."""
    model = LM(cfg, dtype=dtype, device=device)
    for top in ("embed", "final_norm"):
        _fill(getattr(model, top), tree[top], (), f"{top}.")
    layers = tree["layers"]
    for i, grp in enumerate(model.layers):
        if cfg.family != "hybrid":
            _fill(grp, layers, (i,), f"layers[{i}].")
            continue
        for j, blk in enumerate(grp.mamba):
            _fill(blk, layers["mamba"], (i, j), f"layers.mamba[{i},{j}].")
        _fill(grp.attn, layers["attn"], (i,), f"layers.attn[{i}].")
    extra = set(tree) - {"embed", "final_norm", "layers"}
    if extra:
        raise KeyError(f"parameters the port's {cfg.family} model does not "
                       f"have: {sorted(extra)}")
    return model
