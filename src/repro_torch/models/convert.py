"""Carry a JAX-package parameter tree into the port's modules.

The JAX package keeps parameters as a nested dict of stacked arrays.  Its
``layers`` is, by family:

  * ssm (mamba2), and the plain stack (the dense, vlm and moe families):
    one block's tree with leaves of shape (L, ...);
  * hybrid (zamba2): ``{"mamba": leaves of shape (g, m, ...), "attn":
    leaves of shape (g, ...)}``;
  * local/global pairs (gemma2): ``{"local": leaves of shape (pairs, ...),
    "global": leaves of shape (pairs, ...)}``.

:func:`from_jax_params` takes that tree as numpy arrays (``jax.device_get``
of it, or any array-likes ``numpy.asarray`` accepts) and returns an
:class:`~repro_torch.models.lm.LM` holding the same numbers: block ``i``
of a stack from index ``[i]``, group ``i``'s Mamba2 block ``j`` from
``[i, j]`` and its attention block from ``[i]``, pair ``i``'s two blocks
from ``[i]`` of ``local`` and of ``global``.
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
        if cfg.family == "hybrid":
            for j, blk in enumerate(grp.mamba):
                _fill(blk, layers["mamba"], (i, j),
                      f"layers.mamba[{i},{j}].")
            _fill(grp.attn, layers["attn"], (i,), f"layers.attn[{i}].")
        elif cfg.local_global_pattern:
            for side in ("local", "global"):
                _fill(grp._modules[side], layers[side], (i,),
                      f"layers.{side}[{i}].")
        else:
            _fill(grp, layers, (i,), f"layers[{i}].")
    extra = set(tree) - {"embed", "final_norm", "layers"}
    if extra:
        raise KeyError(f"parameters the port's {cfg.family} model does not "
                       f"have: {sorted(extra)}")
    return model
