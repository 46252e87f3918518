"""Carry a JAX-package parameter tree into the port's modules.

The JAX package keeps parameters as a nested dict of stacked arrays.  Its
``layers`` is, by family:

  * ssm (mamba2), and the plain stack (the dense, vlm and moe families):
    one block's tree with leaves of shape (L, ...);
  * hybrid (zamba2): ``{"mamba": leaves of shape (g, m, ...), "attn":
    leaves of shape (g, ...)}``;
  * local/global pairs (gemma2): ``{"local": leaves of shape (pairs, ...),
    "global": leaves of shape (pairs, ...)}``;
  * the encoder-decoder (whisper): the decoder's blocks, with their
    cross-attention, as the plain stack's, beside ``encoder`` (``layers``
    with leaves of shape (n_enc_layers, ...), ``final_norm``) and the
    learned positions ``pos_embed`` (max_pos, d).

:func:`from_jax_params` takes that tree as numpy arrays (``jax.device_get``
of it, or any array-likes ``numpy.asarray`` accepts) and returns an
:class:`~repro_torch.models.lm.LM` holding the same numbers: block ``i``
of a stack from index ``[i]``, group ``i``'s Mamba2 block ``j`` from
``[i, j]`` and its attention block from ``[i]``, pair ``i``'s two blocks
from ``[i]`` of ``local`` and of ``global``, encoder block ``i`` from
``[i]`` of ``encoder/layers``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params
from repro_torch.models.lm import LM


def _copy(param: torch.Tensor, value: Any, where: str) -> None:
    arr = np.asarray(value)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(f"{where}: shape {arr.shape} does not match the "
                         f"port's {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))


def _fill(module: Params, tree: Dict[str, Any], index: tuple,
          where: str) -> None:
    for name, value in tree.items():
        if name not in module:
            raise KeyError(f"{where}{name}: not a parameter of the port")
        if isinstance(value, dict):
            _fill(module[name], value, index, f"{where}{name}.")
            continue
        _copy(module[name], np.asarray(value)[index] if index else value,
              f"{where}{name}")
    missing = [n for n in list(module._parameters) + list(module._modules)
               if n not in tree]
    if missing:
        raise KeyError(f"{where}: no value for {missing}")


def from_jax_params(cfg: ModelConfig, tree: Dict[str, Any], *,
                    dtype: torch.dtype = torch.float32,
                    device: Optional[Any] = None) -> LM:
    """An ``LM`` of ``cfg`` holding the JAX package's parameters ``tree``."""
    model = LM(cfg, dtype=dtype, device=device)
    known = {"embed", "final_norm", "layers"}
    for top in ("embed", "final_norm"):
        _fill(getattr(model, top), tree[top], (), f"{top}.")
    if not cfg.use_rope:
        known.add("pos_embed")
        _copy(model.pos_embed, tree["pos_embed"], "pos_embed")
    if cfg.enc_dec:
        known.add("encoder")
        enc = tree["encoder"]
        for i, blk in enumerate(model.encoder.layers):
            _fill(blk, enc["layers"], (i,), f"encoder.layers[{i}].")
        _fill(model.encoder.final_norm, enc["final_norm"], (),
              "encoder.final_norm.")
        if set(enc) != {"layers", "final_norm"}:
            raise KeyError(f"encoder: parameters the port does not have: "
                           f"{sorted(set(enc) - {'layers', 'final_norm'})}")
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
    extra = set(tree) - known
    if extra:
        raise KeyError(f"parameters the port's {cfg.family} model does not "
                       f"have: {sorted(extra)}")
    return model
