"""Assigned input shapes and per-cell applicability + input specs.

The four LM shapes (seq_len x global_batch):

  train_4k     4,096 x 256   runs ``train_step``
  prefill_32k  32,768 x 32   runs ``prefill`` (inference-prefill)
  decode_32k   32,768 x 128  runs ``decode_step`` (KV cache of seq_len)
  long_500k    524,288 x 1   runs ``decode_step``; sub-quadratic archs only

The port's counterpart of the JAX package's ``configs/shapes.py``.
``input_specs`` returns ``meta`` tensors (shapes and dtypes, no storage)
for every model input of a cell: what the dry-run's step runs on, as the
reference's ``jax.ShapeDtypeStruct``\\ s are what its dry-run lowers
against.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runs?, reason).  Skips follow the assignment rules:
    long_500k only for sub-quadratic archs (SSM / hybrid / windowed)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (f"{cfg.arch} is pure full-attention; 500k decode "
                       "needs sub-quadratic attention (assignment skip)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta tensors for the data inputs of one (arch x shape) cell.

    train:   tokens + labels (+ modality stubs)
    prefill: tokens (+ modality stubs)
    decode:  token + pos (the cache/params come from the model)
    """
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    out: Dict[str, torch.Tensor] = {}
    if shape.kind == "train":
        out["tokens"] = spec((B, S), i32)
        out["labels"] = spec((B, S), i32)
    elif shape.kind == "prefill":
        out["tokens"] = spec((B, S), i32)
    else:  # decode
        out["token"] = spec((B,), i32)
        out["pos"] = spec((), i32)
    # modality frontend stubs (assignment: precomputed frame/patch embeds)
    if shape.kind in ("train", "prefill"):
        if cfg.enc_dec:
            out["frames"] = spec((B, cfg.enc_frames, cfg.d_model), dtype)
        elif cfg.frontend_positions:
            out["frontend_embeds"] = spec(
                (B, cfg.frontend_positions, cfg.d_model), dtype)
    return out
