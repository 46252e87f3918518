"""Per-(arch x shape) runtime knobs — the search space of the dry-run.

The port's counterpart of the JAX package's ``launch/cells.py``, field for
field: ``cell_runtime`` returns the *tuned defaults* for one cell, and a
caller overrides single knobs (``--set knob=value``).  The defaults encode
the paper's methodology: a knowledge base of per-(SCT, workload)
configurations — here a table keyed by (architecture, shape) with
derivation rules for unseen cells (size-class nearest neighbour, the
paper's Sec. 3.2.3 in miniature).

Every mesh applies ``microbatches``, ``remat``, ``remat_group``,
``remat_inner``, ``loss_chunks`` and ``cache_dtype``.  On a mesh of more
than one card (``repro_torch.launch.dryrun.build_cell`` on quad_2x2,
pod_32x8 or multipod_2x32x8) ``fsdp`` shards the weights' ``embed`` dim
over the data axes (gathered layer by layer), ``seq_shard`` the caches'
sequence over the model axis, and ``act_seq_shard`` the residual stream's
sequence over it (attention then takes each rank's queries, as the
reference's ``attention_sp`` does); the microbatches are clamped
by the data axes' size.  One card ignores those three.  ``donate`` stays
for parity: the port's steps update their state in place, so every mesh
ignores it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class CellConfig:
    """Runtime configuration of one (arch, shape) cell."""

    microbatches: int = 1
    remat: Optional[str] = "dots_no_batch"
    remat_group: int = 1
    remat_inner: Optional[str] = None
    loss_chunks: int = 1
    fsdp: bool = True            # mesh: shard weight 'embed' dim over data
    seq_shard: bool = False      # mesh: shard (cache_)seq over the model
    act_seq_shard: bool = False  # mesh: residual stream seq dim over model
    cache_dtype: str = "bf16"    # KV-cache storage ("bf16" | "f8")
    donate: bool = True          # the reference's buffer donation

    def replace(self, **kw) -> "CellConfig":
        return dataclasses.replace(self, **kw)


def size_class(cfg: ModelConfig) -> str:
    p = cfg.param_count()
    if p > 3.0e10:
        return "big"             # mixtral-8x22b, command-r-plus-104b
    if p > 8.0e9:
        return "mid"             # internvl2-26b, nemotron-4-15b
    return "small"


#: tuned per-(arch, shape) configurations, the reference's table entry for
#: entry (act_seq_shard: sequence parallelism on a mesh)
TUNED: Dict[Tuple[str, str], Dict] = {
    ("mixtral-8x22b", "train_4k"): {"microbatches": 8},
    ("nemotron-4-15b", "train_4k"): {"microbatches": 4},
    ("minicpm-2b", "prefill_32k"): {"act_seq_shard": True},
    ("gemma2-2b", "prefill_32k"): {"act_seq_shard": True},
    ("whisper-large-v3", "prefill_32k"): {"act_seq_shard": True},
    ("granite-moe-3b-a800m", "prefill_32k"): {"act_seq_shard": True},
    ("minicpm-2b", "train_4k"): {"act_seq_shard": True},
    ("gemma2-2b", "train_4k"): {"act_seq_shard": True},
    ("whisper-large-v3", "train_4k"): {"act_seq_shard": True},
}


def cell_runtime(cfg: ModelConfig, shape: ShapeSpec,
                 overrides: Optional[Dict] = None) -> CellConfig:
    sc = size_class(cfg)
    if shape.kind == "train":
        cell = CellConfig(
            microbatches={"big": 16, "mid": 8, "small": 4}[sc],
            remat="full",
            remat_group={"big": 8, "mid": 4, "small": 1}[sc],
            loss_chunks=8 if cfg.vocab >= 16_000 else 1,
            fsdp=True, seq_shard=False)
    elif shape.kind == "prefill":
        cell = CellConfig(
            microbatches=1, remat=None, loss_chunks=1,
            fsdp=(sc != "small"), seq_shard=True)
    else:  # decode
        cell = CellConfig(
            microbatches=1, remat=None, loss_chunks=1,
            fsdp=(sc != "small"), seq_shard=True,
            cache_dtype="bf16")
    tuned = TUNED.get((cfg.arch, shape.name))
    if tuned:
        cell = cell.replace(**tuned)
    if overrides:
        cell = cell.replace(**overrides)
    return cell
