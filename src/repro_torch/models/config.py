"""Model configuration covering all assigned architecture families.

A copy of the JAX package's ``models/config.py`` (pure dataclasses), kept
here so the port imports nothing of that package.  One dataclass describes
dense / MoE / SSM / hybrid / VLM / audio LM backbones; per-arch instances
live in :mod:`repro_torch.configs`.  The model is
expressed as a Marrow SCT over the substrate —
``Pipeline(Embed, Loop(Block x L), Norm, LMHead)`` — so the paper's
locality-aware decomposition and distribution machinery applies uniformly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden size
    capacity_factor: float = 1.25
    router_softcap: float = 0.0   # 0 = off


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD configuration (arXiv:2405.21060)."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256              # SSD chunk length
    conv_dim: int = 4             # depthwise conv kernel width (stubbed slim)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    activation: str = "silu"      # silu | gelu | relu2
    gated_mlp: Optional[bool] = None   # default: gated for silu/gelu
    use_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    use_rope: bool = True
    max_pos: int = 0              # learned-position table size (use_rope=False)
    # attention variants
    sliding_window: Optional[int] = None       # SWA width (None = full)
    local_global_pattern: bool = False         # gemma2: alternate local/global
    attn_softcap: float = 0.0                  # gemma2 logit soft-capping
    final_softcap: float = 0.0
    attn_scale: Optional[float] = None
    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0                 # zamba2: attn block period
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500                     # fixed 30 s audio window
    # modality frontend stub (vlm / audio): #positions fed as embeddings
    frontend_positions: int = 0
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # training-recipe hint consumed by the launcher (minicpm: WSD)
    lr_schedule: str = "cosine"
    # embedding tables are padded to this multiple so the vocab dim shards
    # over the model axis (odd tokenizer vocabs: granite/minicpm/internvl2);
    # logits over padded ids are masked to -inf in ``unembed``
    vocab_pad_multiple: int = 128

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.gated_mlp is None:
            object.__setattr__(self, "gated_mlp",
                               self.activation in ("silu", "gelu"))
        if self.family in ("moe",) and self.moe is None:
            raise ValueError(f"{self.arch}: moe family needs MoEConfig")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.arch}: ssm/hybrid family needs SSMConfig")

    # ---- derived quantities ------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = max(self.vocab_pad_multiple, 1)
        return -(-self.vocab // m) * m

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_attention_layer(self, layer: int) -> bool:
        if self.family == "ssm":
            return False
        if self.family == "hybrid":
            p = max(self.hybrid_attn_every, 1)
            return (layer + 1) % p == 0
        return True

    def layer_window(self, layer: int) -> Optional[int]:
        """Sliding window of a layer (gemma2 alternates local/global)."""
        if self.local_global_pattern:
            return self.sliding_window if layer % 2 == 0 else None
        return self.sliding_window

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (assignment: SSM/hybrid/windowed only)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None and not self.enc_dec

    # ---- parameter counts (roofline MODEL_FLOPS = 6*N*D) --------------------
    def param_count(self) -> int:
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced-config variant (smoke tests)."""
        return dataclasses.replace(self, **kw)


def _ffn_params(cfg: ModelConfig, d_ff: int) -> int:
    if cfg.gated_mlp:                        # gated: w_in, w_gate, w_out
        return 3 * cfg.d_model * d_ff
    return 2 * cfg.d_model * d_ff            # non-gated: w_in, w_out


def _attn_params(cfg: ModelConfig) -> int:
    return (cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
            + cfg.q_dim * cfg.d_model)


def _ssm_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    # in_proj produces [z, x, B, C, dt]; out_proj back to d_model
    in_proj = cfg.d_model * (2 * di + 2 * s.d_state + nh)
    out_proj = di * cfg.d_model
    extra = di * s.conv_dim + 2 * nh + di   # conv, A/dt bias, skip D, norm
    return in_proj + out_proj + extra


def _layer_params(cfg: ModelConfig, layer: int, active_only: bool) -> int:
    n = 2 * cfg.d_model   # two norms
    if cfg.family == "ssm" or (cfg.family == "hybrid"
                               and not cfg.is_attention_layer(layer)):
        return n + _ssm_params(cfg)
    p = n + _attn_params(cfg)
    if cfg.moe is not None:
        per_expert = _ffn_params(cfg, cfg.moe.d_ff)
        router = cfg.d_model * cfg.moe.n_experts
        k = cfg.moe.top_k if active_only else cfg.moe.n_experts
        p += router + k * per_expert
    else:
        p += _ffn_params(cfg, cfg.d_ff)
    return p


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    total = cfg.vocab * cfg.d_model           # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab * cfg.d_model      # unembed
    total += cfg.d_model                      # final norm
    for l in range(cfg.n_layers):
        total += _layer_params(cfg, l, active_only)
    if cfg.enc_dec:
        for l in range(cfg.n_enc_layers):
            total += 2 * cfg.d_model + _attn_params(cfg) \
                + _ffn_params(cfg, cfg.d_ff)
        # decoder cross-attention blocks
        total += cfg.n_layers * (_attn_params(cfg) + cfg.d_model)
    return int(total)
