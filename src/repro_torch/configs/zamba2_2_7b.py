"""zamba2-2.7b — 54L hybrid: Mamba2 blocks with a (shared-pattern)
attention block every 6 layers; d_model=2560 32H (kv=32) d_ff=10240
vocab=32000 ssm_state=64 [arXiv:2411.15242; hf].  The attention blocks
are instantiated unshared (per-group weights), as in the JAX package."""
from repro_torch.models.config import ModelConfig, SSMConfig

ARCH = "zamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000, head_dim=80,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=256),
        hybrid_attn_every=6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, head_dim=16,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
        hybrid_attn_every=2,
    )
