"""mamba2-1.3b — 48L d_model=2048, attention-free SSD (state-space
duality), ssm_state=128, vocab=50280 [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ModelConfig, SSMConfig

ARCH = "mamba2-1.3b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="ssm",
        n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280, head_dim=64,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=512, head_dim=16,
        tie_embeddings=True,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
    )
