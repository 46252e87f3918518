"""command-r-plus-104b — 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000, no-bias GQA [hf:CohereForAI/c4ai-command-r-v01;
unverified]."""
from repro_torch.models.config import ModelConfig

ARCH = "command-r-plus-104b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="dense",
        n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
        d_ff=33792, vocab=256000, head_dim=128,
        use_bias=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=256, vocab=512, head_dim=16,
    )
