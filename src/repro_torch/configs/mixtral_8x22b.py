"""mixtral-8x22b — 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088; hf]."""
from repro_torch.models.config import ModelConfig, MoEConfig

ARCH = "mixtral-8x22b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=0, vocab=32768, head_dim=128,
        sliding_window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=0, vocab=512, head_dim=16,
        sliding_window=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=96),
    )
