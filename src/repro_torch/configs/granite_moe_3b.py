"""granite-moe-3b-a800m — 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite/granite-3.0-*; hf]."""
from repro_torch.models.config import ModelConfig, MoEConfig

ARCH = "granite-moe-3b-a800m"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=0, vocab=49155, head_dim=64,
        tie_embeddings=True,
        moe=MoEConfig(n_experts=40, top_k=8, d_ff=512),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=0, vocab=515, head_dim=16,       # odd vocab kept odd on purpose
        tie_embeddings=True,
        moe=MoEConfig(n_experts=8, top_k=4, d_ff=32),
    )
