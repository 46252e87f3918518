"""nemotron-4-15b — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU non-gated MLP [arXiv:2402.16819; unverified]."""
from repro_torch.models.config import ModelConfig

ARCH = "nemotron-4-15b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab=256000, head_dim=128,
        activation="relu2",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab=512, head_dim=16,
        activation="relu2",
    )
