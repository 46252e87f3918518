"""internvl2-26b — InternViT frontend (stub) + InternLM2-20B backbone:
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf].  The vision tower is a stub, as in the JAX
package: precomputed patch embeddings (``frontend_embeds``) replace the
first ``frontend_positions`` sequence positions."""
from repro_torch.models.config import ModelConfig

ARCH = "internvl2-26b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92553, head_dim=128,
        frontend_positions=256,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=515, head_dim=16,
        frontend_positions=8,
    )
