"""gemma2-2b — 26L d_model=2304 8H (GQA kv=4) head_dim=256 d_ff=9216
vocab=256000; alternating local(4096)/global layers, logit softcaps,
tied embeddings [arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig

ARCH = "gemma2-2b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        d_ff=9216, vocab=256000, head_dim=256,
        activation="gelu",
        sliding_window=4096, local_global_pattern=True,
        attn_softcap=50.0, final_softcap=30.0,
        attn_scale=256 ** -0.5,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=32,
        activation="gelu",
        sliding_window=16, local_global_pattern=True,
        attn_softcap=50.0, final_softcap=30.0,
        attn_scale=32 ** -0.5,
        tie_embeddings=True,
    )
