"""minicpm-2b — 40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753,
llama-like dense arch trained with the WSD schedule [arXiv:2404.06395;
hf].  The WSD recipe is carried as ``lr_schedule`` and consumed by the
launcher (``repro_torch.optim.schedules.wsd_schedule``)."""
from repro_torch.models.config import ModelConfig

ARCH = "minicpm-2b"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab=122753, head_dim=64,
        tie_embeddings=True,
        lr_schedule="wsd",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=513, head_dim=16,
        tie_embeddings=True,
        lr_schedule="wsd",
    )
