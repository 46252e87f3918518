"""whisper-large-v3 — enc-dec, 32+32L d_model=1280 20H (kv=20) d_ff=5120
vocab=51866 [arXiv:2212.04356; unverified].  The conv/log-mel audio
frontend is a stub, as in the JAX package: the encoder takes precomputed
frame embeddings (B, 1500, d); the decoder uses learned positions (no
rope) and non-gated GELU MLPs."""
from repro_torch.models.config import ModelConfig

ARCH = "whisper-large-v3"


def config() -> ModelConfig:
    return ModelConfig(
        arch=ARCH, family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866, head_dim=64,
        activation="gelu", gated_mlp=False, use_bias=True,
        enc_dec=True, n_enc_layers=32, enc_frames=1500,
        use_rope=False, max_pos=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch=ARCH + "-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, head_dim=16,
        activation="gelu", gated_mlp=False, use_bias=True,
        enc_dec=True, n_enc_layers=2, enc_frames=8,
        use_rope=False, max_pos=128,
    )
