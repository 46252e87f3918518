"""LM substrate of the port: configs, layers, attention, Mamba2 (SSD), the
MoE FFN and the model assembly of every decoder family (dense, local/global
pairs, VLM, MoE, SSM, hybrid), with prefill through the hand-written flash
attention, SSD scan and grouped GEMM kernels on CUDA."""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import ParamDef, Params
from repro_torch.models.lm import (LM, cache_defs, decode_step, init_cache,
                                   prefill)

__all__ = ["LM", "ModelConfig", "MoEConfig", "ParamDef", "Params",
           "SSMConfig", "cache_defs", "decode_step", "from_jax_params",
           "init_cache", "prefill"]
