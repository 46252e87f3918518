"""Architecture registry of the port: ``--arch <id>`` resolution.

It holds all ten architectures of the JAX package, whisper-large-v3's
encoder-decoder among them.  ``get_config(name)`` returns the published configuration,
``get_smoke(name)`` a reduced same-family variant for CPU tests; any other
name raises ``KeyError`` naming the architectures the port has.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (command_r_plus, gemma2_2b, granite_moe_3b,
                                 internvl2_26b, mamba2_1_3b, minicpm_2b,
                                 mixtral_8x22b, nemotron_4_15b,
                                 whisper_large_v3, zamba2_2_7b)
from repro_torch.models.config import ModelConfig

_MODULES = (zamba2_2_7b, granite_moe_3b, mamba2_1_3b, minicpm_2b, gemma2_2b,
            nemotron_4_15b, internvl2_26b, command_r_plus, mixtral_8x22b,
            whisper_large_v3)

ARCHS: Dict[str, object] = {m.ARCH: m for m in _MODULES}


def arch_names() -> List[str]:
    return list(ARCHS.keys())


def _module(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; the port has: "
                       f"{arch_names()}")
    return ARCHS[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke()


__all__ = ["ARCHS", "arch_names", "get_config", "get_smoke"]
