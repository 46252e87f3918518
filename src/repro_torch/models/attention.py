"""GQA attention: prefill through the flash-attention kernel, cached decode.

Prefill attention goes through :func:`repro_torch.kernels.ops.flash_attention_bshd`:
the hand-written CUDA kernel on a CUDA tensor, its plain version
(``ref.attention_ref``) on any other.  It takes the place of the JAX
package's ``blockwise_attention`` (the jnp oracle of its Pallas kernel),
which computes the same function.  Decode attention and the cache update
stay plain PyTorch, as they are plain jnp in the JAX package.  The
mesh-only sequence-parallel context (``attention_sp``) is left out.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (NEG_INF, Defs, ParamDef, Params,
                                       apply_rope, softcap)


def attn_defs(cfg: ModelConfig) -> Defs:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs: Defs = {
        "wq": ParamDef((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.use_bias:
        defs["bq"] = ParamDef((H, hd), ("heads", "head_dim"), 0.0)
        defs["bo"] = ParamDef((d,), ("embed",), 0.0)
    return defs


def _project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,d) x (d,H,hd) -> (B,S,H,hd), contiguous."""
    d, H, hd = w.shape
    return (x @ w.reshape(d, H * hd)).view(*x.shape[:-1], H, hd)


def query(x: torch.Tensor, p: Params) -> torch.Tensor:
    """The query projection alone, (B,S,d) -> (B,S,H,hd), with its bias
    (a decode step's cross-attention reads its keys from the cache)."""
    q = _project_heads(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    return q


def qkv(x: torch.Tensor, p: Params, cfg: ModelConfig,
        positions: Optional[torch.Tensor] = None,
        kv_x: Optional[torch.Tensor] = None,
        rope: bool = True
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project to (B,S,H,hd) / (B,Skv,KV,hd); optionally rope."""
    src = x if kv_x is None else kv_x
    q = query(x, p)
    k = _project_heads(src, p["wk"])
    v = _project_heads(src, p["wv"])
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(o: torch.Tensor, p: Params) -> torch.Tensor:
    H, hd, d = p["wo"].shape
    y = o.reshape(*o.shape[:-2], H * hd) @ p["wo"].reshape(H * hd, d)
    if "bo" in p:
        y = y + p["bo"]
    return y


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: ModelConfig, *, causal: bool = True,
                      window: Optional[int] = None) -> torch.Tensor:
    """q (B,S,H,hd), k/v (B,S,KV,hd) -> (B,S,H,hd): the flash kernel (or
    its plain version, by device) with the model's softcap and scale."""
    return ops.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                    logit_cap=cfg.attn_softcap,
                                    scale=cfg.attn_scale)


# ---------------------------------------------------------------------------
# Cached decode attention (one new token against a KV cache)
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: int,
                     window: Optional[int] = None, logit_cap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,1,H,hd); caches: (B,Scap,KV,hd); ``pos``: current position.

    For rolling (windowed) caches the caller guarantees Scap == window and
    positions are stored modulo the window; masking here is by validity
    count only.  Scores and the weighted sum are float32, as in the JAX
    package (bf16 products are exact in float32)."""
    B, _, H, hd = q.shape
    Scap, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgh,bjkh->bkgj", qg,
                     k_cache.to(q.dtype).float()) * sc
    s = softcap(s, logit_cap)
    j = torch.arange(Scap, device=q.device)
    valid = j <= pos
    if window is not None and Scap > window:
        valid &= j > pos - window
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgj,bjkh->bkgh", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, pos: int,
                 window: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one (B,1,KV,hd) k/v at ``pos`` (modulo window for rolling),
    in place.  A position past the end is clamped to the last row, as
    ``jax.lax.dynamic_update_slice`` clamps it in the JAX package."""
    Scap = k_cache.shape[1]
    idx = pos % Scap if (window is not None and Scap == window) else pos
    idx = min(max(idx, 0), Scap - 1)
    k_cache[:, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[:, idx] = v[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
