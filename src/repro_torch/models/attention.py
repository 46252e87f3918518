"""GQA attention: prefill through the flash-attention kernel, cached decode.

Prefill attention goes through :func:`repro_torch.kernels.ops.flash_attention_bshd`:
the hand-written CUDA kernel on a CUDA tensor, its plain version
(``ref.attention_ref``) on any other.  It takes the place of the JAX
package's ``blockwise_attention`` (the jnp oracle of its Pallas kernel),
which computes the same function.  Decode attention and the cache update
stay plain PyTorch, as they are plain jnp in the JAX package; decode reads
the bf16 cache a block of rows at a time, so no float32 copy of a layer's
cache is made.

On a mesh (:mod:`repro_torch.models.spmd`) the block runs on local heads
where the rules shard them over the model axis (flash on H/model and
KV/model heads; a q head whose kv head is replicated meets its own,
``h // (H/KV)``); where the heads do not divide the axis and the layout
splits the residual stream's sequence over the model axis, each rank
takes its part of the sequence's queries against the whole sequence's
keys (the reference's ``attention_sp`` path, its query blocks pinned to
the model axis; the layout alone decides it here).
Decode over a cache whose rows are sharded merges the ranks' partial
softmaxes.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (NEG_INF, Defs, ParamDef, Params,
                                       apply_rope, softcap)

#: cache rows a decode step turns to float32 at a time
DECODE_ROWS = 4096


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
# On a mesh: local heads, or the sequence's queries split
# ---------------------------------------------------------------------------

def kv_heads(L, H: int, KV: int, device=None):
    """The kv heads this rank's query heads meet when the query heads are
    split over the model axis and the kv heads are not (q head h meets kv
    head ``h // (H/KV)``): a slice of them where the rank's heads make
    whole groups (or a whole group holds them), else one kv head per query
    head (an index)."""
    G, Hl = H // KV, H // L.tp_size
    first = L.tp_rank * Hl
    if G % Hl == 0 or Hl % G == 0:
        return slice(first // G, (first + Hl - 1) // G + 1)
    return torch.arange(first, first + Hl, device=device) // G


def _local_qkv(L, h: torch.Tensor, p: Params, cfg: ModelConfig, *,
               positions, rope: bool, kv_x=None, tp: bool):
    """q, k, v of the normed stream ``h`` (keys and values of ``kv_x``
    where given) with this rank's weights: the heads' own shards under
    ``tp``, every head otherwise.  Returns (q, k, v, k_full, v_full):
    under ``tp`` with replicated kv heads, k/v are the kv heads this
    rank's queries meet and k_full/v_full all of them."""
    ax = {L.tp: 1} if tp else None
    q = _project_heads(h, L.param(p["wq"], ax))
    if "bq" in p:
        q = q + L.param(p["bq"], {L.tp: 0} if tp else None)
    src = h if kv_x is None else kv_x
    kv_tp = tp and L.tp_dim(p["wk"]) == 1
    wk = L.param(p["wk"], ax if kv_tp else None, tp_partial=tp)
    wv = L.param(p["wv"], ax if kv_tp else None, tp_partial=tp)
    k, v = _project_heads(src, wk), _project_heads(src, wv)
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kf, vf = k, v
    if tp and not kv_tp:
        sel = kv_heads(L, p["wq"].shape[1], p["wk"].shape[1], k.device)
        k, v = k[:, :, sel], v[:, :, sel]
    return q, k, v, kf, vf


def _out_proj_local(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    H, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], H * hd) @ wo.reshape(H * hd, d)


def attention_sharded(L, h: torch.Tensor, p: Params, cfg: ModelConfig, *,
                      positions: torch.Tensor, causal: bool = True,
                      window: Optional[int] = None,
                      kv_x: Optional[torch.Tensor] = None, rope: bool = True):
    """One attention on a mesh: ``h`` is the normed residual stream, this
    rank's part of it (B/dp, S or S/model, d); ``positions`` its whole
    sequence's; ``kv_x`` a cross-attention's whole source (B/dp, F, d),
    replicated over the model axis.  Returns (the attention's output, this
    rank's part, before the residual add; (k, v) over the whole sequence:
    this rank's kv heads where the rules split them, else all of them)."""
    tp = L.tp_dim(p["wq"]) == 1
    if tp:
        hh = L.enter_tp(h)
        src = None if kv_x is None else L.copy_to_tp(kv_x)
        q, k, v, kf, vf = _local_qkv(L, hh, p, cfg, positions=positions,
                                     rope=rope, kv_x=src, tp=True)
        o = ops.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                     logit_cap=cfg.attn_softcap,
                                     scale=cfg.attn_scale)
        y = L.exit_tp(_out_proj_local(o, L.param(p["wo"], {L.tp: 0})))
        kv = (k, v) if L.tp_dim(p["wk"]) == 1 else (kf, vf)
    elif L.seq:
        S_l = h.shape[1]
        off = L.seq_offset(S_l)
        pos_l = positions[:, off:off + S_l] if kv_x is None else positions
        src = None if kv_x is None else L.copy_to_tp(kv_x)
        q, k, v, _, _ = _local_qkv(L, h, p, cfg, positions=pos_l,
                                   rope=rope, kv_x=src, tp=False)
        if kv_x is None:
            k, v = L.gather_seq(k), L.gather_seq(v)
        if causal:
            o = ops.flash_attention_offset_bshd(
                q, k[:, :off + S_l], v[:, :off + S_l], q_offset=off,
                window=window, logit_cap=cfg.attn_softcap,
                scale=cfg.attn_scale)
        else:
            o = ops.flash_attention_bshd(q, k, v, causal=False,
                                         window=window,
                                         logit_cap=cfg.attn_softcap,
                                         scale=cfg.attn_scale)
        y = _out_proj_local(o, L.param(p["wo"]))
        kv = (k, v)
    else:
        # heads replicated, the sequence whole: every rank all of it
        q, k, v, _, _ = _local_qkv(L, h, p, cfg, positions=positions,
                                   rope=rope, kv_x=kv_x, tp=False)
        o = ops.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                     logit_cap=cfg.attn_softcap,
                                     scale=cfg.attn_scale)
        y = _out_proj_local(o, L.param(p["wo"]))
        kv = (k, v)
    if "bo" in p:
        y = y + L.param(p["bo"])
    return y, kv


# ---------------------------------------------------------------------------
# Cached decode attention (one new token against a KV cache)
# ---------------------------------------------------------------------------

#: a decode step's position: a Python int, or a 0-d integer tensor on the
#: cache's device (read by the device alone, as a CUDA graph needs)
Position = Union[int, torch.Tensor]


def int_position(pos: Position) -> int:
    """``pos`` where only a Python int will do (the sharded decode step,
    which no graph captures): a tensor is refused, never read back."""
    if isinstance(pos, torch.Tensor):
        raise TypeError("the sharded decode step takes its position as a "
                        "Python int; a tensor position is for the "
                        "unsharded step (its CUDA graph)")
    return pos


def _decode_scores(q: torch.Tensor, k_cache: torch.Tensor, *,
                   pos: Position, window: Optional[int], logit_cap: float,
                   scale: Optional[float], row0: int = 0,
                   n_rows: Optional[int] = None) -> torch.Tensor:
    """The masked float32 scores (B,KV,G,rows) of one decode query over the
    cache's rows, read a block of :data:`DECODE_ROWS` rows at a time.  Row j
    of the cache is position ``row0 + j`` of a cache of ``n_rows`` rows."""
    B, _, H, hd = q.shape
    Scap, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    n_rows = Scap if n_rows is None else n_rows
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KV, G, hd).float()
    s = torch.empty((B, KV, G, Scap), dtype=torch.float32, device=q.device)
    for a in range(0, Scap, DECODE_ROWS):
        b = min(a + DECODE_ROWS, Scap)
        s[..., a:b] = torch.einsum("bkgh,bjkh->bkgj", qg,
                                   k_cache[:, a:b].to(q.dtype).float())
    s = softcap(s * sc, logit_cap)
    j = torch.arange(Scap, device=q.device) + row0
    valid = j <= pos
    if window is not None and n_rows > window:
        valid &= j > pos - window
    return s.masked_fill(~valid, NEG_INF)


def _weighted_values(p: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """sum_j p[..., j] v[:, j] in float32, a block of rows at a time:
    (B,KV,G,hd)."""
    Scap = v_cache.shape[1]
    o = None
    for a in range(0, Scap, DECODE_ROWS):
        b = min(a + DECODE_ROWS, Scap)
        part = torch.einsum("bkgj,bjkh->bkgh", p[..., a:b],
                            v_cache[:, a:b].float())
        o = part if o is None else o + part
    return o


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: Position,
                     window: Optional[int] = None, logit_cap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,1,H,hd); caches: (B,Scap,KV,hd); ``pos``: current position.

    For rolling (windowed) caches the caller guarantees Scap == window and
    positions are stored modulo the window; masking here is by validity
    count only.  Scores and the weighted sum are float32, as in the JAX
    package (bf16 products are exact in float32); the cache is read in its
    own dtype, a block of rows at a time."""
    B, _, H, hd = q.shape
    s = _decode_scores(q, k_cache, pos=pos, window=window,
                       logit_cap=logit_cap, scale=scale)
    p = torch.softmax(s, dim=-1)
    o = _weighted_values(p, v_cache)
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_rows(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, layout, *, pos: int,
                          n_rows: int, window: Optional[int] = None,
                          logit_cap: float = 0.0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """:func:`decode_attention` over a cache whose ``n_rows`` rows are
    sharded over the model axis (this rank's block starts at rank x
    rows): each rank's softmax over its rows, merged by the rows' maxima
    and sums over the axis."""
    B, _, H, hd = q.shape
    rows = k_cache.shape[1]
    s = _decode_scores(q, k_cache, pos=pos, window=window,
                       logit_cap=logit_cap, scale=scale,
                       row0=layout.tp_rank * rows, n_rows=n_rows)
    m = spmd.all_reduce(s.amax(-1), layout.mesh, (layout.tp,), "max")
    p = torch.exp(s - m[..., None])
    den = spmd.all_reduce(p.sum(-1), layout.mesh, (layout.tp,))
    o = spmd.all_reduce(_weighted_values(p, v_cache), layout.mesh,
                        (layout.tp,))
    return (o / den[..., None]).reshape(B, 1, H, hd).to(q.dtype)


def decode_sharded(L, h: torch.Tensor, p: Params, cfg: ModelConfig, *,
                   k_cache: torch.Tensor, v_cache: torch.Tensor,
                   cache_kind: str, n_rows: int, pos: int,
                   window: Optional[int], write: bool = True,
                   rope: bool = True) -> torch.Tensor:
    """One decode step's attention on a mesh: ``h`` the normed stream
    (B/dp, 1, d), the caches this rank's block of a layer's, laid out as
    ``cache_kind`` says: ``"rows"`` (rows over the model axis, every
    head), ``"heads"`` (this rank's kv heads) or ``"all"``.  The token's
    k/v are written first (``write``: self-attention), at ``pos`` (modulo
    the rows of a rolling cache).  Returns the attention's output before
    the residual add, replicated over the model axis."""
    pos = int_position(pos)
    tp = L.tp_dim(p["wq"]) == 1
    H, KV = p["wq"].shape[1], p["wk"].shape[1]
    positions = torch.full((1, 1), pos, device=h.device)
    q = _project_heads(h, L.param(p["wq"], {L.tp: 1} if tp else None))
    if "bq" in p:
        q = q + L.param(p["bq"], {L.tp: 0} if tp else None)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    if write:
        ax = {L.tp: 1} if cache_kind == "heads" else None
        k = _project_heads(h, L.param(p["wk"], ax))
        v = _project_heads(h, L.param(p["wv"], ax))
        if rope:
            k = apply_rope(k, positions, cfg.rope_theta)
        rolling = window is not None and n_rows == window
        idx = pos % n_rows if rolling else min(max(pos, 0), n_rows - 1)
        if cache_kind == "rows":
            row0 = L.tp_rank * k_cache.shape[1]
            if row0 <= idx < row0 + k_cache.shape[1]:
                k_cache[:, idx - row0] = k[:, 0].to(k_cache.dtype)
                v_cache[:, idx - row0] = v[:, 0].to(v_cache.dtype)
        else:
            k_cache[:, idx] = k[:, 0].to(k_cache.dtype)
            v_cache[:, idx] = v[:, 0].to(v_cache.dtype)
    kw = dict(logit_cap=cfg.attn_softcap, scale=cfg.attn_scale)
    if cache_kind == "rows":
        qf = spmd.all_gather(q, L.mesh, L.tp, 2) if tp else q
        o = decode_attention_rows(qf, k_cache, v_cache, L, pos=pos,
                                  n_rows=n_rows, window=window, **kw)
        if tp:
            Hl = H // L.tp_size
            o = o[:, :, L.tp_rank * Hl:(L.tp_rank + 1) * Hl]
    elif tp and cache_kind == "all":
        sel = kv_heads(L, H, KV, q.device)
        o = decode_attention(q, k_cache[:, :, sel], v_cache[:, :, sel],
                             pos=pos, window=window, **kw)
    else:
        o = decode_attention(q, k_cache, v_cache, pos=pos, window=window,
                             **kw)
    if tp:
        y = spmd.all_reduce(_out_proj_local(o, L.param(p["wo"],
                                                       {L.tp: 0})),
                            L.mesh, (L.tp,))
    else:
        y = _out_proj_local(o, L.param(p["wo"]))
    if "bo" in p:
        y = y + L.param(p["bo"])
    return y


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, pos: Position,
                 window: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one (B,1,KV,hd) k/v at ``pos`` (modulo window for rolling),
    in place.  A position past the end is clamped to the last row, as
    ``jax.lax.dynamic_update_slice`` clamps it in the JAX package; a tensor
    position is reduced and clamped on the device."""
    Scap = k_cache.shape[1]
    idx = pos % Scap if (window is not None and Scap == window) else pos
    if isinstance(idx, torch.Tensor):
        idx = idx.clamp(0, Scap - 1).long().view(1)
        k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
        v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
        return k_cache, v_cache
    idx = min(max(idx, 0), Scap - 1)
    k_cache[:, idx] = k[:, 0].to(k_cache.dtype)
    v_cache[:, idx] = v[:, 0].to(v_cache.dtype)
    return k_cache, v_cache
