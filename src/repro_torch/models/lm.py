"""Model assembly of every family of the JAX package: the ``ssm`` family
(mamba2: a stack of Mamba2 blocks), the ``hybrid`` family (zamba2: Mamba2
blocks with an attention block every ``hybrid_attn_every`` layers),
gemma2's pairs of a local (sliding-window) and a global attention block,
the plain stack of attention blocks, whose FFN is an MLP (the ``dense``
and ``vlm`` families) or a mixture of experts (the ``moe`` family), and
the encoder-decoder (the ``audio`` family, whisper).  A VLM's frontend is
a stub, as in the JAX package: precomputed embeddings
(``frontend_embeds``) replace the first ``frontend_positions`` positions.
So is the audio frontend: the encoder takes precomputed frame embeddings
(``frames``, (B, enc_frames, d_model)), adds fixed sinusoids and runs
attention blocks without a mask; each decoder block attends to the
encoder's output after its own causal attention.  A model without rope
(whisper's decoder) adds learned positions (``pos_embed``) to its token
embeddings.

The JAX package scans over stacked per-layer parameters; here the stack
is a Python loop over an ``nn.ModuleList``: ``LM.layers`` holds
``n_layers`` :class:`MambaBlock`\\ s for the ssm family, one
:class:`HybridGroup` per period (``period - 1`` :class:`MambaBlock`\\ s and
one :class:`AttnBlock`) for the hybrid family, ``n_layers / 2``
:class:`LocalGlobalPair`\\ s for local/global pairs, and ``n_layers``
:class:`AttnBlock`\\ s for the plain stack and the decoder of the
encoder-decoder, whose :class:`Encoder` is ``LM.encoder``.  Entry points,
as in the JAX package:

  * :meth:`LM.forward`  — full-sequence logits,
  * :func:`forward_backbone` / :func:`forward_train` — the training
    forward: final hidden states (or logits) and the MoE aux loss, with
    the reference's activation-checkpointing ("remat") policies,
  * :func:`prefill`     — fills the decode cache, returns last-token logits,
  * :func:`decode_step` — one token in, logits out, cache updated.

The decode cache keeps the JAX package's key names, layout and dtypes
(``h`` float32, the rest bfloat16); :func:`decode_step` updates it in
place (the JAX engine donates it) and returns it.  An encoder-decoder's
cache also holds each decoder layer's cross-attention keys and values
over the frames (``xk``, ``xv``), written by the prefill and read, never
changed, by the decode steps.  The prefill writes each layer's rows into
the cache allocated once at capacity (the reference's scan writes its
stacked output), so no layer's k/v or SSM state is held twice.

On a mesh (:mod:`repro_torch.models.spmd`) the parameters are DTensors
placed by the logical rules and the entry points take DTensor inputs:
each block computes on this rank's shards, the residual stream is pinned
to ``act_spec`` at every layer, and the cache is a dict of DTensors whose
blocks each layer reads and writes.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops
from repro_torch.models import spmd
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (Position, attention_sharded,
                                          attn_defs, decode_sharded,
                                          int_position, out_proj,
                                          prefill_attention, qkv, query)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Defs, ParamDef, Params, embed,
                                       embed_defs, mask_padded_vocab, mlp,
                                       mlp_defs, new_parameter, rmsnorm,
                                       rmsnorm_def, rope_frequencies,
                                       softcap, unembed,
                                       unembed_weight, vocab_sharded)
from repro_torch.models.moe import moe_defs, moe_ffn
from repro_torch.models.sharding import (Rules, contiguous_stride,
                                         local_shape, placements_for,
                                         spec_for)

Cache = Dict[str, torch.Tensor]

#: the families of the JAX package, every one of which the port runs
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.arch}: unknown family {cfg.family!r}; the "
                         f"port has {FAMILIES}")


def _hybrid_groups(cfg: ModelConfig) -> Tuple[int, int]:
    period = max(cfg.hybrid_attn_every, 1)
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.arch}: n_layers {cfg.n_layers} not a "
                         f"multiple of hybrid period {period}")
    return cfg.n_layers // period, period - 1


def attn_block_defs(cfg: ModelConfig, *, cross: bool = False) -> Defs:
    d: Defs = {"ln1": rmsnorm_def(cfg.d_model), "attn": attn_defs(cfg),
               "ln2": rmsnorm_def(cfg.d_model)}
    if cfg.moe is not None:
        d["moe"] = moe_defs(cfg)
    else:
        d["ffn"] = mlp_defs(cfg)
    if cross:
        d["ln_x"] = rmsnorm_def(cfg.d_model)
        d["xattn"] = attn_defs(cfg)
    return d


def pos_embed_def(cfg: ModelConfig) -> ParamDef:
    """The learned position table of a model without rope."""
    return ParamDef((max(cfg.max_pos, 1), cfg.d_model), (None, "embed"),
                    0.02)


def mamba_block_defs(cfg: ModelConfig) -> Defs:
    return {"ln1": rmsnorm_def(cfg.d_model), "ssm": ssm_mod.ssm_defs(cfg)}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

class AttnBlock(Params):
    """Pre-norm attention + FFN block (``ln1``, ``attn``, ``ln2``, and
    ``ffn`` or, with a MoE config, ``moe``).  A decoder block of the
    encoder-decoder (``cross=True``) also holds its cross-attention
    (``ln_x``, ``xattn``), run between its attention and its FFN."""

    def __init__(self, cfg: ModelConfig, *, cross: bool = False, **kw):
        super().__init__(attn_block_defs(cfg, cross=cross), **kw)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                causal: bool = True, window: Optional[int] = None,
                enc: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """(y, kv): the attention's k and v, and given the encoder's output
        ``enc``, the cross-attention's k and v over it after them."""
        y, kv = _attn_part(self, x, self.cfg, positions=positions,
                           causal=causal, window=window)
        if enc is not None:
            y, xkv = _cross_part(self, y, self.cfg, enc)
            kv = kv + xkv
        return _ffn_part(self, y, self.cfg), kv

    def decode(self, x: torch.Tensor, *, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: Position, window: Optional[int],
               freqs: Optional[torch.Tensor] = None,
               xk: Optional[torch.Tensor] = None,
               xv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One decode step; with the cache's cross-attention keys and values
        ``xk``/``xv`` (B, frames, KV, hd), the cross-attention over
        them.  Unsharded, through the decode kernels' entries in ``ops``:
        the norms (each after its residual add), q and k rotated by the
        model's frequency table ``freqs`` (none without rope) with the
        cache write, the attention."""
        cfg = self.cfg
        L = spmd.current()
        if L is not None:
            h = rmsnorm(x, self["ln1"]["scale"], cfg.norm_eps)
            return self._decode_sharded(L, x, h, k_cache, v_cache, pos,
                                        window, xk, xv)
        eps, kw = cfg.norm_eps, dict(logit_cap=cfg.attn_softcap,
                                     scale=cfg.attn_scale)
        h = ops.rmsnorm(x, self["ln1"]["scale"], eps)
        q, k, v = qkv(h, self["attn"], cfg)
        q = ops.rope_cache_write(q, k, v, k_cache, v_cache, pos,
                                 freqs=freqs if cfg.use_rope else None,
                                 window=window)
        o = ops.decode_attention(q, k_cache, v_cache, pos=pos, window=window,
                                 **kw)
        y = out_proj(o, self["attn"])
        if xk is not None:
            # the cross-attention over the frames the prefill cached (in
            # bf16, as the JAX package reads them), every frame valid
            x, h = ops.rmsnorm(y, self["ln_x"]["scale"], eps, residual=x)
            o = ops.decode_attention(query(h, self["xattn"]), xk, xv,
                                     pos=xk.shape[1] - 1, **kw)
            y = out_proj(o, self["xattn"])
        x, h = ops.rmsnorm(y, self["ln2"]["scale"], eps, residual=x)
        return x + _ffn_out(self, h, cfg)

    def _decode_sharded(self, L, x, h, k_cache, v_cache, pos, window, xk,
                        xv) -> torch.Tensor:
        """:meth:`decode` on a mesh: each cache is a :class:`CacheBlock`,
        this rank's block of the layer's (:func:`decode_sharded`)."""
        cfg = self.cfg
        kc, kind, rows = k_cache
        y = x + decode_sharded(L, h, self["attn"], cfg, k_cache=kc,
                               v_cache=v_cache[0], cache_kind=kind,
                               n_rows=rows, pos=pos, window=window,
                               rope=cfg.use_rope)
        if xk is not None:
            hx = rmsnorm(y, self["ln_x"]["scale"], cfg.norm_eps)
            xkc, xkind, xrows = xk
            y = y + decode_sharded(L, hx, self["xattn"], cfg, k_cache=xkc,
                                   v_cache=xv[0], cache_kind=xkind,
                                   n_rows=xrows,
                                   pos=xrows - 1, window=None, write=False,
                                   rope=False)
        return _ffn_part(self, y, cfg)


def _attn_part(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, causal: bool,
               window: Optional[int] = None):
    h = rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
    L = spmd.current()
    if L is not None:
        y, kv = attention_sharded(L, h, p["attn"], cfg, positions=positions,
                                  causal=causal, window=window,
                                  rope=cfg.use_rope)
        return x + y, kv
    q, k, v = qkv(h, p["attn"], cfg, positions=positions, rope=cfg.use_rope)
    o = prefill_attention(q, k, v, cfg, causal=causal, window=window)
    return x + out_proj(o, p["attn"]), (k, v)


def _cross_part(p: Params, y: torch.Tensor, cfg: ModelConfig,
                enc: torch.Tensor):
    """A decoder block's residual cross-attention: queries from its own
    stream, keys and values from the encoder's output ``enc``, no mask.
    Returns (y, (k, v)) with those keys and values."""
    h = rmsnorm(y, p["ln_x"]["scale"], cfg.norm_eps)
    L = spmd.current()
    if L is not None:
        o, kv = attention_sharded(L, h, p["xattn"], cfg, positions=None,
                                  causal=False, kv_x=enc, rope=False)
        return y + o, kv
    q, k, v = qkv(h, p["xattn"], cfg, kv_x=enc, rope=False)
    o = prefill_attention(q, k, v, cfg, causal=False)
    return y + out_proj(o, p["xattn"]), (k, v)


def _ffn_aux(p: Params, x: torch.Tensor, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual FFN and its aux loss (the MoE router's; 0 for an
    MLP)."""
    h = rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_ffn(h, p["moe"], cfg)
    else:
        y = mlp(h, p["ffn"], cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def _ffn_out(p: Params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The FFN of the normed stream ``h``, without its residual (the MoE
    aux loss dropped: a decode step's)."""
    return moe_ffn(h, p["moe"], cfg)[0] if "moe" in p else mlp(h, p["ffn"],
                                                                cfg)


def _ffn_part(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The residual FFN; the MoE aux loss is dropped (serving only)."""
    return _ffn_aux(p, x, cfg)[0]


def attn_block_train(blk: "AttnBlock", x: torch.Tensor, *,
                     positions: torch.Tensor, window: Optional[int] = None,
                     enc: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal attention block of the training forward, with its
    cross-attention over ``enc`` where given: (y, aux)."""
    y, _ = _attn_part(blk, x, blk.cfg, positions=positions, causal=True,
                      window=window)
    if enc is not None:
        y, _ = _cross_part(blk, y, blk.cfg, enc)
    return _ffn_aux(blk, y, blk.cfg)


class MambaBlock(Params):
    """Pre-norm Mamba2 block (``ln1``, ``ssm``)."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__(mamba_block_defs(cfg), **kw)
        self.cfg = cfg

    def forward(self, x: torch.Tensor, *, h0=None, conv0=None):
        h = rmsnorm(x, self["ln1"]["scale"], self.cfg.norm_eps)
        y, h_fin, conv = ssm_mod.ssd_prefill(h, self["ssm"], self.cfg,
                                             h0=h0, conv_state=conv0)
        return x + y, h_fin, conv

    def decode(self, x: torch.Tensor, *, h: torch.Tensor,
               conv_state: Dict[str, torch.Tensor]):
        """One decode step; ``h`` and the conv buffers are updated in
        place (``ssm.ssd_decode``)."""
        norm = rmsnorm if spmd.current() is not None else ops.rmsnorm
        hn = norm(x, self["ln1"]["scale"], self.cfg.norm_eps)
        y, hs, conv = ssm_mod.ssd_decode(hn, self["ssm"], self.cfg, h=h,
                                         conv_state=conv_state)
        return x + y, hs, conv


class LocalGlobalPair(nn.Module):
    """gemma2's pair: a local (sliding-window) attention block, then a
    global one.  The children are named ``local`` and ``global`` with
    nothing between them and the pair, so the parameters' JAX paths are
    ``layers/local/...`` and ``layers/global/...`` (``global`` is a Python
    keyword: the second block is read as ``pair.global_``)."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.local = AttnBlock(cfg, **kw)
        self.add_module("global", AttnBlock(cfg, **kw))

    @property
    def global_(self) -> AttnBlock:
        return self._modules["global"]


class HybridGroup(nn.Module):
    """One period of the hybrid stack: ``period - 1`` Mamba2 blocks, then
    one attention block."""

    def __init__(self, cfg: ModelConfig, n_mamba: int, **kw):
        super().__init__()
        self.mamba = nn.ModuleList(MambaBlock(cfg, **kw)
                                   for _ in range(n_mamba))
        self.attn = AttnBlock(cfg, **kw)


class Encoder(nn.Module):
    """The encoder of the encoder-decoder family: ``layers``, its
    ``n_enc_layers`` attention blocks (run without a mask), and
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.layers = nn.ModuleList(AttnBlock(cfg, **kw)
                                    for _ in range(cfg.n_enc_layers))
        self.final_norm = Params(rmsnorm_def(cfg.d_model), **kw)


class LM(nn.Module):
    """A model of any family: ``embed``, ``pos_embed`` (without rope: the
    learned positions), ``encoder`` (the encoder-decoder's), ``layers``
    and ``final_norm``, under the JAX package's names.  ``generator``
    draws the parameters by the JAX package's scale rules; without one
    they are left uninitialised."""

    def __init__(self, cfg: ModelConfig, *, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.embed = Params(embed_defs(cfg), **kw)
        #: logical axis names of the parameters held here directly
        self.logical: Dict[str, Tuple[Optional[str], ...]] = {}
        if not cfg.use_rope:
            self.pos_embed = new_parameter(pos_embed_def(cfg), **kw)
            self.logical["pos_embed"] = pos_embed_def(cfg).logical
        if cfg.enc_dec:
            self.encoder = Encoder(cfg, **kw)
            layers = [AttnBlock(cfg, cross=True, **kw)
                      for _ in range(cfg.n_layers)]
        elif cfg.family == "ssm":
            layers = [MambaBlock(cfg, **kw) for _ in range(cfg.n_layers)]
        elif cfg.family == "hybrid":
            g, m = _hybrid_groups(cfg)
            layers = [HybridGroup(cfg, m, **kw) for _ in range(g)]
        elif cfg.local_global_pattern:
            layers = [LocalGlobalPair(cfg, **kw)
                      for _ in range(cfg.n_layers // 2)]
        else:
            layers = [AttnBlock(cfg, **kw) for _ in range(cfg.n_layers)]
        self.layers = nn.ModuleList(layers)
        self.final_norm = Params(rmsnorm_def(cfg.d_model), **kw)

    def forward(self, tokens: torch.Tensor, **extras) -> torch.Tensor:
        """tokens (B,S) -> logits (B,S,V)."""
        return forward_train(self, tokens, **extras)[0]


def _embed_input(model: LM, tokens: torch.Tensor,
                 extras: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The token embeddings; for a frontend, its precomputed embeddings
    (``extras["frontend_embeds"]``, (B, P, d)) replace the first P
    positions; without rope, the learned positions 0 .. S-1 are added in
    the embeddings' dtype."""
    cfg = model.cfg
    x = embed(tokens, model.embed, cfg)
    if cfg.frontend_positions and "frontend_embeds" in extras:
        fe = extras["frontend_embeds"].to(x.dtype)
        x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
    if not cfg.use_rope:
        x = x + _learned_positions(model, 0, tokens.shape[1]).to(x.dtype)
    return x


def _embed_stream(model: LM, tokens: torch.Tensor,
                  extras: Dict[str, torch.Tensor]) -> torch.Tensor:
    """:func:`_embed_input`, on a mesh this rank's block of it (the whole
    sequence is embedded on every rank of the model axis, then pinned)."""
    L = spmd.current()
    if L is None:
        return _embed_input(model, tokens, extras)
    with spmd.on_layout(L.with_seq(False)):
        x = _embed_input(model, tokens, extras)
    return _constrain(L.slice_seq(x), L)


def _learned_positions(model: LM, pos0: Position, S: int) -> torch.Tensor:
    """Rows pos0 .. pos0+S-1 of the learned position table, the start
    clamped into the table as ``jax.lax.dynamic_slice_in_dim`` clamps it
    (a decode step past the table's end reads its last row); a tensor
    start is clamped on the device and its rows gathered there."""
    table = spmd.local(model.pos_embed)
    if S > table.shape[0]:
        raise ValueError(f"{model.cfg.arch}: {S} positions, the table has "
                         f"{table.shape[0]}")
    if isinstance(pos0, torch.Tensor):
        start = pos0.clamp(0, table.shape[0] - S).long()
        return table.index_select(
            0, start + torch.arange(S, device=table.device))
    start = min(max(pos0, 0), table.shape[0] - S)
    return table[start:start + S]


def _decode_position(model: LM, pos: Position) -> torch.Tensor:
    """A decode step's learned position (1, 1, d), rounded to bf16 whatever
    the model's dtype, as the JAX package rounds it (its prefill adds the
    positions in the model's dtype)."""
    return _learned_positions(model, pos, 1)[None].to(torch.bfloat16)


def _sinusoids(length: int, channels: int, dtype: torch.dtype,
               device=None) -> torch.Tensor:
    """The encoder's fixed positions (length, channels): the sines, then
    the cosines, of t x 10000^(-i / max(channels/2 - 1, 1)), computed in
    float32 and cast to ``dtype``."""
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    half = channels // 2
    inv = torch.exp(-math.log(10_000.0)
                    * torch.arange(half, dtype=torch.float32, device=device)
                    / max(half - 1, 1))
    ang = t * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _frames(model: LM, extras: Dict[str, torch.Tensor]) -> torch.Tensor:
    """An encoder-decoder's encoder input, ``extras["frames"]``."""
    if "frames" not in extras:
        cfg = model.cfg
        raise ValueError(f"{cfg.arch}: an encoder-decoder model needs "
                         f"frames, its encoder's input (B, {cfg.enc_frames},"
                         f" {cfg.d_model})")
    return extras["frames"]


def _run_encoder(model: LM, frames: torch.Tensor,
                 remat_policy: Optional[str] = None) -> torch.Tensor:
    """The encoder over the frame embeddings (B, F, d): the sinusoids added
    in the frames' dtype, the sum taken to the model's dtype, the blocks
    without a mask, then the encoder's final norm.  Under a remat policy
    each block is its own checkpointed unit: the JAX package groups the
    decoder's layers only."""
    L = spmd.current()
    if L is not None and L.seq:
        # on a mesh the encoder's stream stays whole over the model axis
        with spmd.on_layout(L.with_seq(False)):
            return _run_encoder(model, frames, remat_policy)
    cfg = model.cfg
    n = frames.shape[1]
    x = frames + _sinusoids(n, cfg.d_model, frames.dtype, frames.device)[None]
    x = x.to(model.embed["tokens"].dtype)
    positions = torch.arange(n, device=frames.device)[None]

    def body(blk: AttnBlock) -> Callable:
        return lambda h: blk(h, positions=positions, causal=False)[0]

    for blk in model.encoder.layers:
        x = _remat(body(blk), remat_policy)(x)
    return rmsnorm(x, model.encoder.final_norm["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Forward (training): tokens -> hidden states or logits, and the aux loss
# ---------------------------------------------------------------------------

#: The reference's remat policies (``repro.runtime.train.REMAT_POLICIES``)
#: and what each saves of a checkpointed layer body here:
#:   "none" / None   -> no checkpointing: autograd keeps what it needs;
#:   "full"          -> ``nothing_saveable``: ``torch.utils.checkpoint``,
#:                      only the body's inputs kept, all else recomputed;
#:   "dots"          -> ``checkpoint_dots``: selective checkpointing that
#:                      saves the outputs of ``aten.mm`` and ``aten.bmm``
#:                      (every matrix product) and recomputes the rest;
#:   "dots_no_batch" -> ``checkpoint_dots_with_no_batch_dims``: saves only
#:                      ``aten.mm``'s (the products without a batch
#:                      dimension; ``bmm`` is recomputed).
#: The hand-written kernels are not matrix products to the dispatcher
#: (ctypes launches): under "dots" and "dots_no_batch" they are recomputed.
REMAT_SAVED = {"dots": (torch.ops.aten.mm.default, torch.ops.aten.bmm.default),
               "dots_no_batch": (torch.ops.aten.mm.default,)}
REMAT_POLICIES = (None, "none", "full", *REMAT_SAVED)


def _remat(fn: Callable, policy: Optional[str]) -> Callable:
    """``fn`` under the named checkpoint policy."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat policy {policy!r} not in {REMAT_POLICIES}")
    L = spmd.current()
    if L is not None:
        inner = fn

        def fn(*a):
            # a recomputation in the backward runs in the step's layout
            with spmd.on_layout(L):
                return inner(*a)
    if policy in (None, "none"):
        return fn
    kw = {}
    if policy in REMAT_SAVED:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(REMAT_SAVED[policy]))
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


def _grouped(bodies: List[Callable], g: int, policy: Optional[str],
             inner: Optional[str]) -> List[Callable]:
    """Nested checkpointing, as the reference's ``_grouped_body``: each
    checkpointed unit advances ``g`` layer bodies, each of which is
    checkpointed with ``inner`` (the reference's ``remat_inner_policy or
    remat_policy``)."""
    if g <= 1:
        return [_remat(b, policy) for b in bodies]
    if len(bodies) % g:
        raise ValueError(f"remat_group {g} does not divide layer stack "
                         f"{len(bodies)}")

    def group(members):
        def run(h, aux):
            for b in members:
                h, aux = b(h, aux)
            return h, aux
        return run

    inner_bodies = [_remat(b, inner) for b in bodies]
    return [_remat(group(inner_bodies[i:i + g]), policy)
            for i in range(0, len(bodies), g)]


def _constrain(x: torch.Tensor, L) -> torch.Tensor:
    """Pin the residual stream on a mesh: this rank's block of it, batch
    over the data axes (where the batch divides them) and, under sequence
    parallelism, the sequence over the model axis — the reference's
    ``with_sharding_constraint(x, act_spec)``.  Here every block computes
    on that block by construction; the pin checks it."""
    if L is not None and x.shape[1] != L.seq_len // (L.tp_size if L.seq
                                                     else 1):
        raise RuntimeError(f"residual stream {tuple(x.shape)} is not the "
                           f"rank's block of {L.seq_len} positions")
    return x


def _wrap_body(body: Callable, L) -> Callable:
    """Pin the stream at every layer (:func:`_constrain`)."""
    if L is None:
        return body
    return lambda h, aux: body(_constrain(h, L), aux)


def sharded_inputs(tokens, extras: Dict, act_spec=None):
    """(layout, local tokens, local extras): a step on a mesh takes its
    inputs as DTensors placed by the rules (``batch`` over the data axes
    where it divides them); off a mesh (plain tensors) the layout is
    None and the inputs are returned as they are."""
    if not spmd.is_sharded(tokens):
        return None, tokens, extras
    L = spmd.layout_for(tokens, act_spec)
    return (L, tokens.to_local(),
            {k: v.to_local() if spmd.is_sharded(v) else v
             for k, v in extras.items()})


def forward_backbone(model: LM, tokens: torch.Tensor,
                     remat_policy: Optional[str] = None,
                     remat_group: int = 1,
                     remat_inner_policy: Optional[str] = None,
                     act_spec=None,
                     **extras) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> final hidden states (B,S,d), aux-loss scalar (the
    MoE router losses summed over the layers).  A hybrid group of Mamba2
    blocks and its attention block is one layer body, as is a local/global
    pair, as in the reference's scan.  An encoder-decoder runs its encoder
    on ``extras["frames"]`` first; each decoder block's cross-attention
    reads the encoder's output.

    On a mesh ``tokens`` (and the extras) are DTensors, or the caller has
    entered the step's layout already (``spmd.on_layout``) and passes
    this rank's local blocks; ``act_spec`` (``P(dp)`` or ``P(dp,
    "model")``) pins the residual stream at every layer and the hidden
    states returned are this rank's block."""
    L = spmd.current()
    if L is None and spmd.is_sharded(tokens):
        L, tokens, extras = sharded_inputs(tokens, extras, act_spec)
        with spmd.on_layout(L):
            return forward_backbone(model, tokens, remat_policy,
                                    remat_group, remat_inner_policy,
                                    **extras)
    cfg = model.cfg
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None]
    window = cfg.sliding_window
    enc = (_run_encoder(model, _frames(model, extras), remat_policy)
           if cfg.enc_dec else None)

    def attn_body(blk):
        def body(h, aux):
            y, a = attn_block_train(blk, h, positions=positions,
                                    window=window, enc=enc)
            return y, aux + a
        return body

    def hybrid_body(grp):
        def body(h, aux):
            for blk in grp.mamba:
                h, _, _ = blk(h)
            y, a = attn_block_train(grp.attn, h, positions=positions,
                                    window=window)
            return y, aux + a
        return body

    def mamba_body(blk):
        def body(h, aux):
            y, _, _ = blk(h)
            return y, aux
        return body

    def pair_body(pair):
        def body(h, aux):
            h, a1 = attn_block_train(pair.local, h, positions=positions,
                                     window=window)
            h, a2 = attn_block_train(pair.global_, h, positions=positions)
            return h, aux + a1 + a2
        return body

    make = (mamba_body if cfg.family == "ssm"
            else hybrid_body if cfg.family == "hybrid"
            else pair_body if cfg.local_global_pattern else attn_body)
    x = _embed_stream(model, tokens, extras)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for body in _grouped([_wrap_body(make(layer), L)
                          for layer in model.layers],
                         remat_group, remat_policy,
                         remat_inner_policy or remat_policy):
        x, aux = body(x, aux)
    return rmsnorm(x, model.final_norm["scale"], cfg.norm_eps), aux


def forward_train(model: LM, tokens: torch.Tensor,
                  remat_policy: Optional[str] = None, **extras
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B,S) -> logits (B,S,V), aux-loss scalar."""
    x, aux = forward_backbone(model, tokens, remat_policy=remat_policy,
                              **extras)
    return unembed(x, model.embed, model.cfg), aux


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

def cache_param_defs(cfg: ModelConfig, batch: int, capacity: int
                     ) -> Dict[str, ParamDef]:
    """The decode cache as the JAX package's ``cache_defs`` gives it:
    shapes and logical axis names, by its key names."""
    _check_family(cfg)
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    kv_log = (None, "cache_batch", "cache_seq", "kv_heads", "head_dim")

    def kv_def(n_layers: int, cap: int) -> ParamDef:
        return ParamDef((n_layers, batch, cap, KV, hd), kv_log, 0.0)

    if cfg.family == "ssm":
        return _ssm_cache_defs(cfg, cfg.n_layers, batch, lead=())
    if cfg.local_global_pattern:
        pairs, w = cfg.n_layers // 2, min(cfg.sliding_window, capacity)
        return {"k_local": kv_def(pairs, w), "v_local": kv_def(pairs, w),
                "k_global": kv_def(pairs, capacity),
                "v_global": kv_def(pairs, capacity)}
    cap = min(capacity, cfg.sliding_window) if cfg.sliding_window \
        else capacity
    if cfg.family == "hybrid":
        g, m = _hybrid_groups(cfg)
        d = _ssm_cache_defs(cfg, m, batch, lead=(g,))
    else:
        g, d = cfg.n_layers, {}
    d["k"] = kv_def(g, cap)
    d["v"] = kv_def(g, cap)
    if cfg.enc_dec:
        d["xk"] = kv_def(g, cfg.enc_frames)
        d["xv"] = kv_def(g, cfg.enc_frames)
    return d


def cache_defs(cfg: ModelConfig, batch: int, capacity: int
               ) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the decode cache, by the JAX package's key names."""
    return {k: d.shape for k, d in
            cache_param_defs(cfg, batch, capacity).items()}


def _ssm_cache_defs(cfg: ModelConfig, n_layers: int, batch: int,
                    lead: Tuple[int, ...]) -> Dict[str, ParamDef]:
    s = cfg.ssm
    nh, ds, hd = s.n_heads(cfg.d_model), s.d_state, s.head_dim
    di, K1 = s.d_inner(cfg.d_model), s.conv_dim - 1
    nl = (None,) * len(lead)
    return {
        "h": ParamDef(lead + (n_layers, batch, nh, ds, hd),
                      nl + (None, "cache_batch", "heads", None, None), 0.0),
        "conv_x": ParamDef(lead + (n_layers, batch, K1, di),
                           nl + (None, "cache_batch", None, "mlp"), 0.0),
        "conv_B": ParamDef(lead + (n_layers, batch, K1, ds),
                           nl + (None, "cache_batch", None, None), 0.0),
        "conv_C": ParamDef(lead + (n_layers, batch, K1, ds),
                           nl + (None, "cache_batch", None, None), 0.0),
    }


def cache_dtype(key: str, dtype=torch.bfloat16) -> torch.dtype:
    return torch.float32 if key == "h" else dtype     # SSM state is f32


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, device=None, *, mesh=None,
               rules: Optional[Rules] = None) -> Cache:
    """The zero cache.  With a mesh: DTensors placed by ``rules`` (the
    default ones without it), each rank holding its block (zeros, or
    storage-free on ``meta``)."""
    defs = cache_param_defs(cfg, batch, capacity)
    if mesh is None:
        return {k: torch.zeros(d.shape, dtype=cache_dtype(k, dtype),
                               device=device) for k, d in defs.items()}
    from torch.distributed.tensor import DTensor
    from repro_torch.models.sharding import default_rules
    rules = rules or default_rules(mesh)
    out: Cache = {}
    for k, d in defs.items():
        spec = spec_for(d.shape, d.logical, mesh, rules)
        shp = local_shape(d.shape, spec, mesh)
        dt = cache_dtype(k, dtype)
        loc = (torch.empty(shp, dtype=dt, device="meta")
               if str(device) == "meta"
               else torch.zeros(shp, dtype=dt, device=device))
        out[k] = DTensor.from_local(loc, mesh, placements_for(spec, mesh),
                                    run_check=False, shape=d.shape,
                                    stride=contiguous_stride(d.shape))
    return out


class CacheBlock(NamedTuple):
    """One rank's block of a layer's k or v cache on a mesh: the tensor,
    how it is split (``"rows"`` over the model axis, this rank's kv
    ``"heads"``, or ``"all"``) and the layer's rows in all."""

    t: torch.Tensor
    kind: str
    rows: int


def _block_kind(L, cache_entry) -> str:
    """How a stacked (layers.., B, rows, KV, hd) cache DTensor is split
    over the model axis."""
    d = L.tp_dim(cache_entry)
    nd = cache_entry.ndim
    return "rows" if d == nd - 3 else "heads" if d == nd - 2 else "all"


def _to_block(L, t: torch.Tensor, shape) -> torch.Tensor:
    """A tensor that is whole, or split over the model axis along another
    dim, as this rank's block of ``shape`` (slice, all-gather or
    all-to-all over the model axis; no gradient)."""
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    small = [d for d in range(t.ndim) if t.shape[d] < shape[d]]
    big = [d for d in range(t.ndim) if t.shape[d] > shape[d]]
    if small and big:
        return spmd.all_to_all(t, L.mesh, L.tp, big[0], small[0])
    for d in small:
        t = spmd.all_gather(t, L.mesh, L.tp, d)
    for d in big:
        t = t.chunk(L.tp_size, dim=d)[L.tp_rank]
    return t


# ---------------------------------------------------------------------------
# Prefill: tokens -> (last logits, filled cache)
# ---------------------------------------------------------------------------

def _fit_window(k: torch.Tensor, S: int, W: int) -> torch.Tensor:
    """Pack the last W of S prefilled k/v (B,S,KV,hd) into a rolling cache."""
    if S >= W:
        return torch.roll(k[:, S - W:], S % W, dims=1)
    return F.pad(k, (0, 0, 0, 0, 0, W - S))


def _pad_cap(k: torch.Tensor, c: int) -> torch.Tensor:
    return k if k.shape[1] == c else F.pad(k, (0, 0, 0, 0, 0, c - k.shape[1]))


def prefill(model: LM, tokens: torch.Tensor,
            capacity: Optional[int] = None, act_spec=None,
            cache: Optional[Cache] = None, **extras
            ) -> Tuple[torch.Tensor, Cache]:
    """tokens (B,S) -> last-token logits (B,V), cache of capacity
    ``capacity`` (default S).  The cache is allocated once, at capacity
    (or given: ``cache``, zeros of :func:`init_cache`'s shapes), and each
    layer writes its rows into it: k/v packed into a rolling cache of W
    rows under a window, else padded to the capacity; the SSM state and
    conv tails as they are; an encoder-decoder's cross-attention keys and
    values in bf16 (its own cross-attention read them in the model's
    dtype, as in the JAX package).

    On a mesh ``tokens`` (and the extras) are DTensors placed by the
    rules; the cache's DTensors are given (:func:`init_cache` with the
    mesh and the cell's rules) or made with the default rules, and each
    layer's k/v go to their blocks through :func:`_to_block`.  The logits
    are then a DTensor split over the batch like the tokens."""
    if spmd.is_sharded(tokens):
        L, tokens, extras = sharded_inputs(tokens, extras, act_spec)
        B, S = tokens.shape
        Bg = B * (spmd.dp_size(L) if L.batch else 1)
        if cache is None:
            cache = init_cache(model.cfg, Bg, capacity or S,
                               device=tokens.device, mesh=L.mesh)
        with spmd.on_layout(L):
            logits = _prefill(model, tokens, capacity, extras,
                              {k: v.to_local() for k, v in cache.items()},
                              L)
        return spmd.batch_dtensor(logits, L), cache
    B = tokens.shape[0]
    if cache is None:
        cache = init_cache(model.cfg, B, capacity or tokens.shape[1],
                           device=tokens.device)
    return _prefill(model, tokens, capacity, extras, cache, None), cache


def _prefill(model: LM, tokens: torch.Tensor, capacity: Optional[int],
             extras: Dict, cache: Cache, L) -> torch.Tensor:
    """Fill ``cache`` (this rank's blocks on a mesh) and return the last
    position's logits."""
    cfg = model.cfg
    S = tokens.shape[1]
    cap = capacity or S
    positions = torch.arange(S, device=tokens.device)[None]
    x = _embed_stream(model, tokens, extras)
    enc = _run_encoder(model, _frames(model, extras)) if cfg.enc_dec else None
    W = min(cfg.sliding_window, cap) if cfg.sliding_window else cap

    def put(key: str, idx, value: torch.Tensor) -> None:
        dst = cache[key][idx]
        dst.copy_(value if L is None else _to_block(L, value, dst.shape))

    def attn(blk: AttnBlock, x: torch.Tensor, window: Optional[int], idx,
             k_key: str = "k", v_key: str = "v") -> torch.Tensor:
        """One attention block and its cache rows."""
        x, kv = blk(x, positions=positions, window=window, enc=enc)
        fit = ((lambda t: _fit_window(t, S, W)) if window
               else (lambda t: _pad_cap(t, cap)))
        put(k_key, idx, fit(kv[0]).to(torch.bfloat16))
        put(v_key, idx, fit(kv[1]).to(torch.bfloat16))
        if enc is not None:
            put("xk", idx, kv[2].to(torch.bfloat16))
            put("xv", idx, kv[3].to(torch.bfloat16))
        return x

    def mamba(blk: MambaBlock, x: torch.Tensor, idx) -> torch.Tensor:
        x, hf, conv = blk(x)
        put("h", idx, hf.float())
        for k in ("x", "B", "C"):
            put("conv_" + k, idx, conv[k])
        return x

    if cfg.family == "ssm":
        for i, blk in enumerate(model.layers):
            x = mamba(blk, x, i)
    elif cfg.family == "hybrid":
        for i, grp in enumerate(model.layers):
            for j, blk in enumerate(grp.mamba):
                x = mamba(blk, x, (i, j))
            x = attn(grp.attn, x, cfg.sliding_window, i)
    elif cfg.local_global_pattern:
        for i, pair in enumerate(model.layers):
            x = attn(pair.local, x, cfg.sliding_window, i, "k_local",
                     "v_local")
            x = attn(pair.global_, x, None, i, "k_global", "v_global")
    else:
        for i, blk in enumerate(model.layers):
            x = attn(blk, x, cfg.sliding_window, i)
    if L is not None:
        return _last_logits_sharded(L, model, x)
    x = rmsnorm(x[:, -1:], model.final_norm["scale"], cfg.norm_eps)
    logits = unembed(x, model.embed, cfg)
    return logits[:, 0]


def _last_logits_sharded(L, model: LM, x: torch.Tensor) -> torch.Tensor:
    """The last position's logits (B/dp, V), whole on every rank of the
    model axis: the last position from the rank holding it, the
    vocabulary's shards gathered."""
    cfg = model.cfg
    last = x[:, -1:]
    if L.seq:
        last = spmd.all_gather(last, L.mesh, L.tp, 1)[:, -1:]
    Lr = L.with_seq(False)
    with spmd.on_layout(Lr):
        h = rmsnorm(last, model.final_norm["scale"], cfg.norm_eps)
        w = unembed_weight(Lr, model.embed, cfg)
        logits = softcap(h @ w.to(h.dtype), cfg.final_softcap)
        if vocab_sharded(model.embed, cfg, Lr):
            logits = spmd.all_gather(logits, L.mesh, L.tp, 2)
    return mask_padded_vocab(logits, cfg)[:, 0]


# ---------------------------------------------------------------------------
# Decode: one token step
# ---------------------------------------------------------------------------

def decode_step(model: LM, cache: Cache, token: torch.Tensor, pos: Position
                ) -> Tuple[torch.Tensor, Cache]:
    """token (B,), pos -> logits (B,V); ``cache`` is updated in place and
    returned.  A rolling cache (its rows equal to the sliding window) is
    decoded under the window; a cache shorter than the window holds every
    position and is decoded without one, as in the JAX package.  A model
    without rope adds its learned position (``_decode_position``).

    ``pos`` is a Python int or a 0-d integer tensor on the cache's device,
    as the JAX step takes a traced scalar: the two give the same logits and
    cache bit for bit, and the tensor is read by the device alone (the
    rope angle, the mask, the cache row and the learned position's row,
    each clamped there as the int path clamps on the host), so the step
    can be captured in a CUDA graph (:mod:`repro_torch.runtime.graphs`).

    On a mesh the token is a DTensor and the cache DTensors placed by the
    rules; each layer reads and writes this rank's block of its cache
    (:class:`CacheBlock`), and the logits are a DTensor split over the
    batch like the token.  That step takes an int position only."""
    if spmd.is_sharded(token):
        pos = int_position(pos)
        L = spmd.layout_for(token[:, None])
        local = {k: v.to_local() for k, v in cache.items()}
        views = {k: (local[k], _block_kind(L, v), v.shape[-3])
                 for k, v in cache.items() if k[0] in "kvx"}
        with spmd.on_layout(L), torch.no_grad():
            logits = _decode(model, local, views, token.to_local(), pos, L)
        return spmd.batch_dtensor(logits, L), cache
    return _decode(model, cache, None, token, pos, None), cache


def _decode(model: LM, cache: Cache, views, token: torch.Tensor,
            pos: Position, L) -> torch.Tensor:
    cfg = model.cfg
    x = embed(token[:, None], model.embed, cfg)
    if not cfg.use_rope:
        x = x + _decode_position(model, pos).to(x.dtype)

    def window_of(key: str) -> Optional[int]:
        W = cache[key].shape[2] if views is None else views[key][2]
        return (cfg.sliding_window
                if cfg.sliding_window and W == cfg.sliding_window else None)

    def kv(key: str, i):
        if views is None:
            return cache[key][i]
        t, kind, rows = views[key]
        return CacheBlock(t[i], kind, rows)

    def mamba(blk: MambaBlock, x: torch.Tensor, idx) -> torch.Tensor:
        # the block updates the state and the conv buffers in place
        return blk.decode(
            x, h=cache["h"][idx],
            conv_state={k: cache["conv_" + k][idx]
                        for k in ("x", "B", "C")})[0]

    # the rope kernel's frequency table, once a step
    freqs = (rope_frequencies(cfg.head_dim, cfg.rope_theta, x.device)
             if cfg.use_rope and L is None else None)

    if cfg.family == "ssm":
        for i, blk in enumerate(model.layers):
            x = mamba(blk, x, i)
    elif cfg.family == "hybrid":
        window = window_of("k")
        for i, grp in enumerate(model.layers):
            for j, blk in enumerate(grp.mamba):
                x = mamba(blk, x, (i, j))
            x = grp.attn.decode(x, k_cache=kv("k", i), v_cache=kv("v", i),
                                pos=pos, window=window, freqs=freqs)
    elif cfg.local_global_pattern:
        window = window_of("k_local")
        for i, pair in enumerate(model.layers):
            x = pair.local.decode(x, k_cache=kv("k_local", i),
                                  v_cache=kv("v_local", i), pos=pos,
                                  window=window, freqs=freqs)
            x = pair.global_.decode(x, k_cache=kv("k_global", i),
                                    v_cache=kv("v_global", i), pos=pos,
                                    window=None, freqs=freqs)
    else:
        window = window_of("k")
        for i, blk in enumerate(model.layers):
            x = blk.decode(x, k_cache=kv("k", i), v_cache=kv("v", i),
                           pos=pos, window=window, freqs=freqs,
                           xk=kv("xk", i) if cfg.enc_dec else None,
                           xv=kv("xv", i) if cfg.enc_dec else None)
    if L is not None:
        return _last_logits_sharded(L, model, x)
    x = ops.rmsnorm(x, model.final_norm["scale"], cfg.norm_eps)
    logits = unembed(x, model.embed, cfg)
    return logits[:, 0]
