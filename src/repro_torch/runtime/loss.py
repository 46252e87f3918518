"""Cross-entropy losses: plain and sequence-chunked.

The port's counterpart of the JAX package's ``runtime/loss.py``.  The
chunked variant projects one chunk of the sequence to the vocabulary at a
time and runs each chunk under ``torch.utils.checkpoint``, so the (B, S/k,
V) logits of a chunk are recomputed in the backward pass instead of being
kept (the JAX package's ``jax.checkpoint`` with ``nothing_saveable``).

On a mesh (:mod:`repro_torch.models.spmd`) the loss is vocabulary-parallel
where the rules split the vocabulary over the model axis: each rank makes
its shard's logits and the log-sum-exp and the gold logit are summed over
the axis; the totals are summed over the data shards.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (Params, mask_padded_vocab, softcap,
                                       unembed, unembed_weight,
                                       vocab_sharded)


def xent_from_logits(logits: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed next-token loss.  logits (B,S,V) any float dtype, labels
    (B,S) integers with -1 = ignore.  Returns (sum_loss, n_valid) in
    float32."""
    lf = logits.float()
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, safe[..., None])[..., 0]
    per_tok = (lse - gold) * mask.float()
    return per_tok.sum(), mask.sum().float()


def chunked_xent(x: torch.Tensor, embed: Params, cfg: ModelConfig,
                 labels: torch.Tensor, *, chunks: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unembed + cross entropy.  x: final hidden states (B, S, d); ``embed``
    the model's embedding parameters (``LM.embed``).  With ``chunks`` > 1
    dividing S, each chunk's logits are made, reduced to scalars and
    recomputed in the backward pass."""
    L = spmd.current()
    if L is not None:
        return _chunked_xent_sharded(L, x, embed, cfg, labels, chunks)
    B, S, _ = x.shape
    if chunks <= 1 or S % chunks:
        return xent_from_logits(unembed(x, embed, cfg), labels)
    C = S // chunks

    def chunk_loss(xi, li):
        return xent_from_logits(unembed(xi, embed, cfg), li)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(chunks):
        part = slice(i * C, (i + 1) * C)
        s, n = checkpoint(chunk_loss, x[:, part], labels[:, part],
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + n
    return tot, cnt


def _xent_vocab_parallel(L, x: torch.Tensor, w: torch.Tensor,
                         cfg: ModelConfig, labels: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`xent_from_logits` of ``x @ w`` with ``w`` this rank's
    vocabulary shard (d, V/model): the max over the shards (no gradient),
    the sum of exponentials and the gold logit summed over the model
    axis."""
    Vl = w.shape[1]
    off = L.tp_rank * Vl
    logits = softcap(x @ w.to(x.dtype), cfg.final_softcap)
    lf = mask_padded_vocab(logits, cfg, offset=off).float()
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    mx = spmd.all_reduce(lf.detach().amax(-1), L.mesh, (L.tp,), "max")
    lse = mx + torch.log(L.reduce_tp(torch.exp(lf - mx[..., None]).sum(-1)))
    loc = safe - off
    own = (loc >= 0) & (loc < Vl)
    gold = torch.gather(lf, -1, loc.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = L.reduce_tp(gold * own.float())
    per_tok = (lse - gold) * mask.float()
    return per_tok.sum(), mask.sum().float()


def _chunked_xent_sharded(L, x, embed: Params, cfg: ModelConfig,
                          labels: torch.Tensor, chunks: int):
    """:func:`chunked_xent` on a mesh: ``x`` this rank's block of the
    final hidden states, ``labels`` its rows' (whole sequence)."""
    if vocab_sharded(embed, cfg, L):
        xx, Lr = L.enter_tp(x), L.with_seq(False)

        def loss(xi, li):
            return _xent_vocab_parallel(Lr, xi, unembed_weight(Lr, embed,
                                                               cfg), cfg, li)
    else:
        xx, Lr = x, L
        if L.seq:
            S_l = x.shape[1]
            off = L.seq_offset(S_l)
            labels = labels[:, off:off + S_l]

        def loss(xi, li):
            w = unembed_weight(Lr, embed, cfg)
            return xent_from_logits(mask_padded_vocab(softcap(
                xi @ w.to(xi.dtype), cfg.final_softcap), cfg), li)
    S = xx.shape[1]
    with spmd.on_layout(Lr):
        if chunks <= 1 or S % chunks:
            tot, cnt = loss(xx, labels)
        else:
            C = S // chunks
            tot = torch.zeros((), dtype=torch.float32, device=x.device)
            cnt = torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(chunks):
                part = slice(i * C, (i + 1) * C)
                t, n = checkpoint(loss, xx[:, part], labels[:, part],
                                  use_reentrant=False)
                tot, cnt = tot + t, cnt + n
    if L.seq and not vocab_sharded(embed, cfg, L):
        tot, cnt = L.reduce_tp(tot), L.reduce_tp(cnt)
    return L.reduce_dp(tot), L.reduce_dp(cnt)
