"""Cross-entropy losses: plain and sequence-chunked.

The port's counterpart of the JAX package's ``runtime/loss.py``.  The
chunked variant projects one chunk of the sequence to the vocabulary at a
time and runs each chunk under ``torch.utils.checkpoint``, so the (B, S/k,
V) logits of a chunk are recomputed in the backward pass instead of being
kept (the JAX package's ``jax.checkpoint`` with ``nothing_saveable``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, unembed


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
