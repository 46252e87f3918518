"""Mixture-of-Experts FFN: top-k router + sort-based capacity dispatch.

As in the JAX package: tokens are sorted by expert assignment, gathered
into an expert-contiguous (E, C, d) buffer, processed by the grouped GEMM
and combined back with the router weights.  Tokens beyond an expert's
capacity C = ceil(cf * k * N / E) are dropped (Switch/GShard semantics).

The three expert products go through :func:`repro_torch.kernels.ops.grouped_matmul`:
the hand-written CUDA kernel on a CUDA tensor, its plain version
(``ref.grouped_matmul_ref``) on any other.  They take the place of the
JAX package's einsums, which compute the same function as its Pallas
``moe_gemm`` kernel.  The dispatch makes no host synchronisation: no
boolean masks, ``nonzero`` or ``.item()``, so the layer queues on the
stream like any other.

On a mesh (a :mod:`repro_torch.models.spmd` layout) the layer runs as the
reference's ``shard_map`` body under ``moe_mesh``, which the reference's
dry-run turns on for every MoE cell (:func:`_moe_ffn_sharded`): the tokens stay on their
data shard (routing, per-shard capacity and the sort are local), the
expert weights' FSDP ``d`` dim is all-gathered layer by layer (its
gradient reduce-scattered), their ``f`` dim stays split over the model
axis (the grouped GEMM runs on (E, C_local, d) x (E, d, f/model)), the
output is all-reduced over the model axis and the aux loss averaged over
the data shards.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Defs, ParamDef, Params, activate, \
    softcap


def moe_defs(cfg: ModelConfig) -> Defs:
    m = cfg.moe
    d = cfg.d_model
    defs: Defs = {
        "router": ParamDef((d, m.n_experts), ("embed", "experts")),
        "w_in": ParamDef((m.n_experts, d, m.d_ff),
                         ("experts", "embed", "expert_mlp")),
        "w_out": ParamDef((m.n_experts, m.d_ff, d),
                          ("experts", "expert_mlp", "embed")),
    }
    if cfg.gated_mlp:
        defs["w_gate"] = ParamDef((m.n_experts, d, m.d_ff),
                                  ("experts", "embed", "expert_mlp"))
    return defs


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(math.ceil(m.capacity_factor * m.top_k * n_tokens / m.n_experts))
    return max(8, -(-c // 8) * 8)      # pad to a multiple of 8


def router_probs(x2d: torch.Tensor, p: Params, cfg: ModelConfig
                 ) -> torch.Tensor:
    """(N,d) -> the router's softmax over the experts (N,E), float32."""
    logits = x2d.float() @ p["router"].float()
    logits = softcap(logits, cfg.moe.router_softcap)
    return torch.softmax(logits, dim=-1)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, largest first, ties to the lower index
    (``jax.lax.top_k``'s order; ``torch.topk`` breaks ties otherwise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x2d: torch.Tensor, p: Params, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (N,d) -> top-k (weights (N,k) in x's dtype, experts (N,k),
    the load-balancing aux loss)."""
    m = cfg.moe
    probs = router_probs(x2d, p, cfg)
    w, idx = top_k(probs, m.top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch): E * sum(f_e * p_e)
    me = probs.mean(0)
    experts = torch.arange(m.n_experts, device=x2d.device)
    ce = (idx[:, :1] == experts).float().mean(0)
    aux = m.n_experts * torch.sum(me * ce)
    return w.to(x2d.dtype), idx, aux


def moe_ffn(x: torch.Tensor, p: Params, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (y, aux_loss): the JAX package's sort-based capacity
    dispatch over every token of the call (``_moe_ffn_local``).

    Slots (token, j) are sorted by expert, stably; an expert's first C
    slots in that order are kept.  Row c of expert e's buffer is the
    token of sorted slot ``start[e] + c``, or zeros where the expert has
    fewer slots: a gather, which gives the JAX scatter's buffer exactly
    (its dropped slots add zeros to their expert's row 0).  The combine
    puts the slots back in (token, j) order through the inverse of the
    sort and sums each token's k weighted expert outputs (deterministic,
    in x's dtype, rounded once; the JAX package adds them into the token's
    row one by one in expert order)."""
    L = spmd.current()
    if L is not None:
        return _moe_ffn_sharded(L, x, p, cfg)
    return _moe_ffn_local(x, p, cfg, p["w_in"],
                          p["w_gate"] if "w_gate" in p else None,
                          p["w_out"])


def _moe_ffn_local(x: torch.Tensor, p: Params, cfg: ModelConfig, w_in,
                   w_gate, w_out, router=None, expert_in=None, comb=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dispatch over the tokens of ``x`` with the expert weights given
    (a shard's, on a mesh: ``router`` the router's weights, ``expert_in``
    and ``comb`` what the experts' input and the combine weights pass
    through first)."""
    m = cfg.moe
    B, S, d = x.shape
    N, K, E = B * S, m.top_k, m.n_experts
    C = capacity(cfg, N)
    x2 = x.reshape(N, d)
    w, idx, aux = route(x2, p if router is None else {"router": router},
                        cfg)                            # (N,K)
    if expert_in is not None:
        x2, w = expert_in(x2), comb(w)

    flat_expert = idx.reshape(-1)                       # (N*K,)
    order = torch.argsort(flat_expert, stable=True)     # expert-contiguous
    exp_sorted = flat_expert[order]
    experts = torch.arange(E, device=x.device)
    start = torch.searchsorted(exp_sorted, experts)     # side="left"
    end = torch.searchsorted(exp_sorted, experts, right=True)
    slots = torch.arange(N * K, device=x.device)
    pos_in_expert = slots - start[exp_sorted]
    keep = pos_in_expert < C                            # capacity drop
    dest = exp_sorted * C + torch.where(keep, pos_in_expert, 0)

    # gather tokens into (E, C, d)
    src = start[:, None] + torch.arange(C, device=x.device)      # (E,C)
    filled = src < end[:, None]
    tok = torch.div(order[src.clamp(max=N * K - 1)], K,
                    rounding_mode="floor")
    xe = torch.where(filled[..., None], x2[tok], x2.new_zeros(()))

    h = ops.grouped_matmul(xe, w_in)
    if w_gate is not None:
        h = activate(h, cfg.activation) * ops.grouped_matmul(xe, w_gate)
    else:
        h = activate(h, cfg.activation)
    ye = ops.grouped_matmul(h, w_out)                   # (E,C,d)

    # combine, weighted: the slots back in (token, j) order
    inv = torch.empty_like(order).scatter_(0, order, slots)
    coef = w.reshape(-1) * keep[inv].to(w.dtype)        # (N*K,)
    y_slots = ye.reshape(E * C, d)[dest[inv]] * coef[:, None]
    y2 = y_slots.view(N, K, d).sum(1)
    return y2.reshape(B, S, d), aux


def moe_ffn_dense(x: torch.Tensor, p: Params, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (no-drop) oracle: every expert sees every token, masked
    combine.  O(E/k) more FLOPs: the tests' reference only."""
    m = cfg.moe
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    w, idx, aux = route(x2, p, cfg)
    comb = torch.zeros((B * S, m.n_experts), dtype=x.dtype, device=x.device)
    for j in range(m.top_k):
        comb = comb + F.one_hot(idx[:, j], m.n_experts).to(x.dtype) \
            * w[:, j:j + 1]
    h = torch.einsum("nd,edf->enf", x2, p["w_in"])
    if "w_gate" in p:
        h = activate(h, cfg.activation) * torch.einsum("nd,edf->enf", x2,
                                                       p["w_gate"])
    else:
        h = activate(h, cfg.activation)
    ye = torch.einsum("enf,efd->end", h, p["w_out"])
    y = torch.einsum("end,ne->nd", ye, comb)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Distributed MoE: per-shard dispatch + expert tensor parallelism
# ---------------------------------------------------------------------------

def _moe_ffn_sharded(L, x: torch.Tensor, p: Params, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``shard_map`` MoE, body for body:

      * tokens stay on their data shard (the whole sequence of the rank's
        rows under sequence parallelism) — routing, capacity and the
        dispatch sort are local;
      * the expert weights arrive (E, d/dp, f/tp): the d (FSDP) dim is
        all-gathered (backward: reduce-scatter), the f dim stays split
        over the model axis where it divides it (the reference's
        ``wspec`` replicates it otherwise, and then nothing is summed);
      * the f-contraction's partial outputs are summed over the model
        axis;
      * the aux loss is averaged over the data shards.

    The router is replicated and computed on every rank of the model axis
    from the same tokens; the experts' input and the combine weights pass
    through a copy whose gradient sums the model axis' parts."""
    E, f = cfg.moe.n_experts, cfg.moe.d_ff
    tp_f = L.tp is not None and f % L.tp_size == 0 and L.tp_size > 1
    col, row = ({L.tp: 2}, {L.tp: 1}) if tp_f else (None, None)
    xx = L.gather_seq_same(x)
    Lr = L.with_seq(False)
    w_in = Lr.param(p["w_in"], col)
    w_gate = Lr.param(p["w_gate"], col) if "w_gate" in p else None
    w_out = Lr.param(p["w_out"], row)
    router = Lr.param(p["router"])
    if tp_f:
        y, aux = _moe_ffn_local(xx, p, cfg, w_in, w_gate, w_out,
                                router=router, expert_in=Lr.copy_to_tp,
                                comb=Lr.copy_to_tp)
        y = Lr.reduce_tp(y)
    else:
        y, aux = _moe_ffn_local(xx, p, cfg, w_in, w_gate, w_out,
                                router=router)
    return L.slice_seq(y), Lr.reduce_dp(aux, mean=True)
