"""Mamba2 — state-space duality (SSD) layer (arXiv:2405.21060).

Prefill runs the **chunked SSD algorithm** through one
:func:`repro_torch.kernels.ops.ssd_scan` call: the hand-written CUDA kernel
on a CUDA tensor (the state stays on chip across the chunk loop), its
plain version on any other.  It takes the place of the JAX package's
``lax.scan`` chunk loop in ``ssd_prefill``, which computes the same
function.  Everything around it — projections, the ragged-tail split, the
conv buffers, the D skip, the gate and the norm — follows the JAX package
line for line.  Decode is the O(1) recurrent update on the carried state:
past the projections one :func:`repro_torch.kernels.ops.ssd_decode_step`
call (the hand-written kernel on the card, which the JAX engine's jit
fuses) and the gated norm's ``ops.rmsnorm``, the state and conv buffers
updated in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models import spmd
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Defs, ParamDef, Params, rmsnorm


def ssm_defs(cfg: ModelConfig) -> Defs:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    ds = s.d_state
    return {
        "w_z": ParamDef((d, di), ("embed", "mlp")),
        "w_x": ParamDef((d, di), ("embed", "mlp")),
        "w_B": ParamDef((d, ds), ("embed", "state")),
        "w_C": ParamDef((d, ds), ("embed", "state")),
        "w_dt": ParamDef((d, nh), ("embed", "heads")),
        "dt_bias": ParamDef((nh,), ("heads",), 0.0),
        "A_log": ParamDef((nh,), ("heads",), 0.0),
        "D": ParamDef((nh,), ("heads",), -1.0),
        "conv_x": ParamDef((s.conv_dim, di), ("conv", "mlp"), 0.5),
        "conv_B": ParamDef((s.conv_dim, ds), ("conv", "state"), 0.5),
        "conv_C": ParamDef((s.conv_dim, ds), ("conv", "state"), 0.5),
        "norm": ParamDef((di,), (None,), -1.0),
        "w_out": ParamDef((di, d), ("mlp", "embed")),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                buf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along seq. x: (B,S,C), w: (K,C).

    ``buf``: (B,K-1,C) history for decode continuation (prepended).
    """
    K = w.shape[0]
    if buf is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([buf.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return F.silu(y)


def _project(x: torch.Tensor, p: Params, cfg: ModelConfig):
    z = x @ p["w_z"]
    xr = x @ p["w_x"]
    Br = x @ p["w_B"]
    Cr = x @ p["w_C"]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"].float())
    return z, xr, Br, Cr, dt


def _ssm_local(L, p: Params):
    """(this rank's weights, whether the layer runs on local heads)."""
    tp = L.tp_dim(p["w_x"]) == 1 and L.tp_dim(p["w_dt"]) == 1
    if not tp and (L.tp_dim(p["w_x"]) is not None
                   or L.tp_dim(p["w_dt"]) is not None):
        raise ValueError("d_inner and the SSD heads must both split over "
                         "the model axis, or neither")
    Lr = L.with_seq(False)
    if not tp:
        return {k: Lr.param(v) for k, v in p.named_parameters()}, False
    col, vec = {L.tp: 1}, {L.tp: 0}
    w = {k: Lr.param(p[k], col) for k in ("w_z", "w_x", "w_dt", "conv_x")}
    w.update({k: Lr.param(p[k], vec) for k in ("dt_bias", "A_log", "D",
                                               "norm")})
    w.update({k: Lr.param(p[k], tp_partial=True)
              for k in ("w_B", "w_C", "conv_B", "conv_C")})
    w["w_out"] = Lr.param(p["w_out"], {L.tp: 0})
    return w, True


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, eps: float, L=None,
                d_inner: int = 0) -> torch.Tensor:
    """The norm over d_inner; with a layout, over this rank's shard of it
    with the sum of squares added over the model axis."""
    if L is None:
        return rmsnorm(y, scale, eps)
    yf = y.float()
    var = L.all_reduce_tp((yf * yf).sum(-1, keepdim=True)) / d_inner
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def ssd_prefill(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
                h0: Optional[torch.Tensor] = None,
                conv_state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
    """Full-sequence SSD. x: (B,S,d_model) -> (y, h_final, conv_state).

    Ragged lengths are handled by splitting off the sub-chunk tail and
    chaining the carried state (conv buffers hold *raw* projections, so
    the continuation is exact).  On a mesh: this rank's heads (or all of
    them) over the whole sequence of its rows; the state and conv tails
    returned are this rank's.
    """
    L = spmd.current()
    if L is None:
        return _ssd_prefill(x, p, cfg, h0=h0, conv_state=conv_state)
    w, tp = _ssm_local(L, p)
    xx = L.enter_tp(x) if tp else L.gather_seq_same(x)
    y, h, conv = _ssd_prefill(xx, w, cfg, h0=h0, conv_state=conv_state,
                              norm_layout=L.with_seq(False) if tp else None)
    return (L.exit_tp(y) if tp else L.slice_seq(y)), h, conv


def _ssd_prefill(x: torch.Tensor, p, cfg: ModelConfig, *,
                 h0: Optional[torch.Tensor] = None,
                 conv_state: Optional[Dict[str, torch.Tensor]] = None,
                 norm_layout=None):
    s = cfg.ssm
    B, S, _ = x.shape
    di, nh, Q = p["w_x"].shape[1], p["w_dt"].shape[1], \
        min(s.chunk, x.shape[1])
    if S % Q:
        main = (S // Q) * Q
        y1, h1, conv1 = _ssd_prefill(x[:, :main], p, cfg, h0=h0,
                                     conv_state=conv_state,
                                     norm_layout=norm_layout)
        y2, h2, conv2 = _ssd_prefill(x[:, main:], p, cfg, h0=h1,
                                     conv_state=conv1,
                                     norm_layout=norm_layout)
        return torch.cat([y1, y2], dim=1), h2, conv2
    z, xr, Br, Cr, dt = _project(x, p, cfg)
    bx = None if conv_state is None else conv_state["x"]
    bB = None if conv_state is None else conv_state["B"]
    bC = None if conv_state is None else conv_state["C"]
    K1 = s.conv_dim - 1

    def _tail(buf, cur):
        """Last K-1 raw projections incl. history (short-segment safe)."""
        hist = cur if buf is None else torch.cat([buf.to(cur.dtype), cur],
                                                 dim=1)
        if hist.shape[1] < K1:
            hist = F.pad(hist, (0, 0, K1 - hist.shape[1], 0))
        return hist[:, hist.shape[1] - K1:]

    # conv buffers carry *raw* (pre-conv) projections for continuation
    new_conv = {"x": _tail(bx, xr).to(torch.bfloat16),
                "B": _tail(bB, Br).to(torch.bfloat16),
                "C": _tail(bC, Cr).to(torch.bfloat16)}
    xr = causal_conv(xr, p["conv_x"], bx)
    Br = causal_conv(Br, p["conv_B"], bB)
    Cr = causal_conv(Cr, p["conv_C"], bC)

    A = -torch.exp(p["A_log"].float())                    # (nh,) negative
    hd = di // nh
    # the chunk loop, one kernel call; x goes in as float32 so y stays
    # float32 until after the D skip, as in the JAX package
    y, h_final = ops.ssd_scan(xr.float(), dt, Br.float(), Cr.float(), A,
                              chunk=Q,
                              h0=None if h0 is None else h0.float())
    y = y.view(B, S, nh, hd) + xr.reshape(B, S, nh, hd).float() \
        * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, di).to(x.dtype)
    y = y * F.silu(z)
    y = _gated_norm(y, p["norm"], cfg.norm_eps, norm_layout,
                    s.d_inner(cfg.d_model))
    return y @ p["w_out"], h_final, new_conv


def ssd_decode(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
               h: torch.Tensor, conv_state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Dict[str, torch.Tensor]]:
    """One-token recurrent step. x: (B,1,d_model); h: (B,nh,ds,hd) (this
    rank's heads on a mesh).  The state ``h`` and the conv buffers are
    updated in place (the decode cache's own tensors) and returned.
    Unsharded, past the projections: ``ops.ssd_decode_step`` and the gated
    norm's ``ops.rmsnorm`` (kernels on the card); on a mesh, the plain step
    (``ref.ssd_decode_step_ref``) and the norm over the model axis."""
    L = spmd.current()
    if L is None:
        y = ops.ssd_decode_step(*_projections(x, p), p, h=h,
                                conv=conv_state)
        y = ops.rmsnorm(y, p["norm"], cfg.norm_eps)
        return y @ p["w_out"], h, conv_state
    w, tp = _ssm_local(L, p)
    y = ref.ssd_decode_step_ref(
        *_projections(L.copy_to_tp(x) if tp else x, w), w, h=h,
        conv=conv_state)
    y = _gated_norm(y, w["norm"], cfg.norm_eps, L if tp else None,
                    cfg.ssm.d_inner(cfg.d_model)) @ w["w_out"]
    return (L.reduce_tp(y) if tp else y), h, conv_state


def _projections(x: torch.Tensor, p) -> Tuple[torch.Tensor, ...]:
    """z, x, B, C and the raw dt of one decode token (the recurrent step
    applies dt's bias and softplus)."""
    return tuple(x @ p[k] for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    s = cfg.ssm
    nh = s.n_heads(cfg.d_model)
    return torch.zeros((batch, nh, s.d_state, s.head_dim), dtype=dtype,
                       device=device)


def init_conv_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                    device=None) -> Dict[str, torch.Tensor]:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    K = s.conv_dim - 1
    return {"x": torch.zeros((batch, K, di), dtype=dtype, device=device),
            "B": torch.zeros((batch, K, s.d_state), dtype=dtype,
                             device=device),
            "C": torch.zeros((batch, K, s.d_state), dtype=dtype,
                             device=device)}
