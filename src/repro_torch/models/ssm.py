"""Mamba2 — state-space duality (SSD) layer (arXiv:2405.21060).

Prefill runs the **chunked SSD algorithm** through one
:func:`repro_torch.kernels.ops.ssd_scan` call: the hand-written CUDA kernel
on a CUDA tensor (the state stays on chip across the chunk loop), its
plain version on any other.  It takes the place of the JAX package's
``lax.scan`` chunk loop in ``ssd_prefill``, which computes the same
function.  Everything around it — projections, the ragged-tail split, the
conv buffers, the D skip, the gate and the norm — follows the JAX package
line for line.  Decode is the O(1) recurrent update on the carried state.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
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


def ssd_prefill(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
                h0: Optional[torch.Tensor] = None,
                conv_state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Dict[str, torch.Tensor]]:
    """Full-sequence SSD. x: (B,S,d_model) -> (y, h_final, conv_state).

    Ragged lengths are handled by splitting off the sub-chunk tail and
    chaining the carried state (conv buffers hold *raw* projections, so
    the continuation is exact).
    """
    s = cfg.ssm
    B, S, _ = x.shape
    di, nh, Q = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), \
        min(s.chunk, x.shape[1])
    if S % Q:
        main = (S // Q) * Q
        y1, h1, conv1 = ssd_prefill(x[:, :main], p, cfg, h0=h0,
                                    conv_state=conv_state)
        y2, h2, conv2 = ssd_prefill(x[:, main:], p, cfg, h0=h1,
                                    conv_state=conv1)
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
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"], h_final, new_conv


def ssd_decode(x: torch.Tensor, p: Params, cfg: ModelConfig, *,
               h: torch.Tensor, conv_state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor,
                          Dict[str, torch.Tensor]]:
    """One-token recurrent step. x: (B,1,d_model); h: (B,nh,ds,hd)."""
    s = cfg.ssm
    B = x.shape[0]
    di, nh, ds = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), s.d_state
    z, xr, Br, Cr, dt = _project(x, p, cfg)

    def conv1(val, w, buf):
        window = torch.cat([buf.to(val.dtype), val], dim=1)
        y = torch.einsum("bkc,kc->bc", window, w)[:, None]
        return F.silu(y), window[:, 1:]

    xr, nbx = conv1(xr, p["conv_x"], conv_state["x"])
    Br, nbB = conv1(Br, p["conv_B"], conv_state["B"])
    Cr, nbC = conv1(Cr, p["conv_C"], conv_state["C"])
    new_conv = {"x": nbx.to(conv_state["x"].dtype),
                "B": nbB.to(conv_state["B"].dtype),
                "C": nbC.to(conv_state["C"].dtype)}

    A = -torch.exp(p["A_log"].float())
    xh = xr.reshape(B, nh, -1).float()                    # (B,nh,hd)
    dt1 = dt.reshape(B, nh)                               # f32
    a = torch.exp(dt1 * A)                                # (B,nh)
    Bv = Br.reshape(B, ds).float()
    Cv = Cr.reshape(B, ds).float()
    hf = h.float()
    h_new = hf * a[:, :, None, None] + torch.einsum(
        "bs,bh,bhe->bhse", Bv, dt1, xh)
    y = torch.einsum("bs,bhse->bhe", Cv, h_new)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["w_out"], h_new.to(h.dtype), new_conv


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
