"""The decode step's layer bodies on the card: four wrappers, each
launching one source of ``csrc/`` on the current stream.

No TPU kernel stands behind them: the JAX engine jits its whole decode
step (``src/repro/runtime/serve.py``), and XLA fuses each layer's
elementwise work into a few fusions.  Eagerly, the port's step ran it as
2.5-4.6 thousand small device operations (a CUDA graph replays them one by
one).  Each wrapper computes what its plain version in
:mod:`repro_torch.kernels.ref` computes, with one launch:

  * :func:`rmsnorm` (``csrc/rmsnorm.cu``) — RMSNorm over the last dim,
    optionally after a residual add (``ref.rmsnorm_ref``);
  * :func:`rope_cache_write` (``csrc/rope_cache.cu``) — q and k rotated at
    the step's position from the model's frequency table, k and v written
    into their cache row (``ref.rope_cache_ref``);
  * :func:`decode_attention` (``csrc/decode_attention.cu``) — one query a
    slot over the cache read in place, split over its rows, the splits
    merged in a fixed order (``ref.decode_attention_ref``): bf16 over bf16
    at the head dims of ``MMA_HEAD_DIMS`` on the tensor cores, the splits
    of a (slot, kv head) one thread block cluster merged in distributed
    shared memory (:func:`split_plan`); other operands on the CUDA cores,
    merged by a second kernel (:func:`fma_split_plan`);
  * :func:`ssd_decode_step` (``csrc/ssd_decode.cu``) — the Mamba2 recurrent
    step between the projections and the gated norm, the conv buffers and
    the float32 state updated in place (``ref.ssd_decode_step_ref``); a
    block a (slot, group of heads), the slot's last block shifting the B
    and C conv buffers through a slot counter the kernel sets back to 0.
    The counters are one buffer a device: calls on one device are ordered
    on one stream (two at once on two streams would share them).

A position is a Python int (a launch argument) or a 0-d int64 tensor on
the tensors' device, which the kernel reads (a CUDA graph's position
buffer); both go through the same arithmetic, so the two give the same
bits.  The argument checks (``check_*``) take tensors on any device:
:mod:`repro_torch.kernels.meta`'s stand-ins run them too.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.kernels._build import (DTYPE_CODES, LaunchCounter,
                                        check_launch, library, stream_of)

rms_launches = LaunchCounter("rmsnorm")
rope_launches = LaunchCounter("rope_cache_write")
attn_launches = LaunchCounter("decode_attention")
ssd_launches = LaunchCounter("ssd_decode_step")

#: query heads a kv head, head dim (even), rows a split of the attention
#: on the CUDA cores
MAX_GROUP, MAX_HEAD_DIM, MAX_SPLIT_ROWS = 16, 256, 256
#: the attention's head dims on the tensor cores (bf16 q and caches), and
#: its most splits a (slot, kv head): a portable thread block cluster
MMA_HEAD_DIMS, MAX_CLUSTER = (64, 80, 128, 256), 8
#: the SSD step's conv depth and its block's shared memory (48 KB); its
#: slots a call (the slot counters a device, ``_slot_counters``)
MAX_CONV, SSD_SMEM_FLOATS, MAX_SSD_SLOTS = 8, 12 * 1024, 1024
#: the SMs a dry-run on ``meta`` plans the attention's splits for (an H100)
H100_SMS = 132
_FLOATS = (torch.float32, torch.bfloat16)

Position = Union[int, torch.Tensor]


def _fail(what: str) -> None:
    raise ValueError(what)


def _dtype(t: torch.Tensor, name: str, dtypes=_FLOATS) -> None:
    if t.dtype not in dtypes:
        _fail(f"{name} must be {' or '.join(map(str, dtypes))}, got "
              f"{t.dtype}")


def _shape(t: torch.Tensor, name: str, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        _fail(f"{name} is {tuple(t.shape)}, expected {tuple(shape)}")


def _contiguous(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous():
        _fail(f"{name} must be contiguous (written in place)")


def check_position(pos: Position, device: torch.device) -> None:
    """A Python int, or a 0-d int64 tensor on ``device``."""
    if isinstance(pos, torch.Tensor):
        if pos.ndim or pos.dtype != torch.int64 or pos.device != device:
            _fail(f"a tensor position must be a 0-d int64 on {device}, got "
                  f"{tuple(pos.shape)} {pos.dtype} on {pos.device}")
    elif isinstance(pos, bool) or not isinstance(pos, int):
        _fail(f"the position must be an int or a 0-d tensor, got "
              f"{type(pos).__name__}")


def _position(pos: Position) -> Tuple[Optional[int], int]:
    """(device address or None, host value) of a checked position."""
    if isinstance(pos, torch.Tensor):
        return pos.data_ptr(), 0
    return None, int(pos)


def check_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  residual: Optional[torch.Tensor] = None) -> Tuple[int, int]:
    """x (..., d) and the residual like it, float32 or bf16; scale (d,).
    Returns (rows, d)."""
    _dtype(x, "x")
    _dtype(scale, "scale")
    d = x.shape[-1] if x.ndim else 0
    if d == 0:
        _fail(f"x {tuple(x.shape)} has no last dim to norm")
    _shape(scale, "scale", (d,))
    if residual is not None:
        _dtype(residual, "residual", (x.dtype,))
        _shape(residual, "residual", x.shape)
    return x.numel() // d, d


def check_rope_cache(q, k, v, k_cache, v_cache, freqs=None
                     ) -> Tuple[int, int, int, int, int]:
    """q (B, 1, H, hd), k and v (B, 1, KV, hd) in one float dtype; the
    caches (B, S, KV, hd) in one float dtype, contiguous; freqs (hd/2,)
    float32 or None.  Returns (B, H, KV, S, hd)."""
    _dtype(q, "q")
    if q.ndim != 4 or q.shape[1] != 1:
        _fail(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    B, _, H, hd = q.shape
    if hd % 2 or hd <= 0:
        _fail(f"head dim {hd} must be even")
    for name, t in (("k", k), ("v", v)):
        _dtype(t, name, (q.dtype,))
    if k.ndim != 4 or k.shape[0] != B or k.shape[1] != 1 \
            or k.shape[3] != hd or H % k.shape[2]:
        _fail(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    KV = k.shape[2]
    _shape(v, "v", k.shape)
    _dtype(k_cache, "k_cache")
    _dtype(v_cache, "v_cache", (k_cache.dtype,))
    if k_cache.ndim != 4 or k_cache.shape[0] != B or k_cache.shape[1] < 1 \
            or tuple(k_cache.shape[2:]) != (KV, hd):
        _fail(f"k_cache {tuple(k_cache.shape)} does not fit k "
              f"{tuple(k.shape)}")
    _shape(v_cache, "v_cache", k_cache.shape)
    _contiguous(k_cache, "k_cache")
    _contiguous(v_cache, "v_cache")
    if freqs is not None:
        _dtype(freqs, "freqs", (torch.float32,))
        _shape(freqs, "freqs", (hd // 2,))
    return B, H, KV, k_cache.shape[1], hd


def check_decode_attention(q, k_cache, v_cache
                           ) -> Tuple[int, int, int, int, int]:
    """q (B, 1, H, hd) float32 or bf16; the caches (B, S, KV, hd) in one
    float dtype, contiguous; H a multiple of KV, at most MAX_GROUP query
    heads a kv head, hd even up to MAX_HEAD_DIM.  Returns (B, H, KV, S,
    hd)."""
    _dtype(q, "q")
    if q.ndim != 4 or q.shape[1] != 1:
        _fail(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    B, _, H, hd = q.shape
    _dtype(k_cache, "k_cache")
    _dtype(v_cache, "v_cache", (k_cache.dtype,))
    if k_cache.ndim != 4 or k_cache.shape[0] != B or k_cache.shape[3] != hd \
            or k_cache.shape[1] < 1 or k_cache.shape[2] < 1:
        _fail(f"k_cache {tuple(k_cache.shape)} does not fit q "
              f"{tuple(q.shape)}")
    _shape(v_cache, "v_cache", k_cache.shape)
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if H % KV or H // KV > MAX_GROUP:
        _fail(f"{H} query heads over {KV} kv heads: the kernel takes up to "
              f"{MAX_GROUP} a kv head")
    if hd % 2 or not 0 < hd <= MAX_HEAD_DIM:
        _fail(f"head dim {hd} must be even, at most {MAX_HEAD_DIM}")
    _contiguous(k_cache, "k_cache")
    _contiguous(v_cache, "v_cache")
    return B, H, KV, S, hd


def split_plan(B: int, KV: int, G: int, S: int, hd: int, sms: int) -> int:
    """Splits (blocks of one cluster) a (slot, kv head) on the tensor
    cores, a power of 2 up to MAX_CLUSTER: as many as keep every block
    resident at once (3 an SM up to head dim 128, by the cp.async ring's
    shared memory; at 256, one an SM, half the SMs, since a cluster of 8
    then needs 8 free SMs of one GPC: 8 splits ran slower than 4), but
    each split at least max(64, 16 G) of the S rows, so that its float32
    partial (G x (hd + 2), written to its shared memory and read once by
    the cluster) stays within ~6% of its K and V bytes.  The kernel
    spreads the rows valid at the step's position evenly over the
    splits."""
    blocks = 3 * sms if hd <= 128 else sms // 2
    want = min(blocks // max(B * KV, 1), MAX_CLUSTER,
               S // max(64, 16 * G))
    return 1 << (max(want, 1).bit_length() - 1)


def fma_split_plan(B: int, KV: int, S: int, sms: int) -> Tuple[int, int]:
    """(rows a split, splits) of the attention on the CUDA cores over S
    rows: enough splits for B * KV blocks each to fill the card eight times
    over (a block's rows are read by few threads each, so its loads overlap
    little), at least 32 and at most MAX_SPLIT_ROWS rows a split, a
    multiple of 16."""
    want = max(1, -(-8 * sms // max(B * KV, 1)))
    rows = min(MAX_SPLIT_ROWS, max(32, -(-S // want)))
    rows = -(-rows // 16) * 16
    return rows, -(-S // rows)


def attention_plan(q: torch.Tensor, k_cache: torch.Tensor, sms: int
                   ) -> Tuple[bool, int, int]:
    """(on the tensor cores, rows a split, splits) of a checked call: bf16
    q over bf16 caches at a head dim of MMA_HEAD_DIMS run on the tensor
    cores, with rows 0 (the kernel spreads the valid rows)."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if q.dtype == k_cache.dtype == torch.bfloat16 and hd in MMA_HEAD_DIMS:
        return True, 0, split_plan(B, KV, H // KV, S, hd, sms)
    return (False, *fma_split_plan(B, KV, S, sms))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def attention_scratch(B: int, H: int, hd: int, tensor_cores: bool,
                      splits: int, device
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """The CUDA-core splits' float32 outputs (splits, B, H, hd) and (max,
    sum) pairs (splits, B, H, 2); none for one split, and none on the
    tensor cores (the partials stay in the cluster's shared memory)."""
    if tensor_cores or splits == 1:
        return None, None
    return (torch.empty((splits, B, H, hd), dtype=torch.float32,
                        device=device),
            torch.empty((splits, B, H, 2), dtype=torch.float32,
                        device=device))


def ssd_heads_a_block(nh: int, hd: int, ds: int) -> int:
    """Heads a block of the SSD step (``csrc/ssd_decode.cu``
    heads_a_block): as many as make 4 float4s of state for each of its 256
    threads, 1 to 8."""
    return max(1, min(4 * 256 * 4 // (ds * hd), 8, nh))


_counters: Dict[int, torch.Tensor] = {}


def _slot_counters(device: torch.device) -> torch.Tensor:
    """The SSD step's MAX_SSD_SLOTS int32 slot counters on ``device``: zero
    between calls (the kernel sets them back), made once a device."""
    c = _counters.get(device.index)
    if c is None:
        c = _counters[device.index] = torch.zeros(
            MAX_SSD_SLOTS, dtype=torch.int32, device=device)
    return c


def ssd_dims(z, x, Bv, Cv, dt, p: Mapping[str, torch.Tensor],
             h: torch.Tensor, conv: Mapping[str, torch.Tensor]
             ) -> Tuple[int, int, int, int, int]:
    """The SSD step's checks: z, x (B, 1, nh*hd), Bv, Cv (B, 1, ds), dt
    (B, 1, nh) and the parameters ``p`` (dt_bias, A_log, D (nh,); conv_x,
    conv_B, conv_C (K, nh*hd), (K, ds), (K, ds)) in one float dtype; h
    (B, nh, ds, hd) float32 and the conv buffers ``conv`` (x, B, C: (B,
    K-1, nh*hd), (B, K-1, ds)) in one float dtype, contiguous.  Returns
    (B, nh, hd, ds, K)."""
    _dtype(x, "x")
    if x.ndim != 3 or x.shape[1] != 1:
        _fail(f"x must be (B, 1, d_inner), got {tuple(x.shape)}")
    Bsz, di = x.shape[0], x.shape[2]
    if dt.ndim != 3 or dt.shape[:2] != x.shape[:2] or dt.shape[2] < 1 \
            or di % dt.shape[2]:
        _fail(f"dt {tuple(dt.shape)} does not fit x {tuple(x.shape)}")
    nh = dt.shape[2]
    hd, ds = di // nh, Bv.shape[-1]
    K = p["conv_x"].shape[0]
    for name, t, shape in (
            ("z", z, x.shape), ("B", Bv, (Bsz, 1, ds)), ("C", Cv, Bv.shape),
            ("dt", dt, dt.shape), ("dt_bias", p["dt_bias"], (nh,)),
            ("A_log", p["A_log"], (nh,)), ("D", p["D"], (nh,)),
            ("conv_x", p["conv_x"], (K, di)),
            ("conv_B", p["conv_B"], (K, ds)),
            ("conv_C", p["conv_C"], (K, ds))):
        _dtype(t, name, (x.dtype,))
        _shape(t, name, shape)
    if hd % 4 or hd // 4 > 256:
        _fail(f"SSD head dim {hd} must be a multiple of 4 up to 1024")
    if not 2 <= K <= MAX_CONV:
        _fail(f"conv depth {K} must be 2..{MAX_CONV}")
    per = ssd_heads_a_block(nh, hd, ds)
    if 2 * ds + per * (hd + 2) + per * (256 // (hd // 4)) * hd \
            + (K - 1) * 2 * ds > SSD_SMEM_FLOATS:
        _fail(f"{nh} heads of {hd}, d_state {ds}: too large a block")
    if Bsz > MAX_SSD_SLOTS:
        _fail(f"{Bsz} slots: the SSD step takes up to {MAX_SSD_SLOTS}")
    _dtype(h, "h", (torch.float32,))
    _shape(h, "h", (Bsz, nh, ds, hd))
    _contiguous(h, "h")
    bufs = (("x", (Bsz, K - 1, di)), ("B", (Bsz, K - 1, ds)),
            ("C", (Bsz, K - 1, ds)))
    for key, shape in bufs:
        _dtype(conv[key], f"conv[{key!r}]", (conv["x"].dtype,)
               if key != "x" else _FLOATS)
        _shape(conv[key], f"conv[{key!r}]", shape)
        _contiguous(conv[key], f"conv[{key!r}]")
    return Bsz, nh, hd, ds, K


def _on_card(name: str, device: torch.device, *tensors) -> None:
    """Every tensor a CUDA tensor on ``device``."""
    for i, t in enumerate(tensors):
        if not t.is_cuda or t.device != device:
            _fail(f"{name}: argument {i} is on {t.device}, expected "
                  f"{device}")


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float,
            residual: Optional[torch.Tensor] = None):
    """RMSNorm of x over its last dim (``ref.rmsnorm_ref``): y in x's
    dtype; with a residual, (x + residual, its norm)."""
    rows, d = check_rmsnorm(x, scale, residual)
    dev = x.device
    x = x.contiguous()
    res = None if residual is None else residual.contiguous()
    _on_card("rmsnorm", dev, x, scale, *([] if res is None else [res]))
    scale = scale.contiguous()
    y = torch.empty_like(x)
    s = None if res is None else torch.empty_like(x)
    check_launch(library().rmsnorm_fwd(
        x.data_ptr(), None if res is None else res.data_ptr(),
        scale.data_ptr(), y.data_ptr(), None if s is None else s.data_ptr(),
        DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype], rows, d, float(eps),
        dev.index, stream_of(x)), "rmsnorm")
    rms_launches.add()
    return y if s is None else (s, y)


def rope_cache_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: Position, *, freqs: Optional[torch.Tensor] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """q and k rotated at ``pos`` by ``freqs`` (none: no rotation), k and v
    written into the caches' row (``ref.rope_cache_ref``).  Returns q."""
    B, H, KV, S, hd = check_rope_cache(q, k, v, k_cache, v_cache, freqs)
    dev = q.device
    check_position(pos, dev)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _on_card("rope_cache_write", dev, q, k, v, k_cache, v_cache,
             *([] if freqs is None else [freqs]))
    q_out = q if freqs is None else torch.empty_like(q)
    ptr, host = _position(pos)
    check_launch(library().rope_cache_write(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_out.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(),
        None if freqs is None else freqs.contiguous().data_ptr(), ptr, host,
        DTYPE_CODES[q.dtype], DTYPE_CODES[k_cache.dtype], B, H, KV, S, hd,
        int(window is not None and S == window), dev.index, stream_of(q)),
        "rope_cache_write")
    rope_launches.add()
    return q_out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, pos: Position,
                     window: Optional[int] = None, logit_cap: float = 0.0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """(B, 1, H, hd) attention of one query a slot over the caches' rows
    valid at ``pos`` (``ref.decode_attention_ref``), in q's dtype."""
    B, H, KV, S, hd = check_decode_attention(q, k_cache, v_cache)
    dev = q.device
    check_position(pos, dev)
    q = q.contiguous()
    _on_card("decode_attention", dev, q, k_cache, v_cache)
    tensor_cores, rows, splits = attention_plan(q, k_cache, _sms(dev.index))
    align = 16 if tensor_cores else 8
    if k_cache.data_ptr() % align or v_cache.data_ptr() % align:
        _fail(f"the caches must start on {align} bytes (read {align} "
              f"bytes at a time)")
    part_o, part_ml = attention_scratch(B, H, hd, tensor_cores, splits, dev)
    o = torch.empty_like(q)
    ptr, host = _position(pos)
    sc = scale if scale is not None else 1.0 / math.sqrt(hd)
    check_launch(library().decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
        None if part_o is None else part_o.data_ptr(),
        None if part_ml is None else part_ml.data_ptr(), ptr, host,
        DTYPE_CODES[q.dtype], DTYPE_CODES[k_cache.dtype], B, H, KV, S, hd,
        rows, splits, int(window) if window is not None and S > window
        else 0, float(sc), float(logit_cap or 0.0), dev.index,
        stream_of(q)), "decode_attention")
    attn_launches.add()
    return o


def ssd_decode_step(z: torch.Tensor, x: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, dt: torch.Tensor,
                    p: Mapping[str, torch.Tensor], *, h: torch.Tensor,
                    conv: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The Mamba2 recurrent step of one token (``ref.ssd_decode_step_ref``):
    returns y (B, 1, nh*hd) = (C . h + D x) * silu(z), with the conv
    buffers ``conv`` and the state ``h`` updated in place."""
    Bsz, nh, hd, ds, K = ssd_dims(z, x, B, C, dt, p, h, conv)
    dev = x.device
    ins = [t.contiguous() for t in (
        z, x, B, C, dt, p["dt_bias"], p["A_log"], p["D"], p["conv_x"],
        p["conv_B"], p["conv_C"])]
    bufs = [conv[k] for k in ("x", "B", "C")]
    _on_card("ssd_decode_step", dev, *ins, *bufs, h)
    if h.data_ptr() % 16:
        _fail("h must start on 16 bytes")
    y = torch.empty_like(ins[1])
    check_launch(library().ssd_decode_step(
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in bufs),
        h.data_ptr(), y.data_ptr(), _slot_counters(dev).data_ptr(),
        DTYPE_CODES[x.dtype],
        DTYPE_CODES[bufs[0].dtype], Bsz, nh, hd, ds, K, dev.index,
        stream_of(x)), "ssd_decode_step")
    ssd_launches.add()
    return y
