"""Roofline terms of one H100, and the work of each hand-written kernel.

The port's counterpart of the JAX package's ``launch/roofline.py``, with
its terms and formulas:

    compute    = FLOPs_per_card / peak_FLOP/s
    memory     = HBM_bytes_per_card / HBM_bw
    collective = collective_bytes_per_card / link_bw   (0 on one card)

The constants are the spec-sheet peaks of one H100 SXM5 at its full 700 W
(NVIDIA's data sheet, dense, no sparsity): 989 TFLOP/s bf16 on the tensor
cores, 495 TF32, 67 FP32 on the CUDA cores, 3.35 TB/s of HBM3, and NVLink
4 at 900 GB/s both ways (450 GB/s a direction).  ``HBM_PER_CARD`` is the
card's ``total_memory`` as PyTorch reports it on the H100 80GB HBM3.

The second half holds one work formula per hand-written LM kernel,
forward and backward, for the train step's kernels (AdamW, the
microbatch accumulation) and for the decode step's (RMSNorm, rope with the
cache write, decode attention, the Mamba2 recurrent step): the FLOPs it must do and the bytes it must move
(each input read once, each output written once) for the call's shapes.
The dry-run (:mod:`repro_torch.launch.op_analysis`) adds them to a step's
counts wherever a model reaches the kernel, and the card's checks
(``chip_smoke.py``) take each kernel's bound from them (:func:`bound_ms`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

PEAK_FLOPS = 989e12         # bf16, dense, tensor cores, per card
PEAK_TF32_FLOPS = 495e12    # TF32, dense, tensor cores
PEAK_FP32_FLOPS = 67e12     # FP32, CUDA cores
HBM_BW = 3.35e12            # bytes/s per card
LINK_BW = 450e9             # bytes/s per direction, NVLink 4
#: ``torch.cuda.get_device_properties(0).total_memory`` of the H100 80GB
#: HBM3 (81079 MiB, under CUDA 12.8)
HBM_PER_CARD = 85_017_493_504

#: MODEL_FLOPS multiplier per step kind: train = fwd+bwd (6ND),
#: prefill/decode = fwd only (2ND); N = active params, D = tokens.
KIND_FACTOR = {"train": 6.0, "prefill": 2.0, "decode": 2.0}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float           # global useful FLOPs (6·N·D or 2·N·D)
    hlo_flops: float             # counted FLOPs (per card × cards)
    chips: int

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline (no-overlap lower bound = max of the three terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/redundancy waste detector."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Model-FLOPs utilisation at the roofline step time:
        useful FLOPs / (cards × peak × step_time)."""
        denom = self.chips * PEAK_FLOPS * self.step_time_s
        return self.model_flops / denom if denom else 0.0

    def to_json(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_fraction": self.useful_fraction,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }


def roofline(*, per_chip_flops: float, per_chip_hbm_bytes: float,
             per_chip_collective_bytes: float, chips: int,
             active_params: float, tokens: float, kind: str) -> Roofline:
    model_flops = KIND_FACTOR[kind] * active_params * tokens
    return Roofline(
        compute_s=per_chip_flops / PEAK_FLOPS,
        memory_s=per_chip_hbm_bytes / HBM_BW,
        collective_s=per_chip_collective_bytes / LINK_BW,
        model_flops=model_flops,
        hlo_flops=per_chip_flops * chips,
        chips=chips,
    )


def mfu(model_flops: float, seconds: float, chips: int = 1) -> float:
    """Model-FLOPs utilisation of a measured step: useful FLOPs over
    (cards × peak × the step's seconds)."""
    return model_flops / (chips * PEAK_FLOPS * seconds) if seconds else 0.0


# ---------------------------------------------------------------------------
# The kernels' work: (FLOPs, bytes) of one call, and its bound
# ---------------------------------------------------------------------------

Work = Tuple[float, float]


def peak_for(dtype: torch.dtype) -> float:
    """The peak rate of a kernel's products in ``dtype``: bf16 on the
    tensor cores, anything else at FP32."""
    return PEAK_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS


def bound_ms(nbytes: float, ops_count: float, peak: float = PEAK_FP32_FLOPS):
    """The least time for ``nbytes`` moved and ``ops_count`` operations at
    ``peak`` operations/s (FP32 unless the inputs' type has another):
    (ms, "bytes" or "operations", whichever binds)."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops_count / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _size(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _tri_sum(x: int, n: int) -> int:
    """sum_{j=1..x} min(j, n), 0 for x <= 0."""
    if x <= 0:
        return 0
    if x <= n:
        return x * (x + 1) // 2
    return n * (n + 1) // 2 + (x - n) * n


def _pairs_below(Sq: int, n: int, d: int) -> int:
    """#{(q, k): 0 <= q < Sq, 0 <= k < n, k <= q + d}."""
    return _tri_sum(d + Sq, n) - _tri_sum(d, n)


def flash_pairs(Sq: int, Sk: int, *, causal: bool = True,
                window: Optional[int] = None,
                kv_len: Optional[int] = None, q_offset: int = 0) -> int:
    """The (query, key) pairs flash's mask keeps: key k < ``kv_len`` (all
    Sk without it), k <= q under ``causal``, k > q - ``window`` under a
    window, in closed form; query q at position ``q_offset`` + q (a
    sequence shard's queries, ``ops.flash_attention_offset_bshd``)."""
    n = Sk if kv_len is None else max(0, min(Sk, int(kv_len)))
    kept = _pairs_below(Sq, n, q_offset) if causal else Sq * n
    if window is not None:
        kept -= _pairs_below(Sq, n, q_offset - int(window))
    return kept


def flash_work(B, H, KV, Sq, Sk, hd, dtype, *, causal: bool = True,
               window: Optional[int] = None,
               kv_len: Optional[int] = None, q_offset: int = 0,
               **_) -> Work:
    """Bytes: q, k, v read and o written once.  Operations: the two
    products (2 per multiply-add) over the (query, key) pairs the mask
    keeps in this call."""
    pairs = flash_pairs(Sq, Sk, causal=causal, window=window, kv_len=kv_len,
                        q_offset=q_offset)
    nbytes = _size(dtype) * (2 * B * H * Sq * hd + 2 * B * KV * Sk * hd)
    return 4.0 * B * H * pairs * hd, float(nbytes)


def flash_bound(B, H, KV, Sq, Sk, hd, dtype, **kw):
    flops, nbytes = flash_work(B, H, KV, Sq, Sk, hd, dtype, **kw)
    return bound_ms(nbytes, flops, peak_for(dtype))


def flash_bwd_work(B, H, KV, S, hd, dtype, causal: bool = True,
                   Sk: Optional[int] = None,
                   window: Optional[int] = None, q_offset: int = 0) -> Work:
    """Bytes: q, o, dO and the float32 lse read and dq written (four
    query-sized tensors), k and v read and dk, dv written (four key-sized
    ones), each once.  Operations: five products (S, dP, dV, dK, dQ) of 2
    per multiply-add over the (query, key) pairs the mask keeps (``Sk``
    keys, S by default; the queries from ``q_offset``)."""
    Sk = S if Sk is None else Sk
    pairs = flash_pairs(S, Sk, causal=causal, window=window,
                        q_offset=q_offset)
    nbytes = (_size(dtype) * (4 * B * H * S * hd + 4 * B * KV * Sk * hd)
              + 4 * B * H * S)
    return 5 * 2.0 * B * H * pairs * hd, float(nbytes)


def flash_bwd_bound(B, H, KV, S, hd, dtype, causal=True, Sk=None,
                    window=None, q_offset=0):
    flops, nbytes = flash_bwd_work(B, H, KV, S, hd, dtype, causal, Sk,
                                   window, q_offset)
    return bound_ms(nbytes, flops, peak_for(dtype))


def ssd_bytes(Bsz, S, nh, hd, ds, dtype, h0: bool = False):
    """x, B, C (dtype), dt (f32) read, y written, A and the state."""
    size = _size(dtype)
    return (Bsz * S * (2 * nh * hd * size + 2 * ds * size + 4 * nh)
            + 4 * nh + 4 * Bsz * nh * ds * hd * (2 if h0 else 1))


def ssd_work(Bsz, S, chunk, nh, hd, ds, dtype, h0: bool = False) -> Work:
    """Bytes: ``ssd_bytes``.  Operations of the chunked algorithm (C.B^T
    once per chunk, not per head): per chunk the (Q, Q) lower triangle of
    C.B^T, and per head its decay (exp, subtract, multiply), y_diag over
    the triangle, the carried-state term and the state update."""
    nc, tri = S // chunk, chunk * (chunk + 1) // 2
    ops_count = Bsz * nc * (2 * tri * ds + nh * (3 * tri + 2 * tri * hd
                                                 + 4 * chunk * ds * hd))
    return float(ops_count), float(ssd_bytes(Bsz, S, nh, hd, ds, dtype, h0))


def ssd_bound(Bsz, S, chunk, nh, hd, ds, dtype, h0: bool = False):
    flops, nbytes = ssd_work(Bsz, S, chunk, nh, hd, ds, dtype, h0)
    return bound_ms(nbytes, flops, peak_for(dtype))


def ssd_split_bound(Bsz, S, chunk, nh, hd, ds, dtype, h0: bool = False):
    """The bound at the rate of the instructions the kernel issues: its
    products (C.B^T over the triangle once per chunk; per head the
    masked-decay tile times dt x, the carried-state term and the state
    update), each issued three times (split TF32: lo.hi + hi.lo + hi.hi),
    at the TF32 tensor-core peak; bytes as ``ssd_bound``."""
    nc, tri = S // chunk, chunk * (chunk + 1) // 2
    products = Bsz * nc * (2 * tri * ds + nh * (2 * tri * hd
                                                + 4 * chunk * ds * hd))
    return bound_ms(ssd_bytes(Bsz, S, nh, hd, ds, dtype, h0),
                    3.0 * products, PEAK_TF32_FLOPS)


def ssd_bwd_products(Bsz, S, chunk, nh, hd, ds):
    """Multiply-adds of the least algorithm's products (``ssd_bwd_work``)."""
    nc, tri = S // chunk, chunk * (chunk + 1) // 2
    return Bsz * nc * (nh * (4 * chunk * ds * hd + 2 * tri * hd)
                       + 3 * tri * ds)


def ssd_bwd_bytes(Bsz, S, chunk, nh, hd, ds, h0, dh):
    """The bytes ``ssd_bwd_work`` counts."""
    nc = S // chunk
    return 4 * (3 * Bsz * S * nh * hd + Bsz * nc * nh * ds * hd
                + Bsz * nh * ds * hd * (int(h0) + int(dh))
                + 3 * Bsz * S * nh + 4 * Bsz * S * ds + 2 * nh)


def ssd_bwd_work(Bsz, S, chunk, nh, hd, ds, h0: bool = False,
                 dh: bool = False) -> Work:
    """Bytes: x, dy, dx (each Bsz x S x nh x hd), the chunk-start states
    and, where present, h0's and dh_final's gradients moved once; dt, ddt,
    cum, B, C, dB, dC, A, dA.  Operations of the least algorithm (C.B^T and
    the dCB products once per chunk, dCB summed over the heads): per (batch,
    chunk, head) four state products of Q ds hd multiply-adds (D_c,
    r (B . g), e (h . dy), r (g . u)) and two over the (Q, Q) lower
    triangle of hd each (du, dG), about 3 operations an entry of the
    triangle for L, dCB and M; per (batch, chunk) three triangle products
    of ds (C.B^T, dCB.B, dCB^T.C); 2 operations per multiply-add."""
    nc, tri = S // chunk, chunk * (chunk + 1) // 2
    macs = (ssd_bwd_products(Bsz, S, chunk, nh, hd, ds)
            + Bsz * nc * nh * 1.5 * tri)
    return (2.0 * macs,
            float(ssd_bwd_bytes(Bsz, S, chunk, nh, hd, ds, h0, dh)))


def ssd_bwd_bound(Bsz, S, chunk, nh, hd, ds, h0: bool = False,
                  dh: bool = False):
    flops, nbytes = ssd_bwd_work(Bsz, S, chunk, nh, hd, ds, h0, dh)
    return bound_ms(nbytes, flops)


def ssd_bwd_split_bound(Bsz, S, chunk, nh, hd, ds, h0: bool = False,
                        dh: bool = False):
    """The bound at the rate of the instructions the kernel issues: the
    least algorithm's products (``ssd_bwd_work`` without the elementwise
    work on the triangle), each issued three times (split TF32: lo.hi +
    hi.lo + hi.hi), at the TF32 tensor-core peak; bytes as
    ``ssd_bwd_work``."""
    return bound_ms(ssd_bwd_bytes(Bsz, S, chunk, nh, hd, ds, h0, dh),
                    3.0 * 2.0 * ssd_bwd_products(Bsz, S, chunk, nh, hd, ds),
                    PEAK_TF32_FLOPS)


def gmm_work(E, C, d, f, dtype) -> Work:
    """Bytes: x, w read and y written once.  Operations: 2 per multiply-add
    of the E products."""
    nbytes = _size(dtype) * (E * C * d + E * d * f + E * C * f)
    return 2.0 * E * C * d * f, float(nbytes)


def gmm_bound(E, C, d, f, dtype):
    flops, nbytes = gmm_work(E, C, d, f, dtype)
    return bound_ms(nbytes, flops, peak_for(dtype))


def gmm_bwd_work(E, C, d, f, dtype) -> Work:
    """dx = dy w^T and dw = x^T dy of ``y = x w`` at (E, C, d) x (E, d, f),
    as one function: x, w and dy read and dx, dw written once; 2 products
    of 2 operations per multiply-add."""
    nbytes = _size(dtype) * (2 * E * C * d + 2 * E * d * f + E * C * f)
    return 4.0 * E * C * d * f, float(nbytes)


def gmm_bwd_bound(E, C, d, f, dtype):
    flops, nbytes = gmm_bwd_work(E, C, d, f, dtype)
    return bound_ms(nbytes, flops, peak_for(dtype))


#: float32 operations of the update an element: g * scale; m's two
#: products and its sum; v's three products and its sum; two reciprocal
#: products, the square root, + eps, the division; the decay's product and
#: sum; lr's product and the subtraction
ADAMW_UPDATE_OPS = 17


def adamw_sumsq_work(numels, g_dtypes) -> Work:
    """Each gradient's sum of squares: every gradient read once, a float32
    sum a tensor written; 2 operations an element."""
    n = sum(numels)
    return (2.0 * n, float(sum(k * _size(d) for k, d in zip(numels, g_dtypes))
                           + 4 * len(numels)))


def adamw_sum_work(n: int) -> Work:
    """The per-tensor sums added up: n float32 read, one written."""
    return float(n), 4.0 * (n + 1)


def adamw_update_work(numels, p_dtypes, g_dtypes) -> Work:
    """The update: p, g and the float32 m, v read once and p, m, v written
    once (22 bytes an element for bf16 p and g), and the scale read."""
    nbytes = sum(k * (2 * _size(pd) + _size(gd) + 16)
                 for k, pd, gd in zip(numels, p_dtypes, g_dtypes))
    return ADAMW_UPDATE_OPS * float(sum(numels)), float(nbytes + 4)


def adamw_work(numels, p_dtypes, g_dtypes=None) -> Work:
    """The optimizer's step over tensors of ``numels`` elements (parameters
    of ``p_dtypes``, gradients of ``g_dtypes``, the parameters' by default):
    the sum of squares, the sum of the per-tensor sums and the update, ~24
    bytes an element for bf16 parameters and gradients."""
    g_dtypes = p_dtypes if g_dtypes is None else g_dtypes
    parts = (adamw_sumsq_work(numels, g_dtypes),
             adamw_sum_work(len(numels)),
             adamw_update_work(numels, p_dtypes, g_dtypes))
    return sum(f for f, _ in parts), sum(b for _, b in parts)


def adamw_bound(numels, p_dtypes, g_dtypes=None):
    flops, nbytes = adamw_work(numels, p_dtypes, g_dtypes)
    return bound_ms(nbytes, flops)


def grad_accum_work(numels, g_dtypes, mode: str) -> Work:
    """One microbatch's accumulation: every gradient read once, every
    float32 accumulator written once and, but in the ``first`` call, read
    once (6 and 10 bytes an element with bf16 gradients); one float32
    addition an element, two in the ``last`` call (the scale)."""
    acc = 4 if mode == "first" else 8
    nbytes = sum(k * (_size(d) + acc) for k, d in zip(numels, g_dtypes))
    return (2.0 if mode == "last" else 1.0) * sum(numels), float(nbytes)


def grad_accum_bound(numels, g_dtypes, mode: str):
    flops, nbytes = grad_accum_work(numels, g_dtypes, mode)
    return bound_ms(nbytes, flops)


# ---------------------------------------------------------------------------
# the decode step's kernels
# ---------------------------------------------------------------------------

def rmsnorm_work(rows: int, d: int, dtype, scale_dtype,
                 residual: bool = False) -> Work:
    """x (and the residual) and scale read, y (and the sum) written once;
    4 operations an element (square, sum, two products), 5 with the
    residual's add."""
    n = rows * d
    nbytes = _size(dtype) * n * (4 if residual else 2) + _size(scale_dtype) * d
    return (5.0 if residual else 4.0) * n, float(nbytes)


def rmsnorm_bound(rows, d, dtype, scale_dtype, residual=False):
    flops, nbytes = rmsnorm_work(rows, d, dtype, scale_dtype, residual)
    return bound_ms(nbytes, flops)


def rope_cache_work(B: int, H: int, KV: int, hd: int, dtype, cache_dtype,
                    rope: bool = True) -> Work:
    """q, k, v read once, the rotated q written and a cache row of k and v
    written (and the frequency table read) with rope; the row alone
    without.  6 operations a rotated pair (the angle, four products, a sum
    or difference) and its cosine and sine, 8 in all."""
    size = _size(dtype)
    nbytes = (2 * B * KV * hd * size + 2 * B * KV * hd * _size(cache_dtype)
              + ((2 * B * H * hd * size + 2 * hd) if rope else 0))
    return (4.0 * B * (H + KV) * hd if rope else 0.0), float(nbytes)


def rope_cache_bound(B, H, KV, hd, dtype, cache_dtype, rope=True):
    flops, nbytes = rope_cache_work(B, H, KV, hd, dtype, cache_dtype, rope)
    return bound_ms(nbytes, flops)


def decode_rows(S: int, pos: Optional[int], window: Optional[int]) -> int:
    """The cache rows a decode query at ``pos`` attends to (all S where the
    position is not known on the host, or none is valid)."""
    if pos is None:
        return S
    hi = min(pos, S - 1)
    lo = max(0, pos - window + 1) if window is not None and S > window \
        else 0
    return hi - lo + 1 if hi >= lo else S


def decode_attention_work(B: int, H: int, KV: int, rows: int, hd: int,
                          dtype, cache_dtype) -> Work:
    """q read and o written once, the ``rows`` valid rows of K and V read
    once; 4 operations a (query head, row, column): the two products'
    multiply-adds."""
    nbytes = (2 * B * H * hd * _size(dtype)
              + 2 * B * KV * rows * hd * _size(cache_dtype))
    return 4.0 * B * H * rows * hd, float(nbytes)


def decode_attention_bound(B, H, KV, rows, hd, dtype, cache_dtype):
    flops, nbytes = decode_attention_work(B, H, KV, rows, hd, dtype,
                                          cache_dtype)
    return bound_ms(nbytes, flops)


def ssd_decode_work(B: int, nh: int, hd: int, ds: int, K: int, dtype,
                    buf_dtype) -> Work:
    """The float32 state read and written once; z, x, B, C, dt and the
    parameters read, y written, the conv buffers read and written once.
    Operations: 5 a state element (h a, B (dt x), the sum, C h, the sum),
    2 a conv tap of every channel."""
    di, size = nh * hd, _size(dtype)
    nbytes = (8 * B * nh * ds * hd
              + size * (B * (3 * di + 2 * ds + nh) + 3 * nh
                        + K * (di + 2 * ds))
              + 2 * _size(buf_dtype) * B * (K - 1) * (di + 2 * ds))
    return (5.0 * B * nh * ds * hd + 2.0 * K * B * (di + 2 * ds),
            float(nbytes))


def ssd_decode_bound(B, nh, hd, ds, K, dtype, buf_dtype):
    flops, nbytes = ssd_decode_work(B, nh, hd, ds, K, dtype, buf_dtype)
    return bound_ms(nbytes, flops)
