#!/usr/bin/env python3
"""Tile shapes and knock-out builds of the port's redesigned kernels, timed
on one CUDA card.

    python3 chip_kernel_shapes.py [flash] [flash_bwd] [gmm] [ssd] [ssd_bwd]
                                  [saxpy] [nbody] [sass]

(no argument: all eight).  Rebuilds a kernel's source with one setting
replaced, each variant into its own library under ``build/shapes/``, all
built at once, and times each at the main paths' shapes (CUDA-event means
over 50 launches after a warm-up, twice), its output held to the plain
version under the ``chip_smoke.py`` tolerance, the library call timed
beside as a yardstick.  The sources' own choice is the first variant of
each list.
- flash (bf16): keys a tile, cp.async stages, blocks an SM (the ``Cfg``
  alias); two builds knock one part out (the K/V loads, the lo half of
  P's product).
- flash_bwd (bf16), at granite's training call (8, 24/8, 512, 64) causal:
  as built, then the dK/dV kernel (``KvShape``) with 3 stages, or 16-row
  pieces, or built for 1 block an SM, the dQ kernel (``QShape``) with 3
  stages or 32-key pieces, and with the lo halves of P and dS
  knocked out of each kernel's products (one bf16 rounding: its error is
  reported); each with its three kernels' device time from
  ``torch.profiler``.
- gmm (bf16): tile rows and columns, TMA stages, blocks an SM (the
  ``Prefill`` alias); and of the backward kernels (the ``Dx`` and ``Dw``
  aliases, built alike), dx and dw each timed at granite's training
  shapes, w_in (40, 1024, 1536, 512) and w_out (40, 1024, 512, 1536),
  beside ``torch.bmm`` on transposed views, with each product's share of
  its bound.
- ssd, at zamba2's call, x (1, 1536, 80 x 64) float32, chunk 256: as built
  (with each of its four kernels' device time from ``torch.profiler``),
  built for 2 blocks an SM, and with one part knocked out each: the lo
  products of the TF32 split (one TF32 pass: its error is reported), the
  C.B^T pass, the decay tile's exp, every product, every split into shared
  memory.
- ssd_bwd, the SSD scan's backward at zamba2's training call, x (8, 512,
  80 x 64) float32, d_state 64, chunk 256: as built, called with its own
  groups of heads, with one head a group (the heads not grouped), 8 and 16
  heads a group, and one group of all heads; with the lo passes of its split products knocked
  out (one TF32 pass: its error is reported), and the key kernel's
  query-tile products, their staging, or M's sums knocked out; the query
  kernel built for 2 blocks an SM; each with its eight kernels' device
  time from
  ``torch.profiler``, and each checked build held to autograd through the
  plain version under ``chip_smoke.SSD_BWD_TOL``.
- saxpy, at one slot's 2e7 elements: 1, 2, 4 and 8 float4 loads of x and
  of y a thread, beside ``torch.add``.
- nbody, at one slot's targets against all bodies at the paper's three
  size classes: as built (with each of its kernels' device time from
  ``torch.profiler``, and the SASS instruction mix of the sweep); the
  plan aimed at 4, 8 or 32 blocks an SM, or one split (same build);
  built for 2 or 8 targets a thread, a 256-source tile, 16 sources
  unrolled, the subnormal-safe ``rsqrtf``, launches that wait in full for
  the one before; and without the reduction pass.
- sass: the SASS instruction mix of every kernel of the port as built
  (``cuobjdump``), by opcode.
A knocked-out build's output is wrong and not checked.  Prints the card,
one line a variant and the registers and spills ``ptxas`` reports, and
writes ``build/kernel_shapes.json``.  Exits non-zero without a card.
"""
from __future__ import annotations

import collections
import concurrent.futures
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke as cs
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import nbody as nbody_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.flash_attention import NO_WINDOW

CSRC = cs.ROOT / "src" / "repro_torch" / "csrc"
OUT = cs.ROOT / "build" / "shapes"
REPS = 50
#: (keys a tile, stages, blocks an SM) of the bf16 flash kernel at
#: head_dim <= 80
FLASH_CFG = ("using Cfg = Shape<HD, (HD > 128 ? 16 : 64), (HD <= 80 ? 3 : 2),"
             "\n                  (HD <= 80 ? 2 : 1)>;")
FLASH_VARIANTS = [(64, 3, 2), (64, 2, 2), (64, 4, 2), (64, 3, 3), (64, 2, 3),
                  (32, 4, 2)]
#: parts of the bf16 flash kernel knocked out, to see what they cost (the
#: output is then wrong and not checked): the K/V loads after the ring's
#: first tiles, and the product of P's lo half
FLASH_KNOCKOUTS = {
    "kv_loads": ("      if (nxt < n_tiles) {", "      if (false) {"),
    "lo_product": ("        mma(acc[2 * n], pl, bv[0], bv[1]);\n"
                   "        mma(acc[2 * n + 1], pl, bv[2], bv[3]);\n", ""),
}
#: the flash backward's variants at hd 64: (name, a line of the source,
#: what replaces it)
FLASH_BWD_VARIANTS = [
    ("kv_stages3", "  static constexpr int BQ = HD > 128 ? 32 : 64;\n"
     "  static constexpr int STAGES = 2;",
     "  static constexpr int BQ = HD > 128 ? 32 : 64;\n"
     "  static constexpr int STAGES = 3;"),
    ("kv_pieces16", "  static constexpr int PQ = HD <= 80 ? 32 : 16;",
     "  static constexpr int PQ = 16;"),
    ("kv_blocks1", "  static constexpr int kMinBlocks = HD <= 128 ? 2 : 1;\n"
     "  static constexpr int BK = 16",
     "  static constexpr int kMinBlocks = 1;\n  static constexpr int BK = 16"),
    ("q_stages3", "  static constexpr int BK = HD > 128 ? 32 : 64;\n"
     "  static constexpr int STAGES = 2;",
     "  static constexpr int BK = HD > 128 ? 32 : 64;\n"
     "  static constexpr int STAGES = 3;"),
    ("q_pieces32", "  static constexpr int PK = 16;",
     "  static constexpr int PK = 32;"),
    ("kv_without_lo", "          mma(acc_v[2 * n], pl, bo[0], bo[1]);\n"
     "          mma(acc_v[2 * n + 1], pl, bo[2], bo[3]);\n"
     "          mma(acc_k[2 * n], sl, bq[0], bq[1]);\n"
     "          mma(acc_k[2 * n + 1], sl, bq[2], bq[3]);\n", ""),
    ("q_without_lo", "          mma(acc[2 * n], sl, bk[0], bk[1]);\n"
     "          mma(acc[2 * n + 1], sl, bk[2], bk[3]);\n", ""),
]
#: (B, H, KV, S, hd) of the flash backward: granite's training call
FLASH_BWD = (8, 24, 8, 512, 64)
#: (tile rows, tile columns, stages, blocks an SM) of the grouped GEMM at
#: C > 64
GMM_CFG = "using Prefill = Cfg<128, 128, 3, 2>;"
GMM_VARIANTS = [(128, 128, 3, 2), (128, 128, 4, 1), (128, 256, 4, 1),
                (128, 256, 3, 1), (128, 64, 4, 2)]
#: (tile rows, tile columns, stages, blocks an SM) of the backward kernels,
#: dx's and dw's aliases built alike
GMM_BWD_CFG = ("using Dx = Cfg<128, 256, 3, 1>;",
               "using Dw = Cfg<128, 256, 3, 1>;")
GMM_BWD_VARIANTS = [(128, 256, 3, 1), (128, 128, 4, 1), (128, 128, 5, 1),
                    (256, 128, 3, 1), (128, 128, 2, 2), (128, 64, 3, 2),
                    (64, 128, 3, 2)]
#: (E, C, d, f) of the backward: granite's training products
GMM_BWD = {"w_in": (40, 1024, 1536, 512), "w_out": (40, 1024, 512, 1536)}
#: parts of the SSD scan knocked out (the output is then wrong, and only
#: the one-pass TF32 build's error is reported): the lo.hi and hi.lo
#: products of every split product; the C.B^T launch; the decay tile's exp;
#: every product; every split of a staged piece into shared memory
SSD_KNOCKOUTS = {
    "lo_products": ("      mma_tf32(acc[n], al, bh0, bh1);\n"
                    "      mma_tf32(acc[n], ah, bl0, bl1);\n", ""),
    "cb_pass": ("ssd_cb<T><<<dim3(", "if (false) ssd_cb<T><<<dim3("),
    "decay_exp": ("exp2_approx((q - cumc[", "((q - cumc["),
    "products": ("warp_product<NT, ", "if (false) warp_product<NT, "),
    "staging": ("      put_split4(hi, lo, row(u) * ld + col(u), "
                "f(row(u), col(u), v[u]));\n", "      ;\n"),
}
#: blocks an SM the SSD kernels with a 64-wide output are built for (the
#: source's choice first)
SSD_CFG = "  return NC <= 64 ? 3 : 2;"
SSD_MIN_BLOCKS = [3, 2]
#: (Bsz, S, nh, hd, ds, chunk): zamba2-2.7b's SSD call, 1536 tokens
SSD = (1, 1536, 80, 64, 64, 256)
#: the SSD backward's builds besides the source's: (name, a line of the
#: source or of a header it includes, what replaces it).  Knocked out (the
#: output is then wrong; only the one-TF32-pass build's error is reported):
#: the lo passes of every split product; in the key kernel, the two products
#: of its query-tile steps (dG and du), their staging (dy, G and L), and M's
#: sums with dCB's accumulation (dG's product then goes too).  Built
#: otherwise: the query kernel for 2 blocks an SM (128 registers, it
#: spills)
SSD_BWD_VARIANTS = [
    ("without_lo", ("      mma_tf32(acc[n], al, bh0, bh1);\n"
                    "      mma_tf32(acc[n], ah, bl0, bl1);\n",
                    "            mma_tf32(c, al[j], bh0, bh1);\n"
                    "            mma_tf32(c, ah[j], bl0, bl1);\n"),
     ("", "")),
    ("without_key_products",
     ("      product32<false, true, kUn, kOneM>(dacc, D, U,\n"
      "                                         min(kTile, hd - ec * kTile), "
      "f);\n",
      "        if (i == ec)\n          product32<true, false, kUn, kOneM>("
      "keep[i], Gt, D,"),
     ("", "        if (false)\n          product32<true, false, kUn, kOneM>("
      "keep[i], Gt, D,")),
    ("without_key_staging", "    put(p1, D, Same());\n    if (ec == 0)\n",
     "    if (false)\n"),
    ("without_key_m", "      if (ec == NE - 1) {\n        // dCB_h = dG o L",
     "      if (false) {\n        // dCB_h = dG o L"),
    ("queries_blocks2", "__global__ void __launch_bounds__(kThreads, 1)\n"
     "    ssd_bwd_queries(", "__global__ void __launch_bounds__(kThreads, 2)"
     "\n    ssd_bwd_queries("),
]
#: groups of heads the as-built backward is also called with, besides its
#: own choice (``ssd_scan.head_groups``): one head a group (the heads not
#: grouped: every head's dCB tiles and state terms go to scratch), 8 and 16
#: heads a group, and all heads in one group
SSD_BWD_GROUPS = {"one_head_a_group": lambda nh: nh,
                  "8_heads_a_group": lambda nh: -(-nh // 8),
                  "16_heads_a_group": lambda nh: -(-nh // 16),
                  "one_group": lambda nh: 1}
#: (Bsz, S, nh, hd, ds, chunk): zamba2-2.7b's SSD call in training
SSD_BWD = (8, 512, 80, 64, 64, 256)
#: float4 loads of x and of y a saxpy thread issues before it stores
SAXPY_CFG = "constexpr int kUnroll = 2;"
SAXPY_UNROLL = [2, 1, 4, 8]
SAXPY_N = 2 * 10 ** 7
#: N-body builds: targets a thread (the source's 4 first), a 256-source
#: tile, rsqrtf in place of the flush-to-zero rsqrt.approx, and the reduction
#: pass knocked out (its output is then wrong and not checked)
NBODY_TARGETS_CFG = "constexpr int kTargets = 4;"
NBODY_TARGETS = [4, 2, 8]
NBODY_PATCHES = {
    "tile256": ("constexpr int kTile = 128;", "constexpr int kTile = 256;"),
    "rsqrtf": ('asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
               "y = rsqrtf(x);"),
    "unroll16": ("#pragma unroll 8\n    for (int s = 0;",
                 "#pragma unroll 16\n    for (int s = 0;"),
    "serial_launches": ("constexpr bool kOverlapLaunches = true;",
                        "constexpr bool kOverlapLaunches = false;"),
    "without_reduction": ("  if (err == cudaSuccess && splits > 1) {",
                          "  if (false) {"),
}
#: blocks an SM the plan aims at, on the as-built library (the module's
#: choice first); 0: one split
NBODY_BLOCKS_PER_SM = [nbody_mod.BLOCKS_PER_SM, 4, 8, 32, 0]
KINDS = ("flash", "flash_bwd", "gmm", "ssd", "ssd_bwd", "saxpy", "nbody",
         "sass")
FLASH = {"zamba2": (1, 32, 32, 1536, 80), "granite": (1, 24, 8, 1536, 64)}
GMM = {"prefill_in": (40, 384, 1536, 512), "prefill_out": (40, 384, 512, 1536),
       "ragged_c": (40, 72, 1536, 512)}


def variant(source: str, anchor, line, name: str) -> Path:
    """``source`` built alone with ``anchor`` replaced by ``line`` (or each
    of a tuple of anchors by its line), in the source or, where the source
    does not hold it, in a header the source includes."""
    text = (CSRC / source).read_text()
    headers = {h.name: h.read_text() for h in CSRC.glob("*.cuh")}
    pairs = (zip(anchor, line) if isinstance(anchor, tuple)
             else [(anchor, line)])
    for anchor, line in pairs:
        if anchor in text:
            text = text.replace(anchor, line)
            continue
        owner = [n for n, h in headers.items()
                 if anchor in h and f'#include "{n}"' in text]
        if not owner:
            raise RuntimeError(f"{source} and its headers no longer hold "
                               f"{anchor!r}")
        headers[owner[0]] = headers[owner[0]].replace(anchor, line)
    d = OUT / name
    (d / "csrc").mkdir(parents=True, exist_ok=True)
    for header, body in headers.items():
        (d / "csrc" / header).write_text(body)
    (d / "csrc" / source).write_text(text)
    return _build.build(d / "csrc", d / "build")


def ptxas(lib: Path, kernel: str, tag: str = ""):
    """(registers, spill store bytes) of each instantiation of ``kernel``
    whose mangled name holds ``tag``."""
    report = _build.ptxas_report(lib.with_suffix(".log").read_text())
    return sorted({(v["registers"], v["spill_stores"])
                   for k, v in report.items() if kernel in k and tag in k})


def kernel_times(call, calls: int = 20):
    """Device microseconds a call of each kernel ``call`` launches, by
    name, from ``torch.profiler`` over ``calls`` calls."""
    return {name[:60]: ms * 1e3
            for name, (ms, _) in cs.profiled_kernels(call, calls).items()}


def ssd_rows(libs, g):
    """The SSD scan as built and with each part knocked out, at zamba2's
    call, f32: ms (twice), and for the checked builds the worst error as a
    share of the card checks' bound."""
    Bsz, S, nh, hd, ds, chunk = SSD
    x = torch.randn((Bsz, S, nh * hd), generator=g, device="cuda") * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn((Bsz, S, nh), generator=g, device="cuda"))
    Bm = torch.randn((Bsz, S, ds), generator=g, device="cuda") * 0.5
    Cm = torch.randn((Bsz, S, ds), generator=g, device="cuda") * 0.5
    A = -torch.exp(torch.randn(nh, generator=g, device="cuda") * 0.3)
    wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=chunk)
    sy = cs.SSD_TOL * max(1.0, wy.abs().max().item())
    sh = cs.SSD_TOL * max(1.0, wh.abs().max().item())
    stream = torch.cuda.current_stream().cuda_stream
    row = {"bound_fp32_ms": cs.ssd_bound(Bsz, S, chunk, nh, hd, ds,
                                         torch.float32)[0],
           "bound_split_tf32_ms": cs.ssd_split_bound(Bsz, S, chunk, nh, hd,
                                                     ds, torch.float32)[0]}
    for name, label in [("ssd", "as built"),
                        *[(f"ssd_blocks{m}", f"built for {m} blocks an SM")
                          for m in SSD_MIN_BLOCKS[1:]],
                        *[(f"ssd_without_{n}", f"without {n}")
                          for n in SSD_KNOCKOUTS]]:
        lib = _build.load(libs[name], ("ssd_scan_fwd",))
        y = torch.empty_like(x)
        h = torch.empty((Bsz, nh, ds, hd), device="cuda")
        scratch = ssd_mod.scratch(Bsz, S, nh, hd, ds, chunk, "cuda")

        def call(lib=lib, y=y, h=h, scratch=scratch):
            return lib.ssd_scan_fwd(
                x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                A.data_ptr(), None, y.data_ptr(), h.data_ptr(),
                *(t.data_ptr() for t in scratch), 0, Bsz, S, nh, hd, ds,
                chunk, 0, stream)
        if call():
            raise RuntimeError(f"{name} did not launch")
        torch.cuda.synchronize()
        share = max((y - wy).abs().max().item() / sy,
                    (h - wh).abs().max().item() / sh)
        checked = "without" not in name
        if checked and share > 1.0:
            raise RuntimeError(f"{name}: {share:.3f} of its bound")
        row[name] = dict(ms=[cs.cuda_ms(call, REPS) for _ in range(2)],
                         share_of_bound=share if checked or name ==
                         "ssd_without_lo_products" else None,
                         ptxas=ptxas(libs[name], "ssd_"),
                         spills=spills(libs[name], "ssd_"))
        if name == "ssd":
            row[name]["kernels_us"] = kernel_times(call)
        print(f"ssd {label}: {row[name]['ms']} ms, share of bound "
              f"{row[name]['share_of_bound']}, ptxas (registers, spill "
              f"bytes) {row[name]['ptxas']}, spilling {row[name]['spills']}"
              + (f"; device us a call by kernel {row[name]['kernels_us']}"
                 if name == "ssd" else ""), flush=True)
    return row


def flash_bwd_rows(libs, g):
    """The flash backward as built and its variants at ``FLASH_BWD``, bf16
    causal: ms (twice), the worst share of ``chip_smoke.py``'s elementwise
    bound, ptxas, and the device time of each kernel a call."""
    B, H, KV, S, hd = FLASH_BWD
    q, do = (torch.randn((B, H, S, hd), generator=g, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((B, KV, S, hd), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    o, lse = flash_mod.flash_attention_with_lse(q, k, v)
    xs = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*xs), xs, do.float())
    bounds = [cs.BWD_TOL * w.abs().max() + cs.BF16_STEP * w.abs() + r
              for w, r in zip(want, (*cs.attention_bwd_rounding(q, k, o, do),
                                     0.0))]
    stream = torch.cuda.current_stream().cuda_stream
    row = {"bound_ms": cs.flash_bwd_bound(B, H, KV, S, hd,
                                          torch.bfloat16)[0]}
    for name in ["flash_bwd", *(v[0] for v in FLASH_BWD_VARIANTS)]:
        lib = _build.load(libs[name], ("flash_attention_bwd",))
        grads = [torch.empty_like(t) for t in (q, k, v)]
        D = torch.empty((B, H, S), device="cuda")

        def call(lib=lib, grads=grads, D=D):
            return lib.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), *(t.data_ptr() for t in grads),
                D.data_ptr(), 1, B, H, KV, S, S, hd, *q.stride()[:3],
                *k.stride()[:3], 1.0 / math.sqrt(hd), 0.0, 1, NO_WINDOW, 0,
                stream)
        if call():
            raise RuntimeError(f"{name} did not launch")
        torch.cuda.synchronize()
        share = max(((gr.float() - w).abs() / b).max().item()
                    for gr, w, b in zip(grads, want, bounds))
        if share > 1.0 and "without" not in name:
            raise RuntimeError(f"{name}: {share:.3f} of its bound")
        row[name] = dict(ms=[cs.cuda_ms(call, REPS) for _ in range(2)],
                         share_of_bound=share,
                         ptxas=ptxas(libs[name], "flash_bwd_", f"Li{hd}E"),
                         spills=spills(libs[name], "flash_bwd_"),
                         kernels_us=kernel_times(call))
        print(f"flash_bwd {name}: {row[name]['ms']} ms, share of bound "
              f"{share:.3f}, device us a call by kernel "
              f"{row[name]['kernels_us']}, ptxas (registers, spill bytes) "
              f"{row[name]['ptxas']}, spilling {row[name]['spills']}",
              flush=True)
    return row


def ssd_bwd_rows(libs, g):
    """The SSD backward as built, called with its own groups of heads and
    with SSD_BWD_GROUPS, and its variants at ``SSD_BWD``: ms (twice), the
    worst |err| as a share of SSD_BWD_TOL x max |plain| over the gradients,
    ptxas, and each kernel's device time."""
    Bsz, S, nh, hd, ds, chunk = SSD_BWD
    x = torch.randn((Bsz, S, nh * hd), generator=g, device="cuda") * 0.5
    dt = torch.nn.functional.softplus(
        torch.randn((Bsz, S, nh), generator=g, device="cuda"))
    Bm = torch.randn((Bsz, S, ds), generator=g, device="cuda") * 0.5
    Cm = torch.randn((Bsz, S, ds), generator=g, device="cuda") * 0.5
    A = -torch.exp(torch.randn(nh, generator=g, device="cuda") * 0.3)
    dy = torch.randn(x.shape, generator=g, device="cuda")
    main = (x, dt, Bm, Cm, A)
    want = cs.ssd_grads(ref.ssd_scan_ref, main, None, dy, None, chunk)
    _, _, states, cum = ssd_mod.ssd_scan_with_states(*main, chunk=chunk)
    stream = torch.cuda.current_stream().cuda_stream
    own = ssd_mod.head_groups(nh)
    row = {"bound_ms": cs.ssd_bwd_bound(Bsz, S, chunk, nh, hd, ds)[0],
           "bound_split_tf32_ms": cs.ssd_bwd_split_bound(Bsz, S, chunk, nh,
                                                         hd, ds)[0],
           "groups": own}
    runs = [("ssd_bwd", "ssd_bwd", own)]
    runs += [(name, "ssd_bwd", f(nh)) for name, f in SSD_BWD_GROUPS.items()]
    runs += [(v[0], v[0], own) for v in SSD_BWD_VARIANTS]
    for name, build, groups in runs:
        lib = _build.load(libs[build], ("ssd_scan_bwd",))
        grads = [torch.empty_like(t) for t in main]
        buf, parts = ssd_mod.bwd_scratch(Bsz, S, nh, hd, ds, chunk, groups,
                                         "cuda")

        def call(lib=lib, grads=grads, parts=parts, groups=groups):
            return lib.ssd_scan_bwd(
                *(t.data_ptr() for t in (*main, states, cum, dy)), None,
                *(t.data_ptr() for t in grads), None, *parts, Bsz, S, nh, hd,
                ds, chunk, groups, 0, stream)
        if call():
            raise RuntimeError(f"{name} did not launch")
        torch.cuda.synchronize()
        share = max((gr - w).abs().max().item()
                    / (cs.SSD_BWD_TOL * w.abs().max().item())
                    for gr, w in zip(grads, want))
        if share > 1.0 and "without" not in name:
            raise RuntimeError(f"{name}: {share:.3f} of its bound")
        row[name] = dict(ms=[cs.cuda_ms(call, REPS) for _ in range(2)],
                         groups=groups, share_of_bound=share,
                         scratch_mb=buf.numel() * 4 / 1e6,
                         ptxas=ptxas(libs[build], "ssd_bwd_"),
                         spills=spills(libs[build], "ssd_bwd_"),
                         kernels_us=kernel_times(call))
        print(f"ssd_bwd {name} ({groups} groups): {row[name]['ms']} ms, "
              f"share of bound {share:.3f}, scratch "
              f"{row[name]['scratch_mb']:.1f} MB, device us a call by kernel "
              f"{row[name]['kernels_us']}, ptxas (registers, spill bytes) "
              f"{row[name]['ptxas']}, spilling {row[name]['spills']}",
              flush=True)
    return row


def saxpy_rows(libs, g):
    """saxpy with each count of float4 loads a thread, beside torch.add."""
    n, a = SAXPY_N, 2.5
    x = torch.randn(n, generator=g, device="cuda")
    y = torch.randn(n, generator=g, device="cuda")
    want = torch.add(y, x, alpha=a)
    stream = torch.cuda.current_stream().cuda_stream
    row = {"torch_add_ms": []}
    for u in SAXPY_UNROLL:
        lib = _build.load(libs[f"saxpy_{u}"], ("saxpy_f32",))
        z = torch.empty_like(x)

        def call(lib=lib, z=z):
            return lib.saxpy_f32(x.data_ptr(), y.data_ptr(), z.data_ptr(), a,
                                 n, 0, stream)
        if call():
            raise RuntimeError(f"saxpy_{u} did not launch")
        torch.testing.assert_close(z, want, rtol=1e-5, atol=1e-5)
        row["torch_add_ms"].append(cs.cuda_ms(
            lambda: torch.add(y, x, alpha=a), REPS))
        row[f"saxpy_{u}"] = dict(ms=[cs.cuda_ms(call, REPS) for _ in
                                     range(2)])
        print(f"saxpy {u} float4 loads a thread: {row[f'saxpy_{u}']['ms']} "
              f"ms (torch.add {row['torch_add_ms'][-1]:.4f})", flush=True)
    return row


def sass_mix(lib: Path):
    """{kernel: {opcode: instructions}} of every kernel in the SASS of
    ``lib`` (``cuobjdump``), or None where the toolkit has no
    ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    out, counts = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            counts = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                      line)
        if m and counts is not None:
            counts[m.group(1)] += 1
    return {k: dict(v.most_common()) for k, v in out.items()}


def clocks_during(fn):
    """``fn()``, with the card's SM clock (MHz) and power draw (W) sampled
    by ``nvidia-smi`` every 50 ms while it runs: (result, median MHz,
    lowest MHz, median W)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, text=True)
    try:
        out = fn()
    finally:
        proc.terminate()
        text = proc.communicate(timeout=30)[0]
    rows = [[float(v) for v in line.split(",")]
            for line in text.splitlines() if line.strip()]
    mhz = sorted(r[0] for r in rows) or [math.nan]
    watts = sorted(r[1] for r in rows) or [math.nan]
    return out, mhz[len(mhz) // 2], mhz[0], watts[len(watts) // 2]


def nbody_rows(libs, g):
    """N-body at each slot shape: each build and plan's ms (twice), worst
    error as a share of the card checks' bound, device us a call by
    kernel; the as-built sweep's SASS mix."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    runs = [("nbody", f"plan for {b} blocks an SM" if b else "one split",
             nbody_mod.TARGETS_PER_THREAD, nbody_mod.TILE, b)
            for b in NBODY_BLOCKS_PER_SM]
    runs += [(f"nbody_targets{k}", f"{k} targets a thread", k,
              nbody_mod.TILE, nbody_mod.BLOCKS_PER_SM)
             for k in NBODY_TARGETS[1:]]
    runs += [("nbody_tile256", "tile 256", nbody_mod.TARGETS_PER_THREAD, 256,
              nbody_mod.BLOCKS_PER_SM),
             ("nbody_rsqrtf", "rsqrtf", nbody_mod.TARGETS_PER_THREAD,
              nbody_mod.TILE, nbody_mod.BLOCKS_PER_SM),
             ("nbody_unroll16", "16 sources unrolled",
              nbody_mod.TARGETS_PER_THREAD, nbody_mod.TILE,
              nbody_mod.BLOCKS_PER_SM),
             ("nbody_serial_launches", "launches in plain stream order",
              nbody_mod.TARGETS_PER_THREAD, nbody_mod.TILE,
              nbody_mod.BLOCKS_PER_SM),
             ("nbody_without_reduction", "without the reduction pass",
              nbody_mod.TARGETS_PER_THREAD, nbody_mod.TILE,
              nbody_mod.BLOCKS_PER_SM)]
    out = {"sass_nbody_tiles": {
        name: {k: v for k, v in (sass_mix(libs[name]) or {}).items()
               if "nbody_tiles" in k} for name in ("nbody", "nbody_rsqrtf")}}
    print(f"nbody sweep SASS mix: {out['sass_nbody_tiles']}", flush=True)
    for n_i, n_j in cs.NBODY_SLOTS:
        pos = torch.randn((n_j, 3), generator=g, device="cuda")
        mass = torch.rand(n_j, generator=g, device="cuda") + 0.1
        tgt = pos[:n_i]
        want = ref.nbody_ref(pos.double(), mass.double(),
                             targets=tgt.double())
        scale = cs.NBODY_TOL * want.abs().max().item()
        row = {"bound_ms": cs.bound_ms(24.0 * n_i + 16.0 * n_j,
                                       20.0 * n_i * n_j)[0]}
        for name, label, k, tile, bps in runs:
            if bps:
                plan = nbody_mod.launch_plan(
                    n_i, n_j, sms, targets_per_block=nbody_mod.THREADS * k,
                    tile=tile, blocks_per_sm=bps)
                splits, split_len = plan.splits, plan.split_len
            else:
                splits, split_len = 1, -(-n_j // tile) * tile
            lib = _build.load(libs[name], ("nbody_acc_f32",))
            acc = torch.empty_like(tgt)
            scratch = torch.empty(
                (nbody_mod.scratch_rows(n_i, n_j, splits, tile), 4),
                device="cuda")

            def call(lib=lib, acc=acc, scratch=scratch, splits=splits,
                     split_len=split_len):
                return lib.nbody_acc_f32(
                    tgt.data_ptr(), n_i, pos.data_ptr(), mass.data_ptr(), n_j,
                    acc.data_ptr(), nbody_mod.SOFTENING, scratch.data_ptr(),
                    splits, split_len, 0, stream)
            if call():
                raise RuntimeError(f"{name} did not launch")
            torch.cuda.synchronize()
            checked = "without" not in name
            share = (acc.double() - want).abs().max().item() / scale
            if checked and share > 1.0:
                raise RuntimeError(f"{name} {n_i}x{n_j}: {share:.3f} of its "
                                   "bound")
            key = f"{name}:{label}"
            if name == "nbody" and bps == nbody_mod.BLOCKS_PER_SM:
                # a second of back-to-back calls, with the clock beside it
                ms, mhz, low, watts = clocks_during(
                    lambda: cs.cuda_ms(call, max(REPS, int(1.0 / (
                        cs.cuda_ms(call, REPS) * 1e-3)))))
                row["sustained"] = dict(ms=ms, sm_mhz_median=mhz,
                                        sm_mhz_lowest=low,
                                        watts_median=watts)
                print(f"nbody {n_i}x{n_j} as built, sustained: "
                      f"{row['sustained']}", flush=True)
            row[key] = dict(ms=[cs.cuda_ms(call, REPS) for _ in range(2)],
                            splits=splits, blocks=-(-n_i // (
                                nbody_mod.THREADS * k)) * splits,
                            share_of_bound=share if checked else None,
                            kernels_us=kernel_times(call),
                            ptxas=ptxas(libs[name], "nbody_"),
                            spills=spills(libs[name], "nbody_"))
            print(f"nbody {n_i}x{n_j} {label}: {row[key]['ms']} ms, "
                  f"{splits} splits, {row[key]['blocks']} blocks, share of "
                  f"bound {row[key]['share_of_bound']}, device us by kernel "
                  f"{row[key]['kernels_us']}, ptxas (registers, spill "
                  f"bytes) {row[key]['ptxas']}", flush=True)
        out[f"{n_i}x{n_j}"] = row
    return out


def gmm_bwd_rows(libs, g, stream):
    """dx and dw of each GMM_BWD_VARIANTS build at GMM_BWD's shapes, each
    held to its plain version under GMM_TOL and timed (CUDA events, twice;
    device time from ``torch.profiler``) beside ``torch.bmm``."""
    out = {}
    for shape_name, (E, C, d, f) in GMM_BWD.items():
        x = torch.randn((E, C, d), generator=g, device="cuda").bfloat16()
        w = (torch.randn((E, d, f), generator=g, device="cuda")
             * d ** -0.5).bfloat16()
        dy = torch.randn((E, C, f), generator=g, device="cuda").bfloat16()
        prods = {
            "dx": (dy, w, torch.empty_like(x), ref.grouped_matmul_dx_ref(
                dy, w), lambda: torch.bmm(dy, w.transpose(1, 2)),
                cs.gmm_bound(E, C, f, d, torch.bfloat16)[0]),
            "dw": (x, dy, torch.empty_like(w), ref.grouped_matmul_dw_ref(
                x, dy), lambda: torch.bmm(x.transpose(1, 2), dy),
                cs.gmm_bound(E, d, C, f, torch.bfloat16)[0])}
        row = {p: {"bmm_ms": cs.cuda_ms(v[4], REPS), "bound_ms": v[5]}
               for p, v in prods.items()}
        for bm, bn, st, mb in GMM_BWD_VARIANTS:
            name = f"gmm_bwd_{bm}_{bn}_{st}_{mb}"
            lib = _build.load(libs[name], ("grouped_matmul_dx",
                                           "grouped_matmul_dw"))
            for prod, (a, b, o, want, _, bound) in prods.items():
                entry = getattr(lib, f"grouped_matmul_{prod}")

                def call(entry=entry, a=a, b=b, o=o):
                    return entry(a.data_ptr(), b.data_ptr(), o.data_ptr(),
                                 E, C, d, f, 0, stream)
                if call():
                    raise RuntimeError(f"{name} {prod} did not launch")
                scale = want.float().abs().max().item()
                ex = cs.bf16_excess(o, want, cs.GMM_TOL * scale)
                if ex > 1.0:
                    raise RuntimeError(f"{name} {shape_name} {prod}: "
                                       f"{ex:.3f} of bound")
                ms = [cs.cuda_ms(call, REPS) for _ in range(2)]
                dev = cs.device_ms(call)[0]
                row[prod][name] = dict(ms=ms, device_ms=dev,
                                       share_of_bound=bound / min(ms),
                                       worst_share_of_tolerance=ex)
                print(f"gmm_bwd {shape_name} {prod} tile {bm}x{bn} stages "
                      f"{st} blocks/SM {mb}: {ms} ms (device "
                      f"{dev:.4f}), "
                      f"{bound / min(ms):.3f} of the bound (bmm "
                      f"{row[prod]['bmm_ms']:.4f})", flush=True)
            row[name] = dict(ptxas=ptxas(libs[name], "gmm_bwd_kernel"),
                             spills=spills(libs[name], "gmm_bwd_kernel"))
            print(f"gmm_bwd {name} ptxas (registers, spill bytes) "
                  f"{row[name]['ptxas']}", flush=True)
        out[shape_name] = row
    return out


def spills(lib: Path, kernel: str):
    """The instantiations of ``kernel`` that spill: {name: (registers,
    spill store bytes)}."""
    report = _build.ptxas_report(lib.with_suffix(".log").read_text())
    return {k[-48:]: (v["registers"], v["spill_stores"])
            for k, v in report.items() if kernel in k and v["spill_stores"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kernel_shapes: no CUDA device", file=sys.stderr)
        return 2
    kinds = sys.argv[1:] or list(KINDS)
    if set(kinds) - set(KINDS):
        print(f"known: {list(KINDS)}", file=sys.stderr)
        return 2
    card = cs.gpu_line()
    print(card, flush=True)
    jobs = []
    if "flash" in kinds:
        jobs += [("flash_attention.cu", FLASH_CFG,
                  f"using Cfg = Shape<HD, (HD > 128 ? 16 : {bk}), (HD <= 80 "
                  f"? {st} : 2), (HD <= 80 ? {mb} : 1)>;",
                  f"flash_{bk}_{st}_{mb}")
                 for bk, st, mb in FLASH_VARIANTS]
        jobs += [("flash_attention.cu", *patch, f"flash_without_{name}")
                 for name, patch in FLASH_KNOCKOUTS.items()]
    if "flash_bwd" in kinds:
        as_built = FLASH_BWD_VARIANTS[0][1]
        jobs += [("flash_attention_bwd.cu", as_built, as_built, "flash_bwd")]
        jobs += [("flash_attention_bwd.cu", anchor, line, name)
                 for name, anchor, line in FLASH_BWD_VARIANTS]
    if "gmm" in kinds:
        jobs += [("moe_gemm.cu", GMM_CFG,
                  f"using Prefill = Cfg<{bm}, {bn}, {st}, {mb}>;",
                  f"gmm_{bm}_{bn}_{st}_{mb}")
                 for bm, bn, st, mb in GMM_VARIANTS]
        jobs += [("moe_gemm.cu", GMM_BWD_CFG,
                  (f"using Dx = Cfg<{bm}, {bn}, {st}, {mb}>;",
                   f"using Dw = Cfg<{bm}, {bn}, {st}, {mb}>;"),
                  f"gmm_bwd_{bm}_{bn}_{st}_{mb}")
                 for bm, bn, st, mb in GMM_BWD_VARIANTS]
    if "ssd" in kinds:
        jobs += [("ssd_scan.cu", SSD_CFG, f"  return NC <= 64 ? {m} : 2;",
                  "ssd" if m == SSD_MIN_BLOCKS[0] else f"ssd_blocks{m}")
                 for m in SSD_MIN_BLOCKS]
        jobs += [("ssd_scan.cu", *patch, f"ssd_without_{name}")
                 for name, patch in SSD_KNOCKOUTS.items()]
    if "ssd_bwd" in kinds:
        as_built = SSD_BWD_VARIANTS[-1][1]
        jobs += [("ssd_scan_bwd.cu", as_built, as_built, "ssd_bwd")]
        jobs += [("ssd_scan_bwd.cu", anchor, line, name)
                 for name, anchor, line in SSD_BWD_VARIANTS]
    if "saxpy" in kinds:
        jobs += [("saxpy.cu", SAXPY_CFG, f"constexpr int kUnroll = {u};",
                  f"saxpy_{u}") for u in SAXPY_UNROLL]
    if "nbody" in kinds:
        jobs += [("nbody.cu", NBODY_TARGETS_CFG,
                  f"constexpr int kTargets = {k};",
                  "nbody" if k == NBODY_TARGETS[0] else f"nbody_targets{k}")
                 for k in NBODY_TARGETS]
        jobs += [("nbody.cu", *patch, f"nbody_{name}")
                 for name, patch in NBODY_PATCHES.items()]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        libs = dict(zip((j[3] for j in jobs),
                        pool.map(lambda j: variant(*j), jobs)))
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card, "flash": {}, "gmm": {}}
    if "flash_bwd" in kinds:
        out["flash_bwd"] = flash_bwd_rows(libs, g)
    if "ssd" in kinds:
        out["ssd"] = ssd_rows(libs, g)
    if "ssd_bwd" in kinds:
        out["ssd_bwd"] = ssd_bwd_rows(libs, g)
    if "saxpy" in kinds:
        out["saxpy"] = saxpy_rows(libs, g)
    if "nbody" in kinds:
        out["nbody"] = nbody_rows(libs, g)
    if "sass" in kinds:
        out["sass"] = sass_mix(_build.build())
        for k, v in (out["sass"] or {}).items():
            print(f"sass {k}: {sum(v.values())} instructions, {v}",
                  flush=True)

    for shape_name, (B, H, KV, S, hd) in (FLASH.items() if "flash" in kinds
                                          else ()):
        q = torch.randn((B, H, S, hd), generator=g, device="cuda").bfloat16()
        k = torch.randn((B, KV, S, hd), generator=g, device="cuda").bfloat16()
        v = torch.randn((B, KV, S, hd), generator=g, device="cuda").bfloat16()
        want = ref.attention_ref(q, k, v)
        strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   *q.stride()[:3]]
        row = {"sdpa_ms": cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=KV != H), REPS)}
        runs = [(f"flash_{bk}_{st}_{mb}",
                 f"keys/tile {bk} stages {st} blocks/SM {mb}", True)
                for bk, st, mb in FLASH_VARIANTS]
        runs += [(f"flash_without_{n}", f"without {n}", False)
                 for n in FLASH_KNOCKOUTS]
        for name, label, checked in runs:
            lib = _build.load(libs[name], ("flash_attention_fwd",))
            o = torch.empty_like(q)

            def call(lib=lib, o=o):
                return lib.flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    1, B, H, KV, S, S, hd, *strides, 1.0 / math.sqrt(hd),
                    0.0, 1, NO_WINDOW, S, 0, stream)
            if call():
                raise RuntimeError(f"{name} did not launch")
            ex = cs.bf16_excess(o, want, cs.FLASH_TOL) if checked else None
            if checked and ex > 1.0:
                raise RuntimeError(f"{name} {shape_name}: {ex:.3f} of bound")
            row[name] = dict(ms=[cs.cuda_ms(call, REPS) for _ in range(2)],
                             share_of_bound=ex,
                             ptxas=ptxas(libs[name], "flash_mma_kernel",
                                         f"ShapeILi{hd}E"))
            print(f"flash {shape_name} {label}: {row[name]['ms']} ms "
                  f"(SDPA {row['sdpa_ms']:.4f}), "
                  f"ptxas (registers, spill bytes) {row[name]['ptxas']}",
                  flush=True)
        out["flash"][shape_name] = row

    for shape_name, (E, C, d, f) in GMM.items() if "gmm" in kinds else ():
        x = torch.randn((E, C, d), generator=g, device="cuda").bfloat16()
        w = (torch.randn((E, d, f), generator=g, device="cuda")
             * d ** -0.5).bfloat16()
        want = ref.grouped_matmul_ref(x, w)
        scale = want.float().abs().max().item()
        row = {"bmm_ms": cs.cuda_ms(lambda: torch.bmm(x, w), REPS)}
        for bm, bn, st, mb in GMM_VARIANTS:
            name = f"gmm_{bm}_{bn}_{st}_{mb}"
            lib = _build.load(libs[name], ("grouped_matmul_fwd",))
            y = torch.empty((E, C, f), dtype=torch.bfloat16, device="cuda")

            def call(lib=lib, y=y):
                return lib.grouped_matmul_fwd(
                    x.data_ptr(), w.data_ptr(), y.data_ptr(), 1, E, C, d, f,
                    0, stream)
            if call():
                raise RuntimeError(f"{name} did not launch")
            ex = cs.bf16_excess(y, want, cs.GMM_TOL * scale)
            if ex > 1.0:
                raise RuntimeError(f"{name} {shape_name}: {ex:.3f} of bound")
            row[name] = dict(ms=[cs.cuda_ms(call, REPS) for _ in range(2)],
                             share_of_bound=ex,
                             ptxas=ptxas(libs[name], "gmm_wgmma_kernel"))
            print(f"gmm {shape_name} tile {bm}x{bn} stages {st} blocks/SM "
                  f"{mb}: {row[name]['ms']} ms (bmm {row['bmm_ms']:.4f}), "
                  f"ptxas (registers, spill bytes) {row[name]['ptxas']}",
                  flush=True)
        out["gmm"][shape_name] = row
    if "gmm" in kinds:
        out["gmm_bwd"] = gmm_bwd_rows(libs, g, stream)

    (cs.ROOT / "build").mkdir(exist_ok=True)
    (cs.ROOT / "build" / "kernel_shapes.json").write_text(json.dumps(out,
                                                                    indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
