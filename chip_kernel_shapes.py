#!/usr/bin/env python3
"""Tile shapes of the bf16 flash attention and grouped GEMM kernels, timed
on one CUDA card.

    python3 chip_kernel_shapes.py

Rebuilds ``csrc/flash_attention.cu`` and ``csrc/moe_gemm.cu`` with other
tile shapes in place of the ones the sources choose (the ``Cfg`` alias of
the bf16 flash kernel: keys a tile, cp.async stages, blocks an SM; the
``Prefill`` alias of the grouped GEMM: tile rows and columns, TMA stages,
blocks an SM), each variant into its own library under ``build/shapes/``,
all built at once.  Each is timed at the main paths' shapes (CUDA-event
means over 50 launches after a warm-up, twice) with its output held to the
plain version (one bf16 step plus the ``chip_smoke.py`` tolerance), the
library call timed beside as a yardstick.  The sources' own choice is the
first variant of each list.  Two more builds of the flash kernel each
knock one part out (the K/V loads, the lo half of P's product) to show
what it costs; their output is not checked.  Prints the card, one line a variant and the
registers and spills ``ptxas`` reports, and writes
``build/kernel_shapes.json``.  Exits non-zero without a card.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke as cs
from repro_torch.kernels import _build, ref
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
#: (tile rows, tile columns, stages, blocks an SM) of the grouped GEMM at
#: C > 64
GMM_CFG = "using Prefill = Cfg<128, 128, 3, 2>;"
GMM_VARIANTS = [(128, 128, 3, 2), (128, 128, 4, 1), (128, 256, 4, 1),
                (128, 256, 3, 1), (128, 64, 4, 2)]
FLASH = {"zamba2": (1, 32, 32, 1536, 80), "granite": (1, 24, 8, 1536, 64)}
GMM = {"prefill_in": (40, 384, 1536, 512), "prefill_out": (40, 384, 512, 1536),
       "ragged_c": (40, 72, 1536, 512)}


def variant(source: str, anchor: str, line: str, name: str) -> Path:
    text = (CSRC / source).read_text()
    if anchor not in text:
        raise RuntimeError(f"{source} no longer holds {anchor!r}")
    d = OUT / name
    (d / "csrc").mkdir(parents=True, exist_ok=True)
    (d / "csrc" / source).write_text(text.replace(anchor, line))
    return _build.build(d / "csrc", d / "build")


def ptxas(lib: Path, kernel: str, tag: str = ""):
    """(registers, spill store bytes) of each instantiation of ``kernel``
    whose mangled name holds ``tag``."""
    report = _build.ptxas_report(lib.with_suffix(".log").read_text())
    return sorted({(v["registers"], v["spill_stores"])
                   for k, v in report.items() if kernel in k and tag in k})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kernel_shapes: no CUDA device", file=sys.stderr)
        return 2
    card = cs.gpu_line()
    print(card, flush=True)
    jobs = [("flash_attention.cu", FLASH_CFG,
             f"using Cfg = Shape<HD, (HD > 128 ? 16 : {bk}), (HD <= 80 ? "
             f"{st} : 2), (HD <= 80 ? {mb} : 1)>;", f"flash_{bk}_{st}_{mb}")
            for bk, st, mb in FLASH_VARIANTS]
    jobs += [("flash_attention.cu", *patch, f"flash_without_{name}")
             for name, patch in FLASH_KNOCKOUTS.items()]
    jobs += [("moe_gemm.cu", GMM_CFG,
              f"using Prefill = Cfg<{bm}, {bn}, {st}, {mb}>;",
              f"gmm_{bm}_{bn}_{st}_{mb}")
             for bm, bn, st, mb in GMM_VARIANTS]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        libs = dict(zip((j[3] for j in jobs),
                        pool.map(lambda j: variant(*j), jobs)))
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": card, "flash": {}, "gmm": {}}

    for shape_name, (B, H, KV, S, hd) in FLASH.items():
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

    for shape_name, (E, C, d, f) in GMM.items():
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

    (cs.ROOT / "build").mkdir(exist_ok=True)
    (cs.ROOT / "build" / "kernel_shapes.json").write_text(json.dumps(out,
                                                                    indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
