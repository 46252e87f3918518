#!/usr/bin/env python3
"""Two builds of the port's kernels, timed in turns on one CUDA card.

    python3 chip_kernel_turns.py OLD_ROOT

``OLD_ROOT`` is the root of another checkout of the repository (for
example the parent commit, unpacked with ``git archive`` into a directory
that ``.gitignore`` lists).  Its ``src/repro_torch/csrc`` is built with the
same ``nvcc`` flags into ``OLD_ROOT/build/kernels``, this checkout's into
``build/kernels``.  Flash attention and the grouped GEMM then run through
each library's C entry points on the same bf16 inputs, at the main paths'
shapes (zamba2-2.7b's and granite-moe-3b-a800m's 1536-token prefills, and
granite's grouped GEMMs at a 1536-token prefill and a decode step), in the
order old, new, library call, new, old: CUDA-event means over ``REPS``
launches after a warm-up.  The library call (``scaled_dot_product_attention``
or ``torch.bmm``) is a yardstick only.  Each build's output is held to the
plain version (one bf16 step plus the ``chip_smoke.py`` tolerance).  The
host time of one C call is timed too (the TMA kernel encodes its two tensor
maps at every call).

Prints the card's name and power limit, then one JSON object, which is also
written to ``build/kernel_turns.json``.  Exits non-zero without a card.
"""
from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke as cs
from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import NO_WINDOW

REPS = 50
HOST_CALLS = 200
#: (B, H, KV, S, hd) causal, bf16
FLASH = {"zamba2": (1, 32, 32, 1536, 80), "granite": (1, 24, 8, 1536, 64)}
#: (E, C, d, f), bf16
GMM = {"prefill_in": (40, 384, 1536, 512), "prefill_out": (40, 384, 512, 1536),
       "decode": (40, 8, 1536, 512)}


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call (enqueue only), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def checked(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"CUDA error {rc} launching {what}")


def flash_case(libs, B, H, KV, S, hd):
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, H, S, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, KV, S, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, KV, S, hd), generator=g, device="cuda").bfloat16()
    want = ref.attention_ref(q, k, v)
    stream = torch.cuda.current_stream().cuda_stream
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *q.stride()[:3]]
    calls, errs = {}, {}
    for name, lib in libs.items():
        o = torch.empty_like(q)

        def call(lib=lib, o=o, name=name):
            checked(lib.flash_attention_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                B, H, KV, S, S, hd, *strides, 1.0 / math.sqrt(hd), 0.0, 1,
                NO_WINDOW, S, 0, stream), f"flash ({name})")
        call()
        torch.cuda.synchronize()
        calls[name], errs[name] = call, cs.bf16_excess(o, want, cs.FLASH_TOL)
    bound = cs.flash_bound(B, H, KV, S, S, hd, torch.bfloat16)[0]
    lib_call = (lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=KV != H))
    return calls, errs, lib_call, bound


def gmm_case(libs, E, C, d, f):
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((E, C, d), generator=g, device="cuda").bfloat16()
    w = (torch.randn((E, d, f), generator=g, device="cuda")
         * d ** -0.5).bfloat16()
    want = ref.grouped_matmul_ref(x, w)
    scale = want.float().abs().max().item()
    stream = torch.cuda.current_stream().cuda_stream
    calls, errs = {}, {}
    for name, lib in libs.items():
        y = torch.empty((E, C, f), dtype=torch.bfloat16, device="cuda")

        def call(lib=lib, y=y, name=name):
            checked(lib.grouped_matmul_fwd(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), 1, E, C, d, f, 0,
                stream), f"grouped_matmul ({name})")
        call()
        torch.cuda.synchronize()
        calls[name], errs[name] = call, cs.bf16_excess(y, want,
                                                          cs.GMM_TOL * scale)
    nbytes = 2 * (E * C * d + E * d * f + E * C * f)
    bound = cs.gmm_bound(E, C, d, f, torch.bfloat16)[0]
    return calls, errs, (lambda: torch.bmm(x, w)), bound, nbytes


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    old_root = Path(sys.argv[1]).resolve()
    card = cs.gpu_line()
    print(card, flush=True)
    names = ("flash_attention_fwd", "grouped_matmul_fwd")
    libs = {"old": _build.load(_build.build(
                old_root / "src" / "repro_torch" / "csrc",
                old_root / "build" / "kernels"), names),
            "new": _build.load(_build.build(), names)}
    out = {"card": card, "torch": torch.__version__, "reps": REPS,
           "order": "old, new, library, new, old", "flash": {}, "gmm": {}}
    cases = [("flash", n, flash_case(libs, *shape), shape)
             for n, shape in FLASH.items()]
    cases += [("gmm", n, gmm_case(libs, *shape), shape)
              for n, shape in GMM.items()]
    for kind, name, case, shape in cases:
        calls, errs, lib_call, bound = case[:4]
        for n, e in errs.items():
            if e > 1.0:
                raise RuntimeError(f"{kind} {name} ({n}): worst element at "
                                   f"{e:.3f} of its bound")
        t = [cs.cuda_ms(c, REPS) for c in (calls["old"], calls["new"],
                                           lib_call, calls["new"],
                                           calls["old"])]
        r = dict(shape=list(shape), old_ms=[t[0], t[4]], new_ms=[t[1], t[3]],
                 library_ms=t[2], bound_ms=bound,
                 worst_share_of_bound=errs,
                 host_us={n: host_us(c) for n, c in calls.items()})
        if kind == "gmm":
            r["new_tb_per_s"] = case[4] / (min(t[1], t[3]) * 1e-3) / 1e12
        out[kind][name] = r
        print(f"{kind} {name} {list(shape)}: old {t[0]:.4f}/{t[4]:.4f} ms, "
              f"new {t[1]:.4f}/{t[3]:.4f} ms, library {t[2]:.4f} ms, bound "
              f"{bound:.4f} ms; host {r['host_us']} us a call", flush=True)
    (cs.ROOT / "build").mkdir(exist_ok=True)
    (cs.ROOT / "build" / "kernel_turns.json").write_text(json.dumps(out,
                                                                   indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
