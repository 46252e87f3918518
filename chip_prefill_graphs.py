#!/usr/bin/env python3
"""The engine's prefill graphs and serving memory on one CUDA card.

    python3 chip_prefill_graphs.py [--main-paths-only] [ROOT]

Imports ``chip_smoke`` and ``repro_torch`` from the checkout at ROOT
(default: this file's directory), so that an older checkout unpacked
under ``build/`` can be measured in the same call.  For zamba2,
granite, mamba2, minicpm and gemma2, each at full width and depth with
``chip_smoke.py``'s recipe: the served main path (``lm_main_path``: 8
requests for zamba2 and granite, 4 for the others), a ``PEAK <arch>``
line with its peak memory in bytes, and unless ``--main-paths-only`` the
prefill graph phase (``prefill_graph_phase``: its ``lm prefill graph``
line).  Prints the card's name and power limit first and ``PROBE OK``
last.  Exits non-zero without a card.
"""
from __future__ import annotations

import gc
import os
import sys
from pathlib import Path

ARCHS = ("zamba2-2.7b", "granite-moe-3b-a800m", "mamba2-1.3b",
         "minicpm-2b", "gemma2-2b")


def main(argv) -> int:
    graphs = "--main-paths-only" not in argv
    roots = [a for a in argv if not a.startswith("--")]
    root = Path(roots[0] if roots else Path(__file__).parent).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("chip_prefill_graphs: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    cs._build.library()
    for arch in ARCHS:
        cfg = cs.get_config(arch)
        model = cs.build_model(cfg)
        args = (() if arch in cs.LM_ARCHS
                else (cs.FAMILY_REQUESTS, cs.FAMILY_MAX_NEW))
        serve = cs.lm_main_path(cfg, model, *args)
        print(f"PEAK {arch} {serve['peak_memory_bytes']}", flush=True)
        if graphs:
            cs.prefill_graph_phase(cfg, model)
        del model, serve
        gc.collect()
        torch.cuda.empty_cache()
    print("PROBE OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
