#!/usr/bin/env python3
"""Readings behind the limits of ``chip_smoke.py``'s bf16 one-group check.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_group_calibration.py

It builds zamba2-2.7b at full width from seed 0 as ``chip_smoke.py`` does,
keeps the first hybrid group (5 Mamba2 + 1 attention layers, full-width
embedding), and prefills three 512-token prompts (seeds 1, 3, 5) through
it.  Against the CPU float32 run it prints the relative L2 difference,
||run - CPU f32|| / ||CPU f32||, of the last-token logits and the SSM state
for sound runs (card f32, card bf16, CPU bf16) and for card bf16 runs with
a deliberate fault put into one kernel call of the model:

- ``flash_noncausal``: the causal mask dropped;
- ``flash_misplaced_tile``: keys and values 64-127 replaced by 0-63;
- ``flash_scale_1_over_hd``: softmax scale 1/hd for 1/sqrt(hd);
- ``ssd_no_carry``: the state not carried from one chunk to the next;
- ``ssd_B_C_swapped``: B and C passed in each other's place;
- ``ssd_dt_shift``: dt one position late.

``chip_smoke.GROUP_BF16_REL`` is set between the largest sound reading and
the smallest reading of a fault it can see.  The full record goes to
``build/chip_group_calibration.json``.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from repro_torch.kernels import _build, ops

SEEDS = (1, 3, 5)


def flash_noncausal(flash, q, k, v, **kw):
    return flash(q, k, v, **dict(kw, causal=False))


def flash_misplaced_tile(flash, q, k, v, **kw):
    k, v = k.clone(), v.clone()          # (B, S, KV, hd)
    k[:, 64:128] = k[:, 0:64]
    v[:, 64:128] = v[:, 0:64]
    return flash(q, k, v, **kw)


def flash_scale_1_over_hd(flash, q, k, v, **kw):
    return flash(q, k, v, **dict(kw, scale=1.0 / q.shape[-1]))


def ssd_no_carry(ssd, x, dt, B, C, A, *, chunk, h0=None):
    ys, h = [], None
    for s in range(0, x.shape[1], chunk):
        part = slice(s, s + chunk)
        y, h = ssd(x[:, part], dt[:, part], B[:, part], C[:, part], A,
                   chunk=chunk, h0=h0 if s == 0 else None)
        ys.append(y)
    return torch.cat(ys, 1), h


def ssd_B_C_swapped(ssd, x, dt, B, C, A, *, chunk, h0=None):
    return ssd(x, dt, C, B, A, chunk=chunk, h0=h0)


def ssd_dt_shift(ssd, x, dt, B, C, A, *, chunk, h0=None):
    return ssd(x, torch.roll(dt, 1, dims=1), B, C, A, chunk=chunk, h0=h0)


FAULTS = {f.__name__: ("flash_attention_bshd" if f.__name__.startswith(
    "flash") else "ssd_scan", f) for f in (
        flash_noncausal, flash_misplaced_tile, flash_scale_1_over_hd,
        ssd_no_carry, ssd_B_C_swapped, ssd_dt_shift)}


def faulty(one, state, tokens, attr, fault):
    """A card bf16 prefill with ``ops.<attr>`` wrapped by ``fault``."""
    good = getattr(ops, attr)
    setattr(ops, attr, lambda *a, **kw: fault(good, *a, **kw))
    try:
        return cs.group_prefill(one, state, tokens, torch.bfloat16, "cuda")
    finally:
        setattr(ops, attr, good)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_group_calibration: no CUDA device", file=sys.stderr)
        return 2
    print(cs.gpu_line(), flush=True)
    _build.library()
    cfg = cs.get_config(cs.LM_ARCH)
    model = cs.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    one, state = cs.one_group(cfg, model)
    del model
    torch.cuda.empty_cache()
    torch.set_num_threads(os.cpu_count() or 1)
    f32, bf16 = torch.float32, torch.bfloat16
    record = {}
    for seed in SEEDS:
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (1, cs.LM_CHECK_TOKENS)))
        t0 = time.perf_counter()
        want = cs.group_prefill(one, state, tokens, f32, "cpu")
        runs = {"card_f32": cs.group_prefill(one, state, tokens, f32, "cuda"),
                "card_bf16": cs.group_prefill(one, state, tokens, bf16,
                                              "cuda"),
                "cpu_bf16": cs.group_prefill(one, state, tokens, bf16, "cpu")}
        for name, (attr, fault) in FAULTS.items():
            runs[name] = faulty(one, state, tokens, attr, fault)
        row = {name: {k: cs.rel_l2(r[k], want[k]) for k in ("logits", "h")}
               for name, r in runs.items()}
        record[seed] = row
        print(f"seed {seed} ({time.perf_counter() - t0:.1f} s), relative L2 "
              "against CPU f32:", flush=True)
        for name, r in row.items():
            print(f"  {name}: logits {r['logits']:.4g}, h {r['h']:.4g}",
                  flush=True)
    out = cs.ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_group_calibration.json").write_text(json.dumps(record,
                                                                indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
