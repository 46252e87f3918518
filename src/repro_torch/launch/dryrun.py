"""Single-H100 dry-run: every (arch × shape) cell traced on the ``meta``
device.

The port's counterpart of the JAX package's ``launch/dryrun.py``, for one
card (``single_h100``, chips 1).  The reference lowers and compiles each
cell's step against ``ShapeDtypeStruct``\\ s on the CPU; here the step
runs eagerly on ``meta`` tensors under
:class:`~repro_torch.launch.op_analysis.OpAnalysis`, which allocates
nothing, so the analysis needs no card.  Each cell:

  * train   — ``make_train_step`` with the cell's ``RuntimeConfig``
              (microbatches, remat, remat group and inner policy, loss
              chunks), bf16 parameters and float32 AdamW moments, on the
              shape's tokens and labels.  The whole step is traced, every
              microbatch of it, so the counts are the step's and the peak
              is the whole step's;
  * prefill — ``prefill(..., capacity=seq_len)``;
  * decode  — one ``decode_step`` over a cache of ``cache_defs`` at
              seq_len (KV dtype from the cell), at the last position,
              seq_len - 1.

The three LM kernels run as their meta stand-ins
(:mod:`repro_torch.kernels.meta`), each call counted by its work formula;
no plain version runs.  The record holds the memory block (the peak of
live bytes against ``HBM_PER_CARD``), the op analysis with the kernel
calls, the roofline and the seconds the trace took.

Artifacts: one JSON per cell under ``build/dryrun_torch/single_h100/``
(``<arch>--<shape>[--<tag>].json``; a ``.fail`` file with the traceback
where a cell raised), read by :mod:`repro_torch.bench.roofline` and
:mod:`repro_torch.bench.report`.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun                   # all 40 cells
    python -m repro_torch.launch.dryrun --set microbatches=8 --tag mb8
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import (SHAPES, applicable, arch_names, get_config,
                                 input_specs)
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.cells import CellConfig, cell_runtime
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.launch.roofline import HBM_PER_CARD, roofline
from repro_torch.models import LM, ModelConfig
from repro_torch.models.lm import cache_defs, cache_dtype
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import (RuntimeConfig, init_state, make_decode_step,
                                 make_prefill_step, make_train_step)

#: the one mesh of the port: --mesh name -> artifact folder; one card
MESHES = {"single": "single_h100"}
CHIPS = 1
OUT = "build/dryrun_torch"


# ---------------------------------------------------------------------------
# Cell assembly: (step fn, its arguments)
# ---------------------------------------------------------------------------

def build_cell(cfg: ModelConfig, shape: ShapeSpec, cell: CellConfig
               ) -> Tuple[Callable, tuple]:
    """The cell's step and its arguments, all on ``meta``: ``fn(*args)``
    runs one step."""
    model = LM(cfg, device="meta")                       # bf16
    data = input_specs(cfg, shape)
    if shape.kind == "train":
        # the reference's clamp, with one data-parallel rank: each
        # microbatch takes a whole share of the batch
        mb = max(1, min(cell.microbatches, shape.global_batch))
        while shape.global_batch % mb:
            mb -= 1
        rt = RuntimeConfig(microbatches=mb, remat=cell.remat,
                           remat_group=cell.remat_group,
                           remat_inner=cell.remat_inner,
                           loss_chunks=cell.loss_chunks)
        opt = AdamW(AdamWConfig())
        state = init_state(model, opt)                   # f32 moments
        return make_train_step(cfg, opt, rt), (state, dict(data))

    if shape.kind == "prefill":
        step = make_prefill_step(cfg, capacity=shape.seq_len)
        extras = {k: v for k, v in data.items() if k != "tokens"}
        return (lambda m, tokens, kw: step(m, tokens, **kw),
                (model, data["tokens"], extras))

    # decode
    kv_dtype = (torch.float8_e4m3fn if cell.cache_dtype == "f8"
                else torch.bfloat16)

    def _cdtype(key):
        if key.startswith(("k", "v", "xk", "xv")):
            return kv_dtype
        return cache_dtype(key)

    cache = {k: torch.empty(shp, dtype=_cdtype(k), device="meta")
             for k, shp in cache_defs(cfg, shape.global_batch,
                                      shape.seq_len).items()}
    step = make_decode_step(cfg)
    pos = shape.seq_len - 1
    return (lambda m, c, token: step(m, c, token, pos),
            (model, cache, data["token"]))


# ---------------------------------------------------------------------------
# One cell: trace, analyse
# ---------------------------------------------------------------------------

def trace_cell(cfg: ModelConfig, shape: ShapeSpec, cell: CellConfig
               ) -> Dict[str, Any]:
    """Build the cell, trace one step under ``OpAnalysis``; the record's
    memory, op analysis, roofline and seconds (its arch/shape/mesh fields
    are the caller's)."""
    t0 = time.time()
    fn, args = build_cell(cfg, shape, cell)
    with OpAnalysis() as oa:
        oa.track(*args)
        out = fn(*args)
    del out, fn, args
    trace_s = time.time() - t0
    ana = oa.analysis
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    rf = roofline(per_chip_flops=ana.flops, per_chip_hbm_bytes=ana.hbm_bytes,
                  per_chip_collective_bytes=0.0, chips=CHIPS,
                  active_params=cfg.active_param_count(), tokens=tokens,
                  kind=shape.kind)
    return {
        "chips": CHIPS, "cell": dataclasses.asdict(cell),
        "trace_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": ana.argument_bytes,
            "peak_per_card_bytes": ana.peak_bytes,
            "hbm_per_card_bytes": HBM_PER_CARD,
            "fits_hbm": bool(ana.peak_bytes < HBM_PER_CARD),
        },
        "op_analysis": ana.to_json(),
        "roofline": rf.to_json(),
    }


def run_cell(arch: str, shape_name: str, mesh_name: str = "single_h100",
             overrides: Optional[Dict] = None) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cell = cell_runtime(cfg, shape, overrides)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            **trace_cell(cfg, shape, cell)}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def parse_overrides(pairs) -> Dict:
    out: Dict[str, Any] = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if v in ("True", "False", "true", "false"):
            out[k] = v.lower() == "true"
        elif v in ("None", "null"):
            out[k] = None
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", choices=tuple(MESHES), default="single")
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, help="one shape (default all)")
    ap.add_argument("--set", action="append", dest="overrides",
                    help="cell override knob=value (repeatable)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--force", action="store_true",
                    help="recompute cells with existing artifacts")
    ap.add_argument("--tag", default=None,
                    help="artifact suffix for hillclimb variants")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.overrides)
    mesh_name = MESHES[args.mesh]
    archs = [args.arch] if args.arch else arch_names()
    shapes = [args.shape] if args.shape else list(SHAPES)
    outdir = os.path.join(args.out, mesh_name)
    os.makedirs(outdir, exist_ok=True)
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            ok, reason = applicable(cfg, SHAPES[shape_name])
            tag = f"--{args.tag}" if args.tag else ""
            path = os.path.join(outdir, f"{arch}--{shape_name}{tag}.json")
            if not ok:
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "skipped": reason}, f,
                              indent=1)
                print(f"[skip] {mesh_name} {arch} {shape_name}: {reason}")
                continue
            if os.path.exists(path) and not args.force:
                print(f"[have] {mesh_name} {arch} {shape_name}")
                continue
            print(f"[cell] {mesh_name} {arch} {shape_name} ...", flush=True)
            try:
                rec = run_cell(arch, shape_name, mesh_name, overrides)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if os.path.exists(path + ".fail"):
                    os.remove(path + ".fail")
                r, m = rec["roofline"], rec["memory"]
                print(f"       trace={rec['trace_s']:.1f}s "
                      f"peak/card={m['peak_per_card_bytes'] / 2**30:.2f}GiB "
                      f"fits={m['fits_hbm']} bottleneck={r['bottleneck']} "
                      f"roofline_frac={r['roofline_fraction']:.3f} "
                      f"kernels={rec['op_analysis']['kernel_calls']}",
                      flush=True)
            except Exception as e:      # a failing cell is a bug; record
                failures.append((mesh_name, arch, shape_name, repr(e)))
                with open(path + ".fail", "w") as f:
                    f.write(traceback.format_exc())
                print(f"[FAIL] {mesh_name} {arch} {shape_name}: {e!r}",
                      flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f4 in failures:
            print("  ", *f4)
        return 1
    print("\nall requested cells green")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
