"""Dry-run: every (arch × shape) cell traced on the ``meta`` device, on one
H100 or on a mesh of them.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  The
reference lowers and compiles each cell's step against
``ShapeDtypeStruct``\\ s under the production shardings; here the step
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

Meshes (``--mesh``): ``single`` is one card (``single_h100``); ``quad``,
``pod`` and ``multipod`` are :mod:`repro_torch.launch.mesh`'s quad_2x2 (4
cards), pod_32x8 (256) and multipod_2x32x8 (512).  On a mesh the cell is
built as the reference's ``build_cell`` builds it (:func:`build_cell`):
parameters, AdamW moments, batch and cache are DTensors placed by
``default_rules(mesh, fsdp=cell.fsdp, seq_shard=cell.seq_shard)``, the
residual stream is pinned to ``act_spec`` (``P(dp, "model")`` under
``act_seq_shard``, else ``P(dp)``), the microbatches are clamped so that
each one's batch still splits over the data axes; the layout that
``act_spec`` gives turns on what the reference's ``moe_mesh`` and
``attention_sp`` do (a MoE on a mesh always dispatches per data shard,
attention takes its rank's queries when the sequence is split).  The step is
traced as rank 0 of a fake process group of the mesh's size
(``torch.testing``'s ``FakeStore`` backend: collectives return at once and
move nothing), so every number is one card's: its peak of live bytes
against ``HBM_PER_CARD``, its FLOPs and bytes, and its collective bytes by
kind, which feed the roofline's collective term.  The group is destroyed
after each cell.  :func:`build_cell` also runs on a real mesh (NCCL on
cards, gloo on the CPU): ``chip_smoke.py`` runs its world-1 cell on the
card.

The three LM kernels and the train step's (AdamW, the microbatch
accumulation) run as their meta stand-ins
(:mod:`repro_torch.kernels.meta`), each call counted by its work formula
at the local shapes it is given (one card's share of the heads, experts'
columns or sequence); no plain version runs.

Artifacts: one JSON per cell under ``build/dryrun_torch/<mesh>/``
(``<arch>--<shape>[--<tag>].json``; a ``.fail`` file with the traceback
where a cell raised), read by :mod:`repro_torch.bench.roofline` and
:mod:`repro_torch.bench.report`.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
    python -m repro_torch.launch.dryrun                   # all 40 cells
    python -m repro_torch.launch.dryrun --mesh pod        # 256 cards
    python -m repro_torch.launch.dryrun --mesh all
    python -m repro_torch.launch.dryrun --set microbatches=8 --tag mb8
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import (SHAPES, applicable, arch_names, get_config,
                                 input_specs)
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.cells import CellConfig, cell_runtime
from repro_torch.launch.mesh import dp_axes, make_mesh, mesh_chips
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.launch.roofline import HBM_PER_CARD, roofline
from repro_torch.models import LM, ModelConfig
from repro_torch.models.layers import place_params
from repro_torch.models.lm import cache_defs, cache_dtype, init_cache
from repro_torch.models.sharding import (P, default_rules, local_shape,
                                         placements_for, spec_for)
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import (RuntimeConfig, init_state, make_decode_step,
                                 make_prefill_step, make_train_step)
from repro_torch.runtime.serve import decode_step, prefill

#: --mesh name -> artifact folder
MESHES = {"single": "single_h100", "quad": "quad_2x2", "pod": "pod_32x8",
          "multipod": "multipod_2x32x8"}
CHIPS = 1
OUT = "build/dryrun_torch"


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks that only rank 0 runs (the
    ``FakeStore`` backend of ``torch.testing``: collectives complete at
    once and move nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    # DTensor's notes on sequential collectives over two mesh dims
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_for(name: str):
    """The DeviceMesh of a dry-run mesh (a ``cpu`` mesh: meta tensors)."""
    return make_mesh(name, "cpu")


# ---------------------------------------------------------------------------
# Cell assembly: (step fn, its arguments)
# ---------------------------------------------------------------------------

def _placed(t: torch.Tensor, logical, mesh, rules):
    """A DTensor of ``t``'s shape placed by ``logical``: this rank's block
    (on ``meta``: no data; else split from the whole, which every rank
    holds)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    spec = spec_for(tuple(t.shape), logical, mesh, rules)
    pl = placements_for(spec, mesh)
    if t.is_meta:
        loc = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                          device="meta")
        return DTensor.from_local(loc, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def place_batch(data: Dict[str, torch.Tensor], mesh, rules
                ) -> Dict[str, torch.Tensor]:
    """The step's inputs as DTensors, each by its leading ``batch`` dim
    (a scalar stays as it is)."""
    return {k: (_placed(v, ("batch",) + (None,) * (v.ndim - 1), mesh, rules)
                if v.ndim else v) for k, v in data.items()}


def build_cell(cfg: ModelConfig, shape: ShapeSpec, cell: CellConfig,
               mesh=None, *, model: Optional[LM] = None,
               data: Optional[Dict[str, torch.Tensor]] = None,
               capacity: Optional[int] = None
               ) -> Tuple[Callable, tuple]:
    """The cell's step and its arguments: ``fn(*args)`` runs one step.

    Without a mesh: one card, all on ``meta`` (bf16).  With a mesh: the
    reference's sharded cell — parameters (``model``, default a ``meta``
    one), moments, batch (``data``, default ``input_specs``) and cache
    placed by the cell's rules, ``act_spec`` from ``act_seq_shard``, with
    the cell's microbatches clamped first (:func:`clamp_microbatches`).  ``capacity``: a prefill's cache rows (default
    the sequence)."""
    model = LM(cfg, device="meta") if model is None else model
    data = input_specs(cfg, shape) if data is None else data
    act_spec = None
    if mesh is not None:
        rules = default_rules(mesh, fsdp=cell.fsdp,
                              seq_shard=cell.seq_shard)
        place_params(model, mesh, rules)
        dp = dp_axes(mesh)
        act_spec = P(dp, "model") if cell.act_seq_shard else P(dp)
        data = place_batch(data, mesh, rules)
    if shape.kind == "train":
        rt = RuntimeConfig(microbatches=cell.microbatches, remat=cell.remat,
                           remat_group=cell.remat_group,
                           remat_inner=cell.remat_inner,
                           loss_chunks=cell.loss_chunks,
                           data_axes=dp_axes(mesh) if mesh else ("data",),
                           act_spec=act_spec)
        opt = AdamW(AdamWConfig())
        state = init_state(model, opt)                   # f32 moments
        return make_train_step(cfg, opt, rt), (state, dict(data))

    cap = capacity or shape.seq_len
    if shape.kind == "prefill":
        extras = {k: v for k, v in data.items() if k != "tokens"}
        if mesh is None:
            step = make_prefill_step(cfg, capacity=cap)
            return (lambda m, tokens, kw: step(m, tokens, **kw),
                    (model, data["tokens"], extras))
        dev = data["tokens"].to_local().device

        def prefill_fn(m, tokens, kw):
            cache = init_cache(cfg, shape.global_batch, cap, device=dev,
                               mesh=mesh, rules=rules)
            return prefill(m, tokens, capacity=cap, act_spec=act_spec,
                           cache=cache, **kw)
        return prefill_fn, (model, data["tokens"], extras)

    # decode
    kv_dtype = (torch.float8_e4m3fn if cell.cache_dtype == "f8"
                else torch.bfloat16)

    def _cdtype(key):
        if key.startswith(("k", "v", "xk", "xv")):
            return kv_dtype
        return cache_dtype(key)

    pos = shape.seq_len - 1
    if mesh is None:
        cache = {k: torch.empty(shp, dtype=_cdtype(k), device="meta")
                 for k, shp in cache_defs(cfg, shape.global_batch,
                                          shape.seq_len).items()}
        step = make_decode_step(cfg)
        return (lambda m, c, token: step(m, c, token, pos),
                (model, cache, data["token"]))
    dev = data["token"].to_local().device
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device=dev,
                       mesh=mesh, rules=rules)
    for k, v in cache.items():
        if _cdtype(k) != v.dtype:
            cache[k] = v.to(_cdtype(k))
    return (lambda m, c, token: decode_step(m, c, token, pos),
            (model, cache, data["token"]))


def clamp_microbatches(cell: CellConfig, shape: ShapeSpec, mesh=None
                       ) -> CellConfig:
    """The reference's clamp: each microbatch's batch still tiles the data
    axes (B/M % n_dp == 0; one card: B % M == 0)."""
    if shape.kind != "train":
        return cell
    n_dp = 1
    if mesh is not None:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        for a in dp_axes(mesh):
            n_dp *= sizes[a]
    mb = max(1, min(cell.microbatches, shape.global_batch // n_dp))
    while shape.global_batch % mb or (shape.global_batch // mb) % n_dp:
        mb -= 1
    return cell.replace(microbatches=mb)


# ---------------------------------------------------------------------------
# One cell: trace, analyse
# ---------------------------------------------------------------------------

def trace_cell(cfg: ModelConfig, shape: ShapeSpec, cell: CellConfig,
               mesh=None, capacity: Optional[int] = None) -> Dict[str, Any]:
    """Build the cell (on ``mesh``, a DeviceMesh of the current process
    group), trace one step under ``OpAnalysis``; the record's memory, op
    analysis, roofline and seconds (its arch/shape/mesh fields are the
    caller's)."""
    t0 = time.time()
    chips = mesh_chips(mesh) if mesh is not None else CHIPS
    cell = clamp_microbatches(cell, shape, mesh)
    fn, args = build_cell(cfg, shape, cell, mesh, capacity=capacity)
    with OpAnalysis() as oa:
        oa.track(*args)
        out = fn(*args)
    del out, fn, args
    trace_s = time.time() - t0
    ana = oa.analysis
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    rf = roofline(per_chip_flops=ana.flops, per_chip_hbm_bytes=ana.hbm_bytes,
                  per_chip_collective_bytes=ana.total_collective_bytes,
                  chips=chips, active_params=cfg.active_param_count(),
                  tokens=tokens, kind=shape.kind)
    return {
        "chips": chips, "cell": dataclasses.asdict(cell),
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
    """One cell of SHAPES on a named mesh (``single_h100`` or one of
    :data:`repro_torch.launch.mesh.MESHES`, traced under
    :func:`fake_world`)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    cell = cell_runtime(cfg, shape, overrides)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if mesh_name == MESHES["single"]:
        return {**rec, **trace_cell(cfg, shape, cell)}
    n = mesh_chips(mesh_shape(mesh_name))
    with fake_world(n):
        return {**rec, **trace_cell(cfg, shape, cell, mesh_for(mesh_name))}


def mesh_shape(name: str):
    from repro_torch.launch.mesh import MeshShape
    return MeshShape.named(name)


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
    ap.add_argument("--mesh", choices=tuple(MESHES) + ("all",),
                    default="single")
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
    mesh_names = ([MESHES[args.mesh]] if args.mesh != "all"
                  else list(MESHES.values()))
    archs = [args.arch] if args.arch else arch_names()
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = []
    for mesh_name in mesh_names:
        outdir = os.path.join(args.out, mesh_name)
        os.makedirs(outdir, exist_ok=True)
        for arch in archs:
            cfg = get_config(arch)
            for shape_name in shapes:
                ok, reason = applicable(cfg, SHAPES[shape_name])
                tag = f"--{args.tag}" if args.tag else ""
                path = os.path.join(outdir,
                                    f"{arch}--{shape_name}{tag}.json")
                if not ok:
                    with open(path, "w") as f:
                        json.dump({"arch": arch, "shape": shape_name,
                                   "mesh": mesh_name, "skipped": reason}, f,
                                  indent=1)
                    print(f"[skip] {mesh_name} {arch} {shape_name}: "
                          f"{reason}")
                    continue
                if os.path.exists(path) and not args.force:
                    print(f"[have] {mesh_name} {arch} {shape_name}")
                    continue
                print(f"[cell] {mesh_name} {arch} {shape_name} ...",
                      flush=True)
                try:
                    rec = run_cell(arch, shape_name, mesh_name, overrides)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    if os.path.exists(path + ".fail"):
                        os.remove(path + ".fail")
                    r, m = rec["roofline"], rec["memory"]
                    coll = rec["op_analysis"]["total_collective_bytes"]
                    print(f"       trace={rec['trace_s']:.1f}s "
                          f"peak/card={m['peak_per_card_bytes'] / 2**30:.2f}"
                          f"GiB fits={m['fits_hbm']} "
                          f"coll/card={coll / 2**30:.3f}GiB "
                          f"bottleneck={r['bottleneck']} "
                          f"roofline_frac={r['roofline_fraction']:.3f} "
                          f"kernels={rec['op_analysis']['kernel_calls']}",
                          flush=True)
                except Exception as e:      # a failing cell is a bug
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
