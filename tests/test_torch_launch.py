"""The port's launch layer (``repro_torch.configs.shapes``,
``repro_torch.launch.{cells,roofline,op_analysis,dryrun}``,
``repro_torch.bench.{roofline,report}``) against the JAX package's on the
CPU.

- Shapes, applicability, input specs, size classes and cell knobs: equal
  to the reference's for all 10 archs x 4 shapes, with and without
  overrides; ``parse_overrides`` equal on the reference's forms (its
  function is read from ``repro/launch/dryrun.py``'s source: importing
  that module sets ``XLA_FLAGS``).
- The roofline: the reference's ``TestRoofline`` cases under the H100's
  constants; the closed-form count of flash's kept (query, key) pairs equal
  to the mask's count; each kernel bound of ``PERF.md``'s table unchanged
  by the formulas' move out of ``chip_smoke.py``.
- The analyzer: one full step (train, prefill, decode) on ``meta`` for the
  smoke configs of a dense, an SSM, a hybrid, a MoE and the
  encoder-decoder arch ends without calling a plain version, and its
  kernel calls equal the calls the same step makes into ``ops`` on the
  CPU (counted by a wrapper), the optimizer's three a training step
  included.
- Matrix-product FLOPs of a smoke prefill and train step of minicpm
  (dense) and granite (MoE) against ``repro.launch.hlo_analysis.analyze``
  over the JAX step compiled on the CPU, with its elementwise counting
  switched off.  Tolerance: exact (rel 1e-12) once the one gap is added:
  on the CPU the reference runs its blockwise jnp attention, which
  multiplies every (query, key) pair, where the kernel's formula counts
  the pairs the causal mask keeps (forward: 2 products; backward: 5).
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.launch.hlo_analysis as jhlo
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import applicable as japplicable
from repro.configs.shapes import input_specs as jinput_specs
import repro.launch.cells as jcells
from repro.launch.cells import cell_runtime as jcell_runtime
from repro.launch.cells import size_class as jsize_class
from repro.models import model_defs, shape_tree
from repro.models.lm import prefill as jprefill
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim.adamw import OptState as JOptState
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import TrainState as JTrainState
from repro.runtime import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.bench import report, roofline as bench_roofline
from repro_torch.configs import (SHAPES, ShapeSpec, applicable, cells,
                                 get_smoke, input_specs)
from repro_torch.kernels import ops, ref
from repro_torch.launch import cells as tcells
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.cells import CellConfig
from repro_torch.models import LM, decode_step, init_cache, prefill
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import (RuntimeConfig, init_state,
                                 make_train_step)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = configs.arch_names()
OVERRIDES = ({}, {"microbatches": 2, "remat": None, "cache_dtype": "f8",
                  "act_seq_shard": True})


# ---------------------------------------------------------------------------
# shapes and cells, field for field
# ---------------------------------------------------------------------------

def test_shapes_and_cells_list_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    import repro.configs as jconfigs
    assert sorted(cells(include_skipped=True)) == sorted(jconfigs.cells(
        include_skipped=True))
    assert len(cells(include_skipped=True)) == 40 and len(cells()) == 34


@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_and_input_specs_equal_reference(arch):
    cfg, jcfg = configs.get_config(arch), jget_config(arch)
    for name, shape in SHAPES.items():
        assert applicable(cfg, shape) == japplicable(jcfg, JSHAPES[name])
        got, want = input_specs(cfg, shape), jinput_specs(jcfg,
                                                          JSHAPES[name])
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k


@pytest.mark.parametrize("overrides", OVERRIDES, ids=("tuned", "override"))
@pytest.mark.parametrize("arch", ARCHS)
def test_size_class_and_cell_runtime_equal_reference(arch, overrides):
    cfg, jcfg = configs.get_config(arch), jget_config(arch)
    assert tcells.size_class(cfg) == jsize_class(jcfg)
    for name, shape in SHAPES.items():
        got = tcells.cell_runtime(cfg, shape, dict(overrides))
        want = jcell_runtime(jcfg, JSHAPES[name], dict(overrides))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert tcells.TUNED == jcells.TUNED


def _reference_parse_overrides():
    path = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "parse_overrides")
    from typing import Any, Dict
    ns = {"Any": Any, "Dict": Dict}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["parse_overrides"]


@pytest.mark.parametrize("pairs", [
    None, [], ["microbatches=8"], ["remat=None", "fsdp=false"],
    ["donate=True", "remat=full", "cache_dtype=f8", "loss_chunks=null"],
    ["act_seq_shard=true", "remat_group=4", "remat_inner=dots"]])
def test_parse_overrides_equals_reference(pairs):
    assert dryrun.parse_overrides(pairs) == \
        _reference_parse_overrides()(pairs)


# ---------------------------------------------------------------------------
# roofline: the reference's cases at the H100's constants, and the formulas
# ---------------------------------------------------------------------------

class TestRoofline:
    def test_terms_and_bottleneck(self):
        r = rl.roofline(per_chip_flops=rl.PEAK_FLOPS,
                        per_chip_hbm_bytes=rl.HBM_BW / 2,
                        per_chip_collective_bytes=0, chips=1,
                        active_params=1e9, tokens=1e6, kind="train")
        assert r.compute_s == pytest.approx(1.0)
        assert r.memory_s == pytest.approx(0.5)
        assert r.collective_s == 0.0
        assert r.bottleneck == "compute"
        assert r.step_time_s == pytest.approx(1.0)

    def test_model_flops_kinds(self):
        for kind, f in rl.KIND_FACTOR.items():
            r = rl.roofline(per_chip_flops=1, per_chip_hbm_bytes=1,
                            per_chip_collective_bytes=1, chips=2,
                            active_params=10, tokens=5, kind=kind)
            assert r.model_flops == f * 50

    def test_roofline_fraction_definition(self):
        r = rl.roofline(per_chip_flops=rl.PEAK_FLOPS, per_chip_hbm_bytes=0,
                        per_chip_collective_bytes=0, chips=1,
                        active_params=1, tokens=rl.PEAK_FLOPS / 6,
                        kind="train")
        assert r.roofline_fraction == pytest.approx(1.0)
        assert rl.mfu(r.model_flops, r.step_time_s) == pytest.approx(1.0)

    def test_kind_factors_equal_reference(self):
        from repro.launch.roofline import KIND_FACTOR
        assert rl.KIND_FACTOR == KIND_FACTOR


def _mask_pairs(Sq, Sk, causal=True, window=None, kv_len=None,
                q_offset=0):
    """The count the kernel bound took before: a dense boolean mask (the
    queries at positions ``q_offset`` on)."""
    qp = torch.arange(Sq)[:, None] + q_offset
    kp = torch.arange(Sk)[None, :]
    keep = (kp < (Sk if kv_len is None else kv_len)).expand(Sq, Sk)
    if causal:
        keep = keep & (kp <= qp)
    if window is not None:
        keep = keep & (kp > qp - window)
    return int(keep.sum())


def test_flash_pairs_closed_form_equals_mask_count():
    for Sq in (1, 5, 16, 33):
        for Sk in (1, 7, 16, 40):
            for causal in (True, False):
                for window in (None, 1, 3, 8, 64):
                    for kv_len in (None, 0, 5, 100):
                        got = rl.flash_pairs(Sq, Sk, causal=causal,
                                             window=window, kv_len=kv_len)
                        assert got == _mask_pairs(Sq, Sk, causal, window,
                                                  kv_len), \
                            (Sq, Sk, causal, window, kv_len)
    # a sequence shard's queries at an offset (causal, over the keys up to
    # the shard's last query and beyond)
    for Sq in (1, 5, 16):
        for off in (1, 7, 40):
            for Sk in (off + Sq, off + Sq + 3):
                for window in (None, 1, 3, 8, 64):
                    got = rl.flash_pairs(Sq, Sk, window=window, q_offset=off)
                    assert got == _mask_pairs(Sq, Sk, True, window,
                                              q_offset=off), \
                        (Sq, Sk, off, window)


def test_kernel_bounds_of_the_perf_table_unchanged():
    bf16, f32 = torch.bfloat16, torch.float32
    rows = [  # (bound, PERF.md's value, its unit)
        (rl.flash_bound(1, 32, 32, 1536, 1536, 80, bf16), 0.0122,
         "operations"),
        (rl.flash_bound(1, 24, 8, 1536, 1536, 64, bf16), 0.0073,
         "operations"),
        (rl.flash_bound(8, 24, 8, 512, 512, 84, bf16), 0.0131, "bytes"),
        (rl.flash_bound(4, 20, 20, 1500, 1500, 64, bf16, causal=False),
         0.0466, "operations"),
        (rl.flash_bwd_bound(8, 24, 8, 512, 64, bf16), 0.0201, "bytes"),
        (rl.ssd_bound(1, 1536, 256, 80, 64, 64, f32), 0.0613, "operations"),
        (rl.ssd_split_bound(1, 1536, 256, 80, 64, 64, f32), 0.0246,
         "operations"),
        (rl.ssd_bwd_bound(8, 512, 256, 80, 64, 64), 0.326, "operations"),
        (rl.ssd_bwd_split_bound(8, 512, 256, 80, 64, 64), 0.1316,
         "operations"),
        (rl.gmm_bound(40, 384, 1536, 512, bf16), 0.0376, "bytes"),
        (rl.gmm_bwd_bound(40, 1024, 1536, 512, bf16), 0.1303,
         "operations"),
    ]
    for (ms, by), want, unit in rows:
        digits = len(str(want).split(".")[1])
        assert round(ms, digits) == want and by == unit, (ms, want)


# ---------------------------------------------------------------------------
# the analyzer against the CPU step's calls into ops
# ---------------------------------------------------------------------------

KERNELS = ("flash_attention_bshd", "ssd_scan", "grouped_matmul")
#: the optimizer's entry points, all counted under the ``adamw`` kernel
OPTIMIZER = ("grad_sumsq", "sum_in_order", "adamw_update")
#: the microbatch accumulation's entry point (the ``grad_accum`` kernel)
ACCUMULATE = ("grad_accumulate",)
#: the decode step's entry points, each its kernel's name
DECODE = ("rmsnorm", "rope_cache_write", "decode_attention",
          "ssd_decode_step")


class Calls:
    """Counts the model's calls into ``ops``' three LM kernels, the train
    step's and the decode step's; with ``no_plain``, any plain version
    called raises."""

    def __init__(self, monkeypatch, no_plain=False):
        self.n = dict.fromkeys(KERNELS + OPTIMIZER + ACCUMULATE + DECODE, 0)
        for name in KERNELS + OPTIMIZER + ACCUMULATE + DECODE:
            fn = getattr(ops, name)

            def counted(*a, _n=name, _fn=fn, **kw):
                self.n[_n] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(ops, name, counted)
        if no_plain:
            for name in ("attention_ref", "ssd_scan_ref",
                         "grouped_matmul_ref", "grad_sumsq_ref",
                         "sum_in_order_ref", "adamw_update_ref",
                         "grad_accumulate_ref", "rmsnorm_ref",
                         "rope_cache_ref", "decode_attention_ref",
                         "ssd_decode_step_ref"):
                def refuse(*a, _n=name, **kw):
                    raise AssertionError(f"{_n} ran on meta")
                monkeypatch.setattr(ref, name, refuse)


def _cpu_step(cfg, shape, cell):
    """The cell's step on the CPU with random values: bf16 parameters,
    float32 moments, tokens in the vocab."""
    gen = torch.Generator().manual_seed(0)
    model = LM(cfg, device="cpu", generator=gen)
    B, S = shape.global_batch, shape.seq_len
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                         dtype=torch.int32)
    extras = {}
    if cfg.enc_dec and shape.kind != "decode":
        extras["frames"] = torch.randn((B, cfg.enc_frames, cfg.d_model),
                                       generator=gen).to(torch.bfloat16)
    if shape.kind == "train":
        opt = AdamW(AdamWConfig())
        rt = RuntimeConfig(microbatches=cell.microbatches, remat=cell.remat,
                           remat_group=cell.remat_group,
                           loss_chunks=cell.loss_chunks)
        make_train_step(cfg, opt, rt)(init_state(model, opt),
                                      {"tokens": toks, "labels": toks,
                                       **extras})
    elif shape.kind == "prefill":
        prefill(model, toks, capacity=S, **extras)
    else:
        decode_step(model, init_cache(cfg, B, S), toks[:, 0], S - 1)


STEP_ARCHS = ("minicpm-2b", "mamba2-1.3b", "zamba2-2.7b",
              "granite-moe-3b-a800m", "whisper-large-v3")
STEP_SHAPES = {"train": ShapeSpec("train_smoke", "train", 24, 4),
               "prefill": ShapeSpec("prefill_smoke", "prefill", 24, 2),
               "decode": ShapeSpec("decode_smoke", "decode", 24, 2)}
TRAIN_CELL = CellConfig(microbatches=2, remat="full", loss_chunks=2)


@pytest.mark.parametrize("kind", list(STEP_SHAPES))
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_analyzer_kernel_calls_equal_cpu_calls(arch, kind, monkeypatch):
    cfg, shape = get_smoke(arch), STEP_SHAPES[kind]
    cell = TRAIN_CELL if kind == "train" else CellConfig(remat=None)
    with monkeypatch.context() as mp:
        cpu = Calls(mp)
        _cpu_step(cfg, shape, cell)
    with monkeypatch.context() as mp:
        meta = Calls(mp, no_plain=True)
        rec = dryrun.trace_cell(cfg, shape, cell)
    assert meta.n == cpu.n
    got = rec["op_analysis"]["kernel_calls"]
    flash, ssd, gmm = (cpu.n[k] for k in KERNELS)
    again = 2 if kind == "train" else 1       # remat "full" recomputes
    want = {"flash_attention": flash, "ssd_scan": ssd,
            "grouped_matmul": gmm, **{k: cpu.n[k] for k in DECODE}}
    if kind == "train":
        want.update(flash_attention_bwd=flash // again,
                    ssd_scan_bwd=ssd // again,
                    adamw=sum(cpu.n[k] for k in OPTIMIZER),
                    grad_accum=cpu.n["grad_accumulate"])
        want["grouped_matmul"] += 2 * gmm // again      # dx and dw
        assert want["adamw"] == 3      # the norm's two calls, the update
        # one accumulation call a microbatch
        assert want["grad_accum"] == cell.microbatches
    assert got == {k: n for k, n in want.items() if n}
    if kind != "decode" and arch != "mamba2-1.3b":
        assert flash > 0
    ana = rec["op_analysis"]
    assert ana["flops"] > 0 and ana["hbm_bytes"] > 0
    # what the step is given: bf16 parameters (and float32 moments and
    # the int32 step count), the data, a decode step's cache
    n = sum(p.numel() for p in LM(cfg, device="meta").parameters())
    data = sum(t.numel() * t.element_size()
               for t in input_specs(cfg, shape).values()
               if kind != "decode" or t.ndim)
    if kind == "decode":
        data += sum(t.numel() * t.element_size() for t in init_cache(
            cfg, shape.global_batch, shape.seq_len,
            device="meta").values())
    assert rec["memory"]["argument_bytes"] == \
        (n * 10 + 4 if kind == "train" else n * 2) + data
    assert rec["memory"]["peak_per_card_bytes"] > \
        rec["memory"]["argument_bytes"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_matmul_backward_on_meta_counts_dx_and_dw(dtype):
    """On meta, bf16 takes the backward kernels' stand-ins: one forward and
    one dx and one dw call, each with its own product's work, and no copy;
    float32 keeps the transposed copies (two clones) and the forward
    kernel's stand-in for each gradient, with the same work."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch.op_analysis import OpAnalysis

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    E, C, d, f = 4, 72, 48, 40
    x, w = (torch.empty(s, dtype=dtype, device="meta", requires_grad=True)
            for s in ((E, C, d), (E, d, f)))
    dy = torch.empty((E, C, f), dtype=dtype, device="meta")
    with OpAnalysis() as oa, Ops() as seen:
        y = ops.grouped_matmul(x, w)
        dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert dx.shape == x.shape and dw.shape == w.shape
    a = oa.analysis
    work = [rl.gmm_work(E, C, d, f, dtype), rl.gmm_work(E, C, f, d, dtype),
            rl.gmm_work(E, d, C, f, dtype)]
    assert a.kernel_calls == {"grouped_matmul": 3}
    assert a.kernel_flops["grouped_matmul"] == sum(fl for fl, _ in work)
    assert a.kernel_bytes["grouped_matmul"] == sum(b for _, b in work)
    copies = [n for n in seen.names if n in ("clone", "copy_")]
    assert len(copies) == (0 if dtype == torch.bfloat16 else 2), seen.names


# ---------------------------------------------------------------------------
# matrix-product FLOPs against the JAX step's compiled HLO
# ---------------------------------------------------------------------------

def _jax_dot_flops(step, *structs) -> float:
    hlo = jax.jit(step).lower(*structs).compile().as_text()
    saved = jhlo._ELEMENTWISE
    jhlo._ELEMENTWISE = set()           # products only
    try:
        return jhlo.analyze(hlo).flops
    finally:
        jhlo._ELEMENTWISE = saved


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-moe-3b-a800m"])
def test_matmul_flops_equal_reference_hlo(arch, kind):
    jcfg, cfg = jget_smoke(arch), get_smoke(arch)
    B, S = 2, 32
    params = shape_tree(model_defs(jcfg))
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "prefill":
        want = _jax_dot_flops(
            lambda p, t: jprefill(p, jcfg, t, capacity=S), params, tokens)
        cell = CellConfig(remat=None)
    else:
        f32 = lambda t: jax.tree.map(
            lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), t)
        state = JTrainState(params=params, opt=JOptState(
            step=jax.ShapeDtypeStruct((), jnp.int32), m=f32(params),
            v=f32(params)), compression=None)
        step = jmake_train_step(jcfg, JAdamW(JAdamWConfig()),
                                JRuntimeConfig(microbatches=1, remat=None,
                                               loss_chunks=1))
        want = _jax_dot_flops(step, state, {"tokens": tokens,
                                            "labels": tokens})
        cell = CellConfig(microbatches=1, remat="none", loss_chunks=1)
    ana = dryrun.trace_cell(cfg, ShapeSpec(kind, kind, S, B),
                            cell)["op_analysis"]
    # the pairs the causal mask drops, which the reference's oracle
    # multiplies: 2 products forward, 5 backward, per attention layer
    masked = S * S - rl.flash_pairs(S, S)
    products = 2 + (5 if kind == "train" else 0)
    gap = 2.0 * products * B * cfg.n_heads * cfg.head_dim * masked \
        * cfg.n_layers
    # the optimizer's kernel does elementwise work only, which the
    # reference's count here leaves out
    got = ana["matmul_flops"] + sum(f for k, f in ana["kernel_flops"].items()
                                    if k != "adamw")
    assert got + gap == pytest.approx(want, rel=1e-12)


# ---------------------------------------------------------------------------
# the CLI, its artifacts and the tables that read them
# ---------------------------------------------------------------------------

def test_dryrun_writes_records_and_tables_read_them(tmp_path, capsys):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k",
                        "--out", out]) == 0
    assert dryrun.main(["--arch", "minicpm-2b", "--shape", "long_500k",
                        "--out", out]) == 0
    folder = tmp_path / "single_h100"
    rec = json.loads((folder / "mamba2-1.3b--long_500k.json").read_text())
    assert rec["mesh"] == "single_h100" and rec["chips"] == 1
    assert rec["memory"]["fits_hbm"] is True
    assert rec["memory"]["hbm_per_card_bytes"] == rl.HBM_PER_CARD
    assert rec["roofline"]["collective_s"] == 0.0
    assert rec["cell"] == dataclasses.asdict(tcells.cell_runtime(
        configs.get_config("mamba2-1.3b"), SHAPES["long_500k"]))
    skip = json.loads((folder / "minicpm-2b--long_500k.json").read_text())
    assert "pure full-attention" in skip["skipped"]
    # a cell that raises leaves a .fail file and a non-zero exit
    assert dryrun.main(["--arch", "mamba2-1.3b", "--shape", "train_4k",
                        "--set", "remat=bogus", "--out", out,
                        "--tag", "bad"]) == 1
    assert (folder / "mamba2-1.3b--train_4k--bad.json.fail").exists()
    capsys.readouterr()
    lines = bench_roofline.collect(root=out)["lines"]
    assert lines[0].startswith("roofline,mamba2-1.3b,long_500k,")
    assert lines[1] == "roofline,minicpm-2b,long_500k,skip"
    summary = report.dryrun_summary(root=out)
    assert "| single_h100 | 1 | 1 | 0 |" in summary
    table = report.roofline_table(root=out)
    assert "| mamba2-1.3b | long_500k |" in table and "| yes |" in table


def test_roofline_without_artifacts_adds_no_lines(tmp_path, capsys):
    assert bench_roofline.collect(root=str(tmp_path)) == {"lines": []}
    assert "no dry-run artifacts found" in capsys.readouterr().out


def test_launch_modules_import_neither_jax_nor_the_reference():
    code = ("import repro_torch.launch.dryrun, repro_torch.bench.roofline, "
            "repro_torch.bench.report, repro_torch.bench.run, "
            "repro_torch.examples.serve_llm, repro_torch.kernels.meta\n"
            "import sys, json\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": os.path.join(ROOT, "src")})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
