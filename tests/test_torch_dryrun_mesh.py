"""The dry-run on a mesh, the analyzer's collective terms, and the cache
held once (no JAX: the port alone, on ``meta`` tensors and a fake process
group).

- Every smoke arch's train, prefill and decode cell traces on quad_2x2
  under the fake backend (rank 0 of 4) with a per-card peak and a
  positive collective total, and leaves no process group behind.
- An explicit all-reduce of N bytes counts N (functional and in-place
  ``c10d``), an all-gather its input's bytes.
- The kernel stand-ins see the local shapes: gemma2's prefill on (2, 2)
  counts the flash calls of one card, a quarter of one card's work alone
  (half the batch, half the heads).
- The cache held once: a prefill's peak of live bytes on ``meta`` is at
  least its stacked cache below that of the per-layer lists stacked at
  the end (the previous prefill, kept here as the reference), and a
  decode step's transient stays below one layer's float32 k cache.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import arch_names, get_smoke
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.cells import cell_runtime
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models import LM, spmd
from repro_torch.models.attention import DECODE_ROWS
from repro_torch.models.lm import (_pad_cap, cache_defs,
                                   decode_step, init_cache, prefill)
from repro_torch.models.layers import rmsnorm, unembed

SMOKE_SHAPES = {"train": ShapeSpec("t", "train", 16, 4),
                "prefill": ShapeSpec("p", "prefill", 16, 4),
                "decode": ShapeSpec("d", "decode", 16, 4)}


@pytest.mark.parametrize("kind", sorted(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", arch_names())
def test_smoke_cell_traces_on_quad(arch, kind):
    cfg = get_smoke(arch)
    shape = SMOKE_SHAPES[kind]
    cell = dataclasses.replace(cell_runtime(cfg, shape), microbatches=2) \
        if kind == "train" else cell_runtime(cfg, shape)
    with dryrun.fake_world(4):
        rec = dryrun.trace_cell(cfg, shape, cell, dryrun.mesh_for("quad_2x2"))
    assert not dist.is_initialized()
    assert rec["chips"] == 4
    assert rec["memory"]["peak_per_card_bytes"] > 0
    ana = rec["op_analysis"]
    assert ana["total_collective_bytes"] > 0
    assert sum(ana["collective_count"].values()) > 0
    assert rec["roofline"]["collective_s"] > 0


def test_run_cell_leaves_no_process_group():
    rec = dryrun.run_cell("mamba2-1.3b", "decode_32k", "quad_2x2")
    assert not dist.is_initialized()
    assert rec["mesh"] == "quad_2x2" and rec["chips"] == 4
    assert rec["memory"]["fits_hbm"]


def test_collective_bytes_are_counted_by_kind():
    with dryrun.fake_world(4):
        mesh = dryrun.mesh_for("quad_2x2")
        t = torch.empty((3, 5), dtype=torch.float32, device="meta")
        with OpAnalysis() as oa:
            spmd.all_reduce(t, mesh, ("data",))
            dist.all_reduce(torch.empty((7,), device="meta"))
            spmd.all_gather(t, mesh, "model", 1)
            spmd.reduce_scatter(torch.empty((4, 2), device="meta"), mesh,
                                "model", 0)
        a = oa.analysis
    assert a.collective_bytes["all-reduce"] == 3 * 5 * 4 + 7 * 4
    assert a.collective_count["all-reduce"] == 2
    assert a.collective_bytes["all-gather"] == 3 * 5 * 4
    assert a.collective_bytes["reduce-scatter"] == 4 * 2 * 4
    assert a.total_collective_bytes == 60 + 28 + 60 + 32


def test_kernel_stand_ins_see_local_shapes():
    cfg = get_smoke("gemma2-2b")                  # 4 heads, 2 kv heads
    shape = ShapeSpec("p", "prefill", 32, 4)
    cell = cell_runtime(cfg, shape)
    one = dryrun.trace_cell(cfg, shape, cell)
    with dryrun.fake_world(4):
        quad = dryrun.trace_cell(cfg, shape, cell,
                                 dryrun.mesh_for("quad_2x2"))
    k1, k4 = one["op_analysis"], quad["op_analysis"]
    assert k4["kernel_calls"] == k1["kernel_calls"]
    f1, f4 = (k["kernel_flops"]["flash_attention"] for k in (k1, k4))
    assert f4 * 4 == pytest.approx(f1, rel=1e-12)


def _stacked_prefill(model, tokens, cap):
    """The previous prefill of the plain stack: each layer's k/v kept in a
    list, stacked into the cache at the end (the cache held twice)."""
    cfg = model.cfg
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None]
    x = model.embed["tokens"][tokens]
    ks, vs = [], []
    for blk in model.layers:
        x, kv = blk(x, positions=positions, window=cfg.sliding_window)
        ks.append(_pad_cap(kv[0], cap).to(torch.bfloat16))
        vs.append(_pad_cap(kv[1], cap).to(torch.bfloat16))
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    x = rmsnorm(x[:, -1:], model.final_norm["scale"], cfg.norm_eps)
    return unembed(x, model.embed, cfg)[:, 0], cache


def _peak(fn, *track):
    with OpAnalysis() as oa:
        oa.track(*track)
        fn()
    return oa.analysis.peak_bytes


def _prefill_peaks(n_layers, B=16, S=512):
    """(new peak, previous peak, stacked cache bytes, argument bytes) of a
    minicpm-shaped prefill of ``n_layers`` layers on ``meta``."""
    cfg = dataclasses.replace(get_smoke("minicpm-2b"), n_layers=n_layers)
    model = LM(cfg, device="meta")
    tokens = torch.empty((B, S), dtype=torch.int64, device="meta")
    cache_bytes = sum(2 * torch.Size(s).numel()
                      for s in cache_defs(cfg, B, S).values())
    args = sum(p.numel() * p.element_size() for p in model.parameters())
    new = _peak(lambda: prefill(model, tokens, capacity=S), model, tokens)
    old = _peak(lambda: _stacked_prefill(model, tokens, S), model, tokens)
    return new, old, cache_bytes, args + tokens.numel() * 8


def test_prefill_holds_its_cache_once():
    """The previous prefill ends holding 2x the stacked cache; this one
    holds it once plus one layer's transients (A, the excess of a 1-layer
    prefill over its own cache), so the peak drops by the cache less A."""
    new1, _, cache1, args1 = _prefill_peaks(1)
    A = new1 - args1 - cache1
    new, old, cache, args = _prefill_peaks(32)
    assert cache > 4 * A
    assert old - args >= 2 * cache
    assert new - args <= cache + A
    assert old - new >= cache - A, (old, new, cache, A)


def test_decode_makes_no_float32_copy_of_a_layer_cache():
    cfg = dataclasses.replace(get_smoke("minicpm-2b"), n_layers=2)
    model = LM(cfg, device="meta")
    B, cap = 1, 4 * DECODE_ROWS
    cache = init_cache(cfg, B, cap, device="meta")
    token = torch.empty((B,), dtype=torch.int64, device="meta")
    with OpAnalysis() as oa:
        oa.track(model, cache, token)
        decode_step(model, cache, token, cap - 1)
    a = oa.analysis
    layer_f32 = B * cap * cfg.n_kv_heads * cfg.head_dim * 4
    assert a.peak_bytes - a.argument_bytes < layer_f32


def test_constrain_redistributes_a_dtensor_and_leaves_a_tensor():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models.sharding import (NamedSharding, P, constrain,
                                             default_rules, tree_shardings)
    plain = torch.empty((4, 8), device="meta")
    with dryrun.fake_world(4):
        mesh = dryrun.mesh_for("quad_2x2")
        rules = default_rules(mesh)
        assert constrain(plain, ("batch", None), mesh, rules) is plain
        x = DTensor.from_local(torch.empty((4, 8), device="meta"), mesh,
                               [Replicate(), Replicate()], run_check=False)
        y = constrain(x, ("batch", "heads"), mesh, rules)
        assert list(y.placements) == [Shard(0), Shard(1)]
        assert y.to_local().shape == (2, 4)
        assert constrain(y, ("batch", "heads"), mesh, rules) is y
        tree = tree_shardings({"a": ("batch", None), "b": {"c": ("heads",)}},
                              {"a": (4, 3), "b": {"c": (6,)}}, mesh, rules)
        assert tree["a"] == NamedSharding(mesh, P("data"))
        assert tree["b"]["c"].spec == P("model")
        assert tree["b"]["c"].placements == [Replicate(), Shard(0)]
    assert not dist.is_initialized()


def test_dryrun_cli_on_quad_writes_records_and_tables_read_them(tmp_path,
                                                                 capsys):
    import json
    from repro_torch.bench import report, roofline as bench_roofline
    out = str(tmp_path)
    for shape in ("decode_32k", "long_500k"):
        assert dryrun.main(["--mesh", "quad", "--arch", "mamba2-1.3b",
                            "--shape", shape, "--out", out]) == 0
    assert dryrun.main(["--mesh", "quad", "--arch", "minicpm-2b", "--shape",
                        "long_500k", "--out", out]) == 0
    assert not dist.is_initialized()
    rec = json.loads((tmp_path / "quad_2x2" /
                      "mamba2-1.3b--decode_32k.json").read_text())
    assert rec["mesh"] == "quad_2x2" and rec["chips"] == 4
    assert rec["op_analysis"]["total_collective_bytes"] > 0
    assert rec["roofline"]["collective_s"] > 0
    capsys.readouterr()
    lines = bench_roofline.collect(root=out)["lines"]
    assert lines[0].startswith("roofline,mamba2-1.3b,decode_32k,")
    assert "| quad_2x2 | 2 | 1 | 0 |" in report.dryrun_summary(root=out)
    grid = report.fit_grid(out, "quad_2x2")
    assert "| mamba2-1.3b | — | — | **" in grid and "| skip |" in grid
    assert report.main(["--root", out]) == 0
    assert "coll/card" in capsys.readouterr().out
