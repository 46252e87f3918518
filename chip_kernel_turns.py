#!/usr/bin/env python3
"""Two builds of the port's kernels, timed in turns on one CUDA card.

    python3 chip_kernel_turns.py OLD_ROOT [flash] [flash_bwd] [gmm] [gmm_bwd]
                                 [saxpy] [ssd] [ssd_bwd] [nbody]

(no case named: all eight).  ``OLD_ROOT`` is the root of another checkout
of the repository (for example the parent commit, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists).  Its
``src/repro_torch/csrc`` is built with the same ``nvcc`` flags into
``OLD_ROOT/build/kernels``, this checkout's into ``build/kernels``.  Each
case then runs through each library's C entry points on the same inputs,
at the main paths' shapes: flash attention and the grouped GEMM in bf16
(zamba2-2.7b's and granite-moe-3b-a800m's 1536-token prefills, granite's
grouped GEMMs at a prefill and a decode step); the flash backward's
``flash_attention_bwd`` in bf16 at granite's training call (8, 24/8, 512,
64) and at zamba2's heads over 1536 tokens (1, 32/32, 1536, 80), causal,
both builds reading one forward's output and log-sum-exp; saxpy at one
accelerator slot's 2e7 float32 elements; the SSD scan at zamba2's call, x (1, 1536,
80 x 64), chunk 256, in float32 (as the model feeds it) and bf16, each
checkout's ``ssd_scan_fwd`` called with its own arguments, the two
builds' y and h compared bit for bit; the SSD backward's ``ssd_scan_bwd``
at zamba2's training call, x (8, 512, 80 x 64) float32, chunk 256, from
one forward's states and cum, each checkout's called with its own
arguments and scratch (a checkout without that entry point is timed as
autograd through the plain version, which is what the kernel replaced);
N-body at one
accelerator slot's targets against all bodies at the paper's three size
classes, float32, each checkout's ``nbody_acc_f32`` called with its own
arguments (the split design's scratch allocated once, outside the timed
calls).  Order: old, new, library call, new, old (saxpy: five rounds of
it, N-body three), CUDA-event means over ``REPS`` launches after a
warm-up.  The library call (``scaled_dot_product_attention``, for the
backward its gradient through ``torch.autograd.grad``; ``torch.bmm``,
``torch.add``; none for the SSD scan and N-body) is a yardstick only.  For
the flash backward each call's device time alone (``torch.profiler``, the
sum of its kernels) is taken too, since the SDPA backward's CUDA-event time
holds autograd's host dispatch.  Each build's output is held to the
plain version under ``chip_smoke.py``'s tolerances.  The host time of one
C call is timed too.

``gmm_bwd``: the grouped GEMM's gradients dx = dy w^T and dw = x^T dy in
bf16 at granite's training shapes (w_in (40, 1024, 1536, 512), w_out (40,
1024, 512, 1536)) and a ragged (4, 72, 1536, 512): the old build's path
(a contiguous transposed copy of w or x, then its forward kernel), the new
build's ``grouped_matmul_dx`` / ``grouped_matmul_dw`` (where it has them),
and ``torch.bmm`` on transposed views, each product alone and both
together beside the whole ``torch.bmm`` backward, in turns by CUDA events
and by device time (``torch.profiler``: GEMM and copy kernels apart), with
each product's share of its bound.  Then granite's training step at full
width (``chip_smoke.py``'s recipe) with ``ops._GroupedMatmul.backward``
as it was before the backward kernels (the copies; the forward kernel is
unchanged) and as it is: four steps from the same weights each (losses,
and the difference of the updated parameters relative to the update),
then steps in turns on one state (seconds, peak memory, device ms in the
grouped GEMM's kernels and in copy kernels).

Prints the card's name and power limit, one line a case, then one JSON
object, which is also written to ``build/kernel_turns.json``.  Exits
non-zero without a card.
"""
from __future__ import annotations

import ctypes
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

import chip_smoke as cs
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import nbody as nbody_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.kernels.flash_attention import NO_WINDOW

REPS = 50
PLAIN_REPS = 2          # a plain version's backward, where one is timed
#: (B, H, KV, S, hd) causal, bf16
FLASH = {"zamba2": (1, 32, 32, 1536, 80), "granite": (1, 24, 8, 1536, 64)}
#: (B, H, KV, S, hd) of the flash backward, causal, bf16: granite's
#: training call, and zamba2's heads over its longest prompt
FLASH_BWD = {"granite_train": (8, 24, 8, 512, 64),
             "zamba2_1536": (1, 32, 32, 1536, 80)}
#: (E, C, d, f), bf16
GMM = {"prefill_in": (40, 384, 1536, 512), "prefill_out": (40, 384, 512, 1536),
       "decode": (40, 8, 1536, 512)}
#: (E, C, d, f) of the grouped GEMM's backward, bf16: granite's w_in and
#: w_out at its training capacity, and a ragged capacity
GMM_BWD = {"w_in": (40, 1024, 1536, 512), "w_out": (40, 1024, 512, 1536),
           "ragged": (4, 72, 1536, 512)}
#: the backward kernels' entry points (a checkout before them has none)
GMM_BWD_ENTRIES = ("grouped_matmul_dx", "grouped_matmul_dw")
#: saxpy: one of chip_smoke.py's two accelerator slots' share (0.8 / 2) of
#: the paper's 5e7 elements
SAXPY_N = 2 * 10 ** 7
#: (Bsz, S, nh, hd, ds, chunk): zamba2-2.7b's SSD call at a 1536-token
#: prefill
SSD = (1, 1536, 80, 64, 64, 256)
#: (Bsz, S, nh, hd, ds, chunk): zamba2-2.7b's SSD call in training
SSD_BWD = (8, 512, 80, 64, 64, 256)
#: the cases, and how many times each runs the turn sequence
KINDS = ("flash", "flash_bwd", "gmm", "gmm_bwd", "saxpy", "ssd", "ssd_bwd",
         "nbody")
ROUNDS = {"saxpy": 5, "nbody": 3}


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


def flash_bwd_case(libs, B, H, KV, S, hd):
    """dq, dk, dv of each build's ``flash_attention_bwd`` from one forward's
    output and log-sum-exp, held to autograd through the plain version in
    float32 under ``chip_smoke.py``'s elementwise bound."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn((B, H, S, hd), generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn((B, KV, S, hd), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    o, lse = flash_mod.flash_attention_with_lse(q, k, v)
    xs = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(ref.attention_ref(*xs), xs, do.float())
    bounds = [cs.BWD_TOL * w.abs().max() + cs.BF16_STEP * w.abs() + r
              for w, r in zip(want, (*cs.attention_bwd_rounding(q, k, o, do),
                                     0.0))]
    stream = torch.cuda.current_stream().cuda_stream
    calls, errs = {}, {}
    for name, lib in libs.items():
        grads = [torch.empty_like(t) for t in (q, k, v)]
        D = torch.empty((B, H, S), device="cuda")

        def call(lib=lib, grads=grads, D=D, name=name):
            checked(lib.flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), *(t.data_ptr() for t in grads),
                D.data_ptr(), 1, B, H, KV, S, S, hd, *q.stride()[:3],
                *k.stride()[:3], 1.0 / math.sqrt(hd), 0.0, 1, NO_WINDOW, 0,
                stream), f"flash_attention_bwd ({name})")
        call()
        torch.cuda.synchronize()
        calls[name] = call
        errs[name] = max(((gr.float() - w).abs() / b).max().item()
                         for gr, w, b in zip(grads, want, bounds))
    sdpa = cs.backward_of(lambda *t: F.scaled_dot_product_attention(
        *t, is_causal=True, enable_gqa=KV != H), (q, k, v), do)
    bound = cs.flash_bwd_bound(B, H, KV, S, hd, torch.bfloat16)[0]
    return calls, errs, sdpa, bound


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


def copies_backward(ctx, dy):
    """``_GroupedMatmul.backward`` before the backward kernels: dx and dw
    through the forward kernel on contiguous transposed copies of w and
    x (the forward kernel's source is unchanged since)."""
    x, w = ctx.saved_tensors
    gmm = ctx.kern.grouped_matmul
    dy = dy.contiguous()
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx = gmm(dy, w.transpose(1, 2).contiguous(), backward=True)
    if ctx.needs_input_grad[1]:
        dw = gmm(x.transpose(1, 2).contiguous(), dy, backward=True)
    return dx, dw, None


def split_device_ms(fn):
    """Device ms a call of ``fn`` from ``torch.profiler``: its copy
    kernels, the rest (the products), and the kernels a call."""
    kernels = cs.profiled_kernels(fn)
    copies = sum(ms for k, (ms, _) in kernels.items()
                 if "copy" in k.lower())
    total = sum(ms for ms, _ in kernels.values())
    return dict(gemm=total - copies, copies=copies,
                kernels=sum(n for _, n in kernels.values()))


def gmm_bwd_case(libs, E, C, d, f):
    """dx = dy w^T and dw = x^T dy in bf16, each alone: the old build's
    transposed copy and forward kernel, the new build's backward kernels
    (where it has them), and ``torch.bmm`` on transposed views, each held
    to the plain version under ``GMM_TOL``.  Returns {product: (calls,
    errs, library call, bound)} and the whole ``torch.bmm`` backward."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((E, C, d), generator=g, device="cuda").bfloat16()
    w = (torch.randn((E, d, f), generator=g, device="cuda")
         * d ** -0.5).bfloat16()
    dy = torch.randn((E, C, f), generator=g, device="cuda").bfloat16()
    stream = torch.cuda.current_stream().cuda_stream
    old, new = libs["old"], libs["new"]
    dx_o, dx_n = (torch.empty_like(x) for _ in range(2))
    dw_o, dw_n = (torch.empty_like(w) for _ in range(2))

    def old_dx():
        wt = w.transpose(1, 2).contiguous()
        checked(old.grouped_matmul_fwd(dy.data_ptr(), wt.data_ptr(),
                                       dx_o.data_ptr(), 1, E, C, f, d, 0,
                                       stream), "grouped_matmul dx (old)")

    def old_dw():
        xt = x.transpose(1, 2).contiguous()
        checked(old.grouped_matmul_fwd(xt.data_ptr(), dy.data_ptr(),
                                       dw_o.data_ptr(), 1, E, d, C, f, 0,
                                       stream), "grouped_matmul dw (old)")

    def new_dx():
        checked(new.grouped_matmul_dx(dy.data_ptr(), w.data_ptr(),
                                      dx_n.data_ptr(), E, C, d, f, 0,
                                      stream), "grouped_matmul_dx (new)")

    def new_dw():
        checked(new.grouped_matmul_dw(x.data_ptr(), dy.data_ptr(),
                                      dw_n.data_ptr(), E, C, d, f, 0,
                                      stream), "grouped_matmul_dw (new)")
    has_new = hasattr(new, "grouped_matmul_dx")
    cases = {}
    for name, want, o, n, outs, lib_call, bound in (
            ("dx", ref.grouped_matmul_dx_ref(dy, w), old_dx, new_dx,
             (dx_o, dx_n), lambda: torch.bmm(dy, w.transpose(1, 2)),
             cs.gmm_bound(E, C, f, d, torch.bfloat16)[0]),
            ("dw", ref.grouped_matmul_dw_ref(x, dy), old_dw, new_dw,
             (dw_o, dw_n), lambda: torch.bmm(x.transpose(1, 2), dy),
             cs.gmm_bound(E, d, C, f, torch.bfloat16)[0])):
        calls = {"old": o, "new": n if has_new else None}
        scale = want.float().abs().max().item()
        errs = {}
        for side, out in zip(("old", "new"), outs):
            if calls[side] is None:
                continue
            calls[side]()
            torch.cuda.synchronize()
            errs[side] = cs.bf16_excess(out, want, cs.GMM_TOL * scale)
        cases[name] = (calls, errs, lib_call, bound)
    both = {"old": lambda: (old_dx(), old_dw()),
            "new": (lambda: (new_dx(), new_dw())) if has_new else None}
    bmm_bwd = cs.backward_of(torch.bmm, (x, w), dy)
    return cases, both, bmm_bwd, cs.gmm_bwd_bound(E, C, d, f,
                                                  torch.bfloat16)[0]


def gmm_bwd_rows(libs):
    """Each GMM_BWD shape: dx and dw alone and together, old, new and
    ``torch.bmm`` in turns by CUDA events, and by device time (GEMM and
    copy kernels apart), with each product's share of its bound."""
    out = {}
    for shape_name, shape in GMM_BWD.items():
        cases, both, bmm_bwd, bound = gmm_bwd_case(libs, *shape)
        row = {"shape": list(shape)}
        for prod, (calls, errs, lib_call, pbound) in cases.items():
            for side, e in errs.items():
                if e > 1.0:
                    raise RuntimeError(f"gmm_bwd {shape_name} {prod} "
                                       f"({side}): worst element at "
                                       f"{e:.3f} of its bound")
            t = [cs.cuda_ms(c, REPS) if c else None
                 for c in (calls["old"], calls["new"], lib_call,
                           calls["new"], calls["old"])]
            dev = {side: split_device_ms(c) for side, c in
                   (*calls.items(), ("bmm", lib_call)) if c is not None}
            new_ms = [v for v in (t[1], t[3]) if v is not None]
            r = dict(old_ms=[t[0], t[4]], new_ms=new_ms, bmm_ms=t[2],
                     bound_ms=pbound, device_ms=dev,
                     worst_share_of_bound=errs,
                     new_share_of_bound=(pbound / min(new_ms) if new_ms
                                         else None),
                     new_device_share_of_bound=(
                         pbound / dev["new"]["gemm"] if "new" in dev
                         and dev["new"]["gemm"] else None))
            row[prod] = r
            print(f"gmm_bwd {shape_name} {list(shape)} {prod}: old "
                  f"{t[0]:.4f}/{t[4]:.4f} ms (device {dev['old']}), new "
                  + ("/".join(f"{v:.4f}" for v in new_ms) + " ms (device "
                     f"{dev['new']})" if new_ms else "none")
                  + f", bmm {t[2]:.4f} ms (device {dev['bmm']}), bound "
                  f"{pbound:.4f} ms, new at {r['new_share_of_bound']} of it "
                  f"(device {r['new_device_share_of_bound']})", flush=True)
        t = [cs.cuda_ms(c, REPS) if c else None
             for c in (both["old"], both["new"], bmm_bwd, both["new"],
                       both["old"])]
        dev = {side: split_device_ms(c) for side, c in
               (*both.items(), ("bmm_backward", bmm_bwd)) if c is not None}
        new_ms = [v for v in (t[1], t[3]) if v is not None]
        row["dx_dw"] = dict(old_ms=[t[0], t[4]], new_ms=new_ms,
                            bmm_backward_ms=t[2], bound_ms=bound,
                            device_ms=dev)
        print(f"gmm_bwd {shape_name} dx + dw: old {t[0]:.4f}/{t[4]:.4f} ms "
              f"(device {dev['old']}), new "
              + ("/".join(f"{v:.4f}" for v in new_ms)
                 + f" ms (device {dev['new']})" if new_ms else "none")
              + f", torch.bmm backward {t[2]:.4f} ms (device "
              f"{dev['bmm_backward']}), bound {bound:.4f} ms", flush=True)
        out[shape_name] = row
    return out


def step_params(model):
    """The model's parameters, copied to the host."""
    return {k: p.detach().to("cpu", copy=True)
            for k, p in model.named_parameters()}


def granite_steps(backward, steps: int):
    """``steps`` training steps of granite at full width from seed 0
    (``chip_smoke.py``'s recipe and batches) with ``backward`` as the
    grouped GEMM's backward: the losses, the parameters before and
    after (on the host), and the model, optimizer state and step."""
    cfg = cs.get_config(cs.TRAIN_ARCH)
    ops._GroupedMatmul.backward = staticmethod(backward)
    model = cs.build_model(cfg)
    before = step_params(model)
    opt = cs.build_optimizer(cfg, cs.TRAIN_LR, cs.TRAIN_STEPS)
    state = cs.init_state(model, opt)
    step_fn = cs.make_train_step(cfg, opt, cs.RuntimeConfig(
        microbatches=1, remat=cs.TRAIN_REMAT, loss_chunks=1,
        aux_weight=0.01))
    dc = cs.DataConfig(vocab=cfg.vocab, seq_len=cs.TRAIN_SEQ,
                       global_batch=cs.TRAIN_BATCH, seed=0)
    losses = []
    for i in range(steps):
        state, metrics = step_fn(state, cs.batch_at(dc, i))
        losses.append(float(metrics["loss"]))
    return losses, before, step_params(model), (model, state, step_fn, dc)


def gmm_bwd_step():
    """granite's training step with the transposed copies (old) and with
    the backward kernels (new): TRAIN_STEPS steps from the same weights
    each, the losses and the updated parameters compared (the difference
    of the two updates by parameter group, relative to the old update's
    L2 norm); then steps in turns (old, new, new, old, three each after a
    warm-up of each) on the new run's state: host seconds, peak memory,
    and one profiled step each, device ms in the grouped GEMM's kernels
    and in copy kernels."""
    kernel_backward = ops._GroupedMatmul.backward
    sides = {"old": copies_backward, "new": kernel_backward}
    losses, params = {}, {}
    for side in ("old", "new"):
        losses[side], init, params[side], live = granite_steps(
            sides[side], cs.TRAIN_STEPS)
        if side == "old":
            del live
            gc.collect()
            torch.cuda.empty_cache()
    model, state, step_fn, dc = live
    groups = {}
    for k, p in init.items():
        new, old = params["new"][k].float(), params["old"][k].float()
        num, den = groups.get(cs.grad_group(k), (0.0, 0.0))
        groups[cs.grad_group(k)] = (num + float(((new - old) ** 2).sum()),
                                    den + float(((old - p.float()) ** 2)
                                                .sum()))
    update_rel = {grp: math.sqrt(n / d) if d else 0.0
                  for grp, (n, d) in groups.items()}
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["new"], losses["old"]))
    print(f"gmm_bwd step: losses old {losses['old']}, new {losses['new']} "
          f"(largest relative difference {loss_rel:.3g}); the updates' "
          f"difference relative to the old update, by group: {update_rel}",
          flush=True)
    del init, params
    gc.collect()
    batch = cs.batch_at(dc, 0)

    def one_step(side):
        nonlocal state
        ops._GroupedMatmul.backward = staticmethod(sides[side])
        state, _ = step_fn(state, batch)

    timed, peak = {"old": [], "new": []}, {}
    for side in ("old", "new", "old", "new", "new", "old"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            one_step(side)
        torch.cuda.synchronize()
        if len(peak) == 2:                # the first two: warm-up
            timed[side].append((time.perf_counter() - t0) / 3)
        peak[side] = torch.cuda.max_memory_allocated()
    device = {}
    for side in ("old", "new"):
        kernels = cs.profiled_kernels(lambda: one_step(side), 1)

        def of(test):
            return (sum(ms for k, (ms, _) in kernels.items() if test(k)),
                    sum(n for k, (_, n) in kernels.items() if test(k)))
        device[side] = dict(
            gemm_ms_launches=of(lambda k: "gmm" in k),
            copy_ms_launches=of(lambda k: "copy" in k.lower()),
            busy_ms=sum(ms for ms, _ in kernels.values()))
    ops._GroupedMatmul.backward = staticmethod(kernel_backward)
    print(f"gmm_bwd step in turns (old, new, new, old; s a step, 3 steps "
          f"each): old {timed['old']}, new {timed['new']}; peak GiB "
          f"{ {k: v / 2 ** 30 for k, v in peak.items()} }; device a step "
          f"(ms, launches) {device}", flush=True)
    del model, state, live
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, loss_rel_diff=loss_rel,
                update_rel_diff=update_rel, step_s=timed,
                peak_memory_bytes=peak, device=device)


def saxpy_case(libs, n):
    """saxpy at one accelerator slot's share of the paper's 5e7 elements,
    against ``torch.add(y, x, alpha=a)``."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, generator=g, device="cuda")
    y = torch.randn(n, generator=g, device="cuda")
    a = 2.5
    want = torch.add(y, x, alpha=a)
    stream = torch.cuda.current_stream().cuda_stream
    calls, errs = {}, {}
    for name, lib in libs.items():
        z = torch.empty_like(x)

        def call(lib=lib, z=z, name=name):
            checked(lib.saxpy_f32(x.data_ptr(), y.data_ptr(), z.data_ptr(),
                                  a, n, 0, stream), f"saxpy ({name})")
        call()
        torch.cuda.synchronize()
        # within 1e-5 of torch.add, relative to 1e-5 (the card checks')
        calls[name] = call
        errs[name] = (z - want).abs().max().item() / 1e-5
    bound = cs.bound_ms(12.0 * n, 2.0 * n)[0]
    return calls, errs, (lambda: torch.add(y, x, alpha=a)), bound


def ssd_entry(lib, root: Path):
    """The ``ssd_scan_fwd`` of a library built from ``root``'s sources,
    with that checkout's own argument types: since the chunk-parallel
    design the entry point also takes three scratch tensors (states, cb,
    cum) after ``h_out``; before it, none."""
    text = (root / "src" / "repro_torch" / "csrc" / "ssd_scan.cu").read_text()
    decl = text[text.index('extern "C" int ssd_scan_fwd'):]
    scratch = "states" in decl[:decl.index(")")]
    fn = lib.ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * (11 if scratch else 8)
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, scratch


def ssd_case(entries, Bsz, S, nh, hd, ds, chunk, dtype):
    """zamba2's SSD call at a 1536-token prefill: x (1, 1536, 80 x 64),
    d_state 64, chunk 256, as the model feeds it (float32), and in bf16."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn((Bsz, S, nh * hd), generator=g, device="cuda")
         * 0.5).to(dtype)
    dt = F.softplus(torch.randn((Bsz, S, nh), generator=g, device="cuda"))
    Bm = (torch.randn((Bsz, S, ds), generator=g, device="cuda") * 0.5).to(
        dtype)
    Cm = (torch.randn((Bsz, S, ds), generator=g, device="cuda") * 0.5).to(
        dtype)
    A = -torch.exp(torch.randn(nh, generator=g, device="cuda") * 0.3)
    wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=chunk)
    sy = max(1.0, wy.float().abs().max().item())
    sh = max(1.0, wh.abs().max().item())
    stream = torch.cuda.current_stream().cuda_stream
    calls, errs, outs = {}, {}, {}
    for name, (fn, scratch) in entries.items():
        y = torch.empty_like(x)
        h = torch.empty((Bsz, nh, ds, hd), device="cuda")
        extra = []
        if scratch:
            extra = ssd_mod.scratch(Bsz, S, nh, hd, ds, chunk, "cuda")

        def call(fn=fn, y=y, h=h, extra=extra, name=name):
            checked(fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
                       Cm.data_ptr(), A.data_ptr(), None, y.data_ptr(),
                       h.data_ptr(), *(t.data_ptr() for t in extra),
                       _build.DTYPE_CODES[dtype], Bsz, S, nh, hd, ds, chunk, 0,
                       stream), f"ssd_scan ({name})")
        call()
        torch.cuda.synchronize()
        # y elementwise within one bf16 step (bf16 only) plus SSD_TOL x
        # max(1, max |y|); h within SSD_TOL x max(1, max |h|)
        ey = (cs.bf16_excess(y, wy, cs.SSD_TOL * sy) if dtype != torch.float32
              else (y - wy).abs().max().item() / (cs.SSD_TOL * sy))
        eh = (h - wh).abs().max().item() / (cs.SSD_TOL * sh)
        calls[name], errs[name] = call, max(ey, eh)
        outs[name] = (y, h)
    # the two builds' y and h, bit for bit (a change that moves code
    # between the sources must not move a bit)
    same = all(torch.equal(a, b) for a, b in zip(outs["old"], outs["new"]))
    bound = cs.ssd_bound(Bsz, S, chunk, nh, hd, ds, dtype)[0]
    return calls, errs, None, bound, same


def ssd_bwd_entry(lib, root: Path):
    """The ``ssd_scan_bwd`` of a library built from ``root``'s sources,
    with that checkout's own argument types (read from its C declaration)
    and its own scratch (its ``kernels/ssd_scan.py``'s ``bwd_scratch``, and
    ``head_groups`` where it has one); None where it has no backward."""
    if not hasattr(lib, "ssd_scan_bwd"):
        return None
    csrc = root / "src" / "repro_torch"
    text = (csrc / "csrc" / "ssd_scan_bwd.cu").read_text()
    decl = text[text.index('extern "C" int ssd_scan_bwd'):]
    params = decl[decl.index("(") + 1:decl.index(")")].split(",")
    fn = lib.ssd_scan_bwd
    fn.argtypes = [ctypes.c_void_p if "*" in p or "cudaStream_t" in p
                   else ctypes.c_int for p in params]
    fn.restype = ctypes.c_int
    spec = importlib.util.spec_from_file_location(
        f"ssd_scan_of_{abs(hash(str(root)))}",
        csrc / "kernels" / "ssd_scan.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return fn, mod


def ssd_bwd_case(entries, Bsz, S, nh, hd, ds, chunk):
    """zamba2's SSD backward in training, float32, every gradient held to
    autograd through the plain version under ``chip_smoke.SSD_BWD_TOL``;
    a build without the entry point is timed as that autograd call."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((Bsz, S, nh * hd), generator=g, device="cuda") * 0.5
    dt = F.softplus(torch.randn((Bsz, S, nh), generator=g, device="cuda"))
    Bm = torch.randn((Bsz, S, ds), generator=g, device="cuda") * 0.5
    Cm = torch.randn((Bsz, S, ds), generator=g, device="cuda") * 0.5
    A = -torch.exp(torch.randn(nh, generator=g, device="cuda") * 0.3)
    dy = torch.randn(x.shape, generator=g, device="cuda")
    main = (x, dt, Bm, Cm, A)
    want = cs.ssd_grads(ref.ssd_scan_ref, main, None, dy, None, chunk)
    _, _, states, cum = ssd_mod.ssd_scan_with_states(*main, chunk=chunk)
    plain = cs.backward_of(lambda *t, chunk: ref.ssd_scan_ref(
        *t, chunk=chunk)[0], main, dy, chunk=chunk)
    plain.plain = True          # timed over PLAIN_REPS, no host timing
    stream = torch.cuda.current_stream().cuda_stream
    calls, errs = {}, {}
    for name, entry in entries.items():
        if entry is None:
            calls[name], errs[name] = plain, 0.0
            continue
        fn, mod = entry
        grads = [torch.empty_like(t) for t in main]
        if hasattr(mod, "head_groups"):
            groups = [mod.head_groups(nh)]
            buf, parts = mod.bwd_scratch(Bsz, S, nh, hd, ds, chunk,
                                         *groups, "cuda")
        else:
            groups = []
            buf, parts = mod.bwd_scratch(Bsz, S, nh, hd, ds, chunk, "cuda")

        def call(fn=fn, grads=grads, parts=parts, buf=buf, name=name,
                 groups=groups):
            checked(fn(*(t.data_ptr() for t in (*main, states, cum, dy)),
                       None, *(t.data_ptr() for t in grads), None, *parts,
                       Bsz, S, nh, hd, ds, chunk, *groups, 0, stream),
                    f"ssd_scan_bwd ({name})")
        call()
        torch.cuda.synchronize()
        calls[name] = call
        errs[name] = max((gr - w).abs().max().item()
                         / (cs.SSD_BWD_TOL * w.abs().max().item())
                         for gr, w in zip(grads, want))
    bound = cs.ssd_bwd_bound(Bsz, S, chunk, nh, hd, ds)[0]
    return calls, errs, None, bound


def nbody_entry(lib, root: Path):
    """The ``nbody_acc_f32`` of a library built from ``root``'s sources,
    with that checkout's own argument types: since the source-split design
    the entry point also takes the scratch, the splits and the split length
    after ``softening``; before it, none."""
    text = (root / "src" / "repro_torch" / "csrc" / "nbody.cu").read_text()
    decl = text[text.index('extern "C" int nbody_acc_f32'):]
    split = "scratch" in decl[:decl.index(")")]
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.nbody_acc_f32
    fn.argtypes = ([P, I, P, P, I, P, ctypes.c_float]
                   + ([P, I, I] if split else []) + [I, P])
    fn.restype = ctypes.c_int
    return fn, split


def nbody_case(entries, n_i, n_j):
    """One slot's ``n_i`` targets against all ``n_j`` bodies, float32, held
    to float64 under ``NBODY_TOL``."""
    g = torch.Generator(device="cuda").manual_seed(0)
    pos = torch.randn((n_j, 3), generator=g, device="cuda")
    mass = torch.rand(n_j, generator=g, device="cuda") + 0.1
    tgt = pos[:n_i]
    want = ref.nbody_ref(pos.double(), mass.double(), targets=tgt.double())
    scale = cs.NBODY_TOL * want.abs().max().item()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = nbody_mod.launch_plan(n_i, n_j, sms)
    stream = torch.cuda.current_stream().cuda_stream
    calls, errs = {}, {}
    for name, (fn, split) in entries.items():
        acc = torch.empty_like(tgt)
        scratch = torch.empty(
            (nbody_mod.scratch_rows(n_i, n_j, plan.splits), 4),
            device="cuda") if split else None

        def call(fn=fn, acc=acc, scratch=scratch, name=name):
            extra = ([] if scratch is None else
                     [scratch.data_ptr(), plan.splits, plan.split_len])
            checked(fn(tgt.data_ptr(), n_i, pos.data_ptr(), mass.data_ptr(),
                       n_j, acc.data_ptr(), nbody_mod.SOFTENING, *extra, 0,
                       stream), f"nbody ({name})")
        call()
        torch.cuda.synchronize()
        calls[name] = call
        errs[name] = (acc.double() - want).abs().max().item() / scale
    bound = cs.bound_ms(24.0 * n_i + 16.0 * n_j, 20.0 * n_i * n_j)[0]
    return calls, errs, None, bound


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    old_root = Path(sys.argv[1]).resolve()
    kinds = sys.argv[2:] or list(KINDS)
    unknown = set(kinds) - set(KINDS)
    if unknown:
        print(f"unknown cases {sorted(unknown)}; known: {list(KINDS)}",
              file=sys.stderr)
        return 2
    card = cs.gpu_line()
    print(card, flush=True)
    names = ("flash_attention_fwd", "flash_attention_bwd",
             "grouped_matmul_fwd", "saxpy_f32")
    new_lib = _build.build()
    bwd = tuple(n for n in GMM_BWD_ENTRIES
                if hasattr(ctypes.CDLL(str(new_lib)), n))
    libs = {"old": _build.load(_build.build(
                old_root / "src" / "repro_torch" / "csrc",
                old_root / "build" / "kernels"), names),
            "new": _build.load(new_lib, names + bwd)}
    out = {"card": card, "torch": torch.__version__, "reps": REPS,
           "order": "old, new, library, new, old (ROUNDS[kind] times)",
           **{k: {} for k in kinds}}
    if "gmm_bwd" in kinds:
        out["gmm_bwd"] = gmm_bwd_rows(libs)
        out["gmm_bwd"]["granite_step"] = gmm_bwd_step()
    cases = []
    if "flash" in kinds:
        cases += [("flash", n, flash_case(libs, *shape), shape)
                  for n, shape in FLASH.items()]
    if "flash_bwd" in kinds:
        cases += [("flash_bwd", n, flash_bwd_case(libs, *shape), shape)
                  for n, shape in FLASH_BWD.items()]
    if "gmm" in kinds:
        cases += [("gmm", n, gmm_case(libs, *shape), shape)
                  for n, shape in GMM.items()]
    if "saxpy" in kinds:
        cases += [("saxpy", "slot", saxpy_case(libs, SAXPY_N), (SAXPY_N,))]
    if "ssd" in kinds:
        entries = {"old": ssd_entry(libs["old"], old_root),
                   "new": ssd_entry(libs["new"], cs.ROOT)}
        cases += [("ssd", name, ssd_case(entries, *shape, dtype), shape)
                  for name, dtype in (("f32", torch.float32),
                                      ("bf16", torch.bfloat16))
                  for shape in [SSD]]
    if "ssd_bwd" in kinds:
        entries = {"old": ssd_bwd_entry(libs["old"], old_root),
                   "new": ssd_bwd_entry(libs["new"], cs.ROOT)}
        cases += [("ssd_bwd", "train", ssd_bwd_case(entries, *SSD_BWD),
                   SSD_BWD)]
    if "nbody" in kinds:
        entries = {"old": nbody_entry(libs["old"], old_root),
                   "new": nbody_entry(libs["new"], cs.ROOT)}
        cases += [("nbody", f"{n_i}x{n_j}", nbody_case(entries, n_i, n_j),
                   (n_i, n_j)) for n_i, n_j in cs.NBODY_SLOTS]
    for kind, name, case, shape in cases:
        calls, errs, lib_call, bound = case[:4]
        for n, e in errs.items():
            if e > 1.0:
                raise RuntimeError(f"{kind} {name} ({n}): worst element at "
                                   f"{e:.3f} of its bound")
        old, new, lib = [], [], []
        for _ in range(ROUNDS.get(kind, 1)):
            t = [cs.cuda_ms(c, PLAIN_REPS if getattr(c, "plain", False)
                            else REPS) if c else None
                 for c in (calls["old"], calls["new"], lib_call,
                           calls["new"], calls["old"])]
            old += [t[0], t[4]]
            new += [t[1], t[3]]
            lib.append(t[2])
        r = dict(shape=list(shape), old_ms=old, new_ms=new,
                 library_ms=lib if len(lib) > 1 else lib[0],
                 bound_ms=bound,
                 worst_share_of_bound=errs,
                 host_us={n: cs.host_us(c) for n, c in calls.items()
                          if not getattr(c, "plain", False)})
        if kind == "gmm":
            r["new_tb_per_s"] = case[4] / (min(new) * 1e-3) / 1e12
        if kind == "ssd":
            r["bit_identical"] = case[4]
        if kind in ("flash_bwd", "ssd_bwd"):
            # (ms, kernels a call) of each
            r["device_ms"] = {n: cs.device_ms(c) for n, c in
                              (*calls.items(), ("library", lib_call))
                              if c is not None}
        out[kind][name] = r
        print(f"{kind} {name} {list(shape)}: old "
              f"{'/'.join(f'{v:.4f}' for v in old)} ms, new "
              f"{'/'.join(f'{v:.4f}' for v in new)} ms, library "
              f"{'/'.join(f'{v:.4f}' for v in lib if v is not None)} ms, "
              f"bound {bound:.4f} "
              f"ms; host {r['host_us']} us a call"
              + (f"; device time alone {r['device_ms']} ms"
                 if "device_ms" in r else "")
              + (f"; old and new y, h bit-identical: {r['bit_identical']}"
                 if "bit_identical" in r else ""), flush=True)
    (cs.ROOT / "build").mkdir(exist_ok=True)
    (cs.ROOT / "build" / "kernel_turns.json").write_text(json.dumps(out,
                                                                   indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
