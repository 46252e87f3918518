#!/usr/bin/env python3
"""Training steps at the reference's train_4k runtime with the microbatch
accumulation as one kernel launch a microbatch against the eager loop it
replaced, in turns, on one CUDA card.

    python3 chip_grad_accum.py [ARCH ...]

(no arch named: the six that train on one card: granite-moe-3b-a800m,
zamba2-2.7b, mamba2-1.3b, minicpm-2b, gemma2-2b, whisper-large-v3).  Each
arch is built at full width and depth with ``chip_smoke.py``'s recipe
(bf16 parameters, float32 moments, random weights from seed 0, the
launcher's optimizer) and trained with the runtime the reference gives
its train_4k cell (``cell_runtime``: 4 microbatches for these sizes, remat
"full" one layer a unit, 8 loss chunks where the vocabulary has 16000 or
more; no mesh) on one data-parallel rank's share of train_4k: 4 rows of
4096 tokens a step, one a microbatch (whisper: its ``chip_smoke.py``
shape, 8 x 448 tokens over 8 x 1500 frames, at 4 microbatches).

Sides: ``kernel``, the port's ``_accumulate_grads`` (``ops.grad_accumulate``
on the card: ``csrc/grad_accum.cu``); ``eager``, the loop it replaced,
kept below as it was (float32 zeros, ``+= g.float()`` a tensor a
microbatch with the previous microbatch's gradients alive through the
next backward, a scaled copy at the end), patched into
``runtime.train``.  Turns in the order eager, kernel, kernel, eager,
each from one state (the model rebuilt from seed 0, fresh moments) and
STEPS steps long: seconds a step after the turn's first (host clock
around steps that end in ``torch.cuda.synchronize``), the turn's peak
memory (``max_memory_allocated`` after a reset), every step's loss and
gradient norm (held the same bits across all turns); after each side's
first turn one profiled step (``torch.profiler``): the accumulation's
device ms (the device activity of the ops inside its
``record_function`` ranges, and the kernel by its name), its span by
CUDA events, the step's kernel launches and device busy ms.  A side
that does not fit on the card is reported as such.  Prints the card's
name and power limit, one line an arch, then one JSON object, also
written to
``build/grad_accum_steps.json``.  Exits non-zero without a card or when
a turn's losses or norms differ.
"""
from __future__ import annotations

import gc
import json
import sys
import time

import torch
from torch.profiler import record_function

import chip_smoke as cs
from repro_torch.configs import SHAPES
from repro_torch.kernels import ops
from repro_torch.launch.cells import cell_runtime
from repro_torch.runtime import train as train_mod

ARCHS = ("granite-moe-3b-a800m", "zamba2-2.7b", "mamba2-1.3b", "minicpm-2b",
         "gemma2-2b", "whisper-large-v3")
ROWS, SEQ = 4, 4096  # one data-parallel rank's share of train_4k
STEPS = 3            # steps a turn; the first not timed
ORDER = ("eager", "kernel", "kernel", "eager")
RANGE = "grad_accumulation"   # the record_function range of both sides

KERNEL_ACCUMULATE = train_mod._accumulate_grads
OPS_ACCUMULATE = ops.grad_accumulate
#: CUDA events around each accumulation range of the profiled step
SPANS = []


class span:
    """A ``record_function`` range named RANGE with a pair of CUDA events
    around it (kept in SPANS)."""

    def __enter__(self):
        self.rf = record_function(RANGE)
        self.rf.__enter__()
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        SPANS.append((self.start, end))
        self.rf.__exit__(*exc)


def ranged_accumulate(*a, **kw):
    with span():
        return OPS_ACCUMULATE(*a, **kw)


def eager_accumulate_grads(loss_fn, model, batch, rt):
    """The port's accumulation before the kernel, as it was (the eager
    loop of ``runtime/train.py``), with its work in RANGE ranges."""
    params = dict(model.named_parameters())
    tokens, labels = batch["tokens"], batch["labels"]
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    M, B = rt.microbatches, tokens.shape[0]
    if M <= 1 or B % M:
        return train_mod._grads(loss_fn, model, params, tokens, labels,
                                extras)
    n = B // M
    with span():
        g_acc = {k: torch.zeros_like(train_mod.spmd.block(p),
                                     dtype=torch.float32)
                 for k, p in params.items()}
    l_acc = a_acc = 0.0
    for i in range(M):
        part = slice(i * n, (i + 1) * n)
        g, loss, aux = train_mod._grads(loss_fn, model, params, tokens[part],
                                        labels[part],
                                        {k: v[part] for k, v in
                                         extras.items()})
        with span():
            for k in g_acc:
                g_acc[k] += g[k].float()
        l_acc, a_acc = l_acc + loss, a_acc + aux
    inv = 1.0 / M
    with span():
        out = {k: v * inv for k, v in g_acc.items()}
    return out, l_acc * inv, a_acc * inv


def use(side: str) -> None:
    """The accumulation of ``runtime.train``'s step: the kernel's or the
    eager loop's, each in RANGE ranges."""
    train_mod._accumulate_grads = (eager_accumulate_grads if side == "eager"
                                   else KERNEL_ACCUMULATE)
    ops.grad_accumulate = ranged_accumulate


def restore() -> None:
    train_mod._accumulate_grads = KERNEL_ACCUMULATE
    ops.grad_accumulate = OPS_ACCUMULATE


def runtime_of(cfg):
    cell = cell_runtime(cfg, SHAPES["train_4k"])
    return cs.RuntimeConfig(microbatches=cell.microbatches, remat=cell.remat,
                            remat_group=cell.remat_group,
                            remat_inner=cell.remat_inner,
                            loss_chunks=cell.loss_chunks, aux_weight=0.01)


def batches(cfg):
    rows, seq = ((cs.TRAIN_BATCH, cs.WHISPER_CAPACITY) if cfg.enc_dec
                 else (ROWS, SEQ))
    dc = cs.DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=rows,
                       seed=0)
    extras = cs.train_extras(cfg, rows)
    return [{**cs.batch_at(dc, i), **extras} for i in range(STEPS + 1)], \
        rows * seq


def profiled(step) -> dict:
    """One step under ``torch.profiler``: the accumulation's device ms (the
    device activity launched inside RANGE ranges), its span by CUDA events,
    the step's kernel launches and device busy ms."""
    from torch.profiler import ProfilerActivity, profile
    SPANS.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.events()

    def device_us(e):
        return sum(k.duration for k in e.kernels) + sum(
            device_us(c) for c in e.cpu_children)

    ranges = [e for e in events if e.name == RANGE
              and e.device_type == torch.autograd.DeviceType.CPU]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # the profiler ties the device activity of PyTorch's own ops to the
    # range around them, not a kernel launched through ctypes: the
    # accumulation's kernel is taken by its name
    ours = sum(cs.kernel_device_us(e) for e in kernels
               if "accumulate_chunks" in e.key)
    return dict(accum_device_ms=(sum(device_us(e) for e in ranges)
                                 + ours) / 1e3,
                accum_ranges=len(ranges),
                accum_span_ms=sum(a.elapsed_time(b) for a, b in SPANS),
                launches=sum(e.count for e in kernels),
                busy_ms=sum(cs.kernel_device_us(e) for e in kernels) / 1e3)


def turn(cfg, rt, side: str, data, tokens: int, profile: bool):
    """STEPS steps from the state built from seed 0 with ``side``'s
    accumulation, then with ``profile`` one profiled step; a record of
    ``fits`` False where it does not fit."""
    model = opt = state = None
    try:
        use(side)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = cs.build_model(cfg)
        opt = cs.build_optimizer(cfg, cs.TRAIN_LR, cs.TRAIN_STEPS)
        state = cs.init_state(model, opt)
        step_fn = cs.make_train_step(cfg, opt, rt)
        metrics, seconds = [], []
        for b in data[:STEPS]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, b)
            m = {k: float(m[k]) for k in ("loss", "grad_norm")}
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            metrics.append(m)
        peak = torch.cuda.max_memory_allocated()

        def step():
            nonlocal state
            state, _ = step_fn(state, data[STEPS])
        return dict(seconds=seconds[1:], first_s=seconds[0], metrics=metrics,
                    peak_bytes=peak, tokens_per_s=tokens / min(seconds[1:]),
                    **(profiled(step) if profile else {}))
    except torch.OutOfMemoryError as e:
        return dict(fits=False, error=str(e).splitlines()[0])
    finally:
        restore()
        del model, opt, state
        gc.collect()
        torch.cuda.empty_cache()


def arch_turns(arch: str):
    cfg = cs.get_config(arch)
    rt = runtime_of(cfg)
    data, tokens = batches(cfg)
    # one profiled step a side, after its first turn
    turns = [(side, turn(cfg, rt, side, data, tokens,
                         profile=side not in ORDER[:i]))
             for i, side in enumerate(ORDER)]
    fit = [(s, t) for s, t in turns if t.get("fits", True)]
    same = all(t["metrics"] == fit[0][1]["metrics"] for _, t in fit)
    by_side = {side: [t for s, t in turns if s == side] for side in
               ("eager", "kernel")}

    def col(side, key):
        return [t[key] for t in by_side[side] if key in t]
    out = dict(runtime=dict(microbatches=rt.microbatches, remat=rt.remat,
                            remat_group=rt.remat_group,
                            loss_chunks=rt.loss_chunks),
               tokens_a_step=tokens, turns=[dict(side=s, **t)
                                            for s, t in turns],
               same_bits=same, metrics=fit[0][1]["metrics"] if fit else None)
    print(f"grad_accum steps {arch} (microbatches {rt.microbatches}, remat "
          f"{rt.remat}, {rt.loss_chunks} loss chunks, {tokens} tokens a "
          f"step; in turns eager, kernel, kernel, eager): s a step eager "
          f"{col('eager', 'seconds')}, kernel {col('kernel', 'seconds')}; "
          f"peak bytes eager {col('eager', 'peak_bytes')}, kernel "
          f"{col('kernel', 'peak_bytes')}; the accumulation's device ms in "
          f"one profiled step eager {col('eager', 'accum_device_ms')}, "
          f"kernel {col('kernel', 'accum_device_ms')} (its span by CUDA "
          f"events eager {col('eager', 'accum_span_ms')}, kernel "
          f"{col('kernel', 'accum_span_ms')}); the step's launches eager "
          f"{col('eager', 'launches')}, kernel {col('kernel', 'launches')}; "
          f"device busy ms eager {col('eager', 'busy_ms')}, kernel "
          f"{col('kernel', 'busy_ms')}; losses and gradient norms the same "
          f"bits in every turn that fit: {same} "
          f"({out['metrics']}); did not fit: "
          f"{[s for s, t in turns if not t.get('fits', True)]}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_grad_accum: no CUDA device", file=sys.stderr)
        return 2
    archs = sys.argv[1:] or list(ARCHS)
    unknown = set(archs) - set(ARCHS)
    if unknown:
        print(f"unknown archs {sorted(unknown)}; known: {list(ARCHS)}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.gpu_line()
    print(card, flush=True)
    out = {"card": card, "torch": torch.__version__, "steps_a_turn": STEPS,
           "order": list(ORDER), "archs": {}}
    (cs.ROOT / "build").mkdir(exist_ok=True)
    for arch in archs:
        out["archs"][arch] = arch_turns(arch)
        (cs.ROOT / "build" / "grad_accum_steps.json").write_text(
            json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0 if all(a["same_bits"] for a in out["archs"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
