#!/usr/bin/env python3
"""Training steps with AdamW's kernels against the plain update, in turns,
on one CUDA card.

    python3 chip_adamw_steps.py [ARCH ...]

(no arch named: the six that train on one card: granite-moe-3b-a800m,
zamba2-2.7b, mamba2-1.3b, minicpm-2b, gemma2-2b, whisper-large-v3).  Each
arch is built at full width and depth with ``chip_smoke.py``'s recipe
(bf16 parameters, float32 moments, random weights from seed 0, 8 x 512
tokens a step, whisper 8 x 448 over 8 x 1500 frames, remat none, the
launcher's optimizer) and trained on one state with the optimizer's three
``ops`` entries either the kernels (``csrc/adamw.cu``) or the plain norm
and loop (``kernels/ref.py``, what every step ran before the kernels): a
warm-up step each, then STEPS steps a turn in the order plain, kernels,
kernels, plain, each turn's seconds a step by the host clock around steps
that end in ``torch.cuda.synchronize``; one profiled step each (device
busy ms, kernel launches); the optimizer's step by itself on the trained
state with one batch's gradients (``chip_smoke.update_profile``: device
ms of the plain norm and loop and of the kernels), and its share of the
plain step's device time.  Prints the card's name and power limit, one
line an arch, then one JSON object, also written to
``build/adamw_steps.json``.  Exits non-zero without a card.
"""
from __future__ import annotations

import gc
import json
import sys
import time

import torch

import chip_smoke as cs
from repro_torch.kernels import ops

ARCHS = ("granite-moe-3b-a800m", "zamba2-2.7b", "mamba2-1.3b", "minicpm-2b",
         "gemma2-2b", "whisper-large-v3")
STEPS = 2           # steps a turn
ORDER = ("plain", "kernels", "kernels", "plain")


def use(side: str) -> None:
    """The optimizer's three ``ops`` entries: the kernels or the plain
    versions."""
    ops.grad_sumsq, ops.sum_in_order, ops.adamw_update = (
        KERNELS if side == "kernels" else cs.PLAIN_UPDATE)


KERNELS = cs.kernel_update()


def busy(step) -> tuple:
    """(device busy ms, kernel launches) of one profiled step."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(cs.kernel_device_us(e) for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def arch_turns(arch: str):
    cfg = cs.get_config(arch)
    model = cs.build_model(cfg)
    opt = cs.build_optimizer(cfg, cs.TRAIN_LR, cs.TRAIN_STEPS)
    rt = cs.RuntimeConfig(microbatches=1, remat="none", loss_chunks=1,
                          aux_weight=0.01)
    state = cs.init_state(model, opt)
    step_fn = cs.make_train_step(cfg, opt, rt)
    dc = cs.DataConfig(vocab=cfg.vocab, seq_len=cs.train_seq(cfg),
                       global_batch=cs.TRAIN_BATCH, seed=0)
    batch = {**cs.batch_at(dc, 0), **cs.train_extras(cfg, cs.TRAIN_BATCH)}

    def step():
        nonlocal state
        state, _ = step_fn(state, batch)

    seconds = {"plain": [], "kernels": []}
    for side in ("plain", "kernels"):       # warm-up
        use(side)
        step()
    for side in ORDER:
        use(side)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        seconds[side].append((time.perf_counter() - t0) / STEPS)
    device = {}
    for side in ("plain", "kernels"):
        use(side)
        device[side] = busy(step)
    use("kernels")
    update = cs.update_profile(cfg, model, state, opt, rt, batch)
    share = update["plain"]["device_ms"] / device["plain"][0]
    out = dict(step_s=seconds, busy_ms_launches=device, update=update,
               plain_update_share_of_busy=share)
    print(f"adamw steps {arch}: s a step in turns (plain, kernels, kernels, "
          f"plain; {STEPS} steps a turn): plain {seconds['plain']}, kernels "
          f"{seconds['kernels']}; one profiled step (device ms, launches): "
          f"plain {device['plain']}, kernels {device['kernels']}; the "
          f"optimizer alone: plain {update['plain']['device_ms']:.3f} ms "
          f"({share:.3f} of the plain step's device time), kernels "
          f"{update['kernels']['device_ms']:.3f} ms, bound "
          f"{update['bound_ms']:.3f} ms", flush=True)
    del model, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_adamw_steps: no CUDA device", file=sys.stderr)
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
    try:
        for arch in archs:
            out["archs"][arch] = arch_turns(arch)
    finally:
        use("kernels")
    (cs.ROOT / "build").mkdir(exist_ok=True)
    (cs.ROOT / "build" / "adamw_steps.json").write_text(
        json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
