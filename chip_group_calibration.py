#!/usr/bin/env python3
"""Readings behind the limits of ``chip_smoke.py``'s bf16 head checks.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_group_calibration.py

For each model of ``chip_smoke.LM_ARCHS`` it builds the model at full width
from seed 0 as ``chip_smoke.py`` does, keeps its head (zamba2-2.7b: the
first hybrid group of 5 Mamba2 + 1 attention layers; granite-moe-3b-a800m:
the first 2 layers; each with the full-width embedding), and prefills
three 512-token prompts (seeds 1, 3, 5) through it.  Against the CPU
float32 run it prints the relative L2 difference, ||run - CPU f32|| /
||CPU f32||, of the last-token logits, of the cache the head fills
(zamba2: the SSM state h; granite: k and v) and, for granite, of the first
layer's MoE FFN on that layer's input from the CPU float32 run
(``chip_smoke.head_prefill``),
for sound runs (card f32, card bf16, CPU bf16) and for card bf16 runs with
a deliberate fault:

- zamba2, in one kernel call of the model: ``flash_noncausal`` (the causal
  mask dropped), ``flash_misplaced_tile`` (keys and values 64-127 replaced
  by 0-63), ``flash_scale_1_over_hd`` (softmax scale 1/hd for 1/sqrt(hd)),
  ``ssd_no_carry`` (the state not carried from one chunk to the next),
  ``ssd_B_C_swapped`` (B and C in each other's place), ``ssd_dt_shift``
  (dt one position late);
- granite, the three flash faults above, and in the MoE layers:
  ``moe_w_in_experts_swapped`` (experts 0 and 1 given each other's
  ``w_in``), ``moe_w_in_w_gate_swapped`` (``w_in`` and ``w_gate`` in each
  other's place), ``moe_no_capacity_drop`` (every slot kept, the capacity
  drop skipped), ``moe_weights_not_renormalised`` (the top-k router
  weights not divided by their sum).

For granite it also prints how many (token, expert) slots go past the
capacity in each layer, which decides whether ``moe_no_capacity_drop``
can show, and each MoE fault's reading in a card float32 run on that
first MoE FFN, max |run - CPU f32| / max |CPU f32|, against which
``chip_smoke.GROUP_F32_TOL`` holds the sound float32 run.
``chip_smoke.GROUP_BF16_REL`` is set between the largest sound reading and
the smallest reading of a fault it can see.

The gradient head check of ``chip_smoke.py``'s training phase is
calibrated the same way (``grad``): granite's first 2 layers with the
full-width embedding, built from seed 0 as ``chip_smoke.train_phase``
builds them, and ``chip_smoke.grad_check_inputs`` of data seeds 1, 3, 5:
the gradients of the loss on one 1 x 512 batch by parameter group
(embed, attn, router, experts, norms), and of the first MoE FFN alone on a
shared input and output gradient (router, experts, its input x), each by
relative L2 against the CPU's float32 plain gradients, for sound runs
(card f32, card bf16, CPU bf16) and for card runs (head f32 and bf16, MoE
FFN bf16) with a fault in a backward: ``bwd_flash_dk_dv_swapped`` (the
flash backward's dK and dV in each other's place),
``bwd_flash_softcap_ignored`` (the backward run without the softcap, its
derivative dropped with it; granite has no attention softcap, so this one
cannot show there: the kernel checks' softcap variant covers it),
``bwd_gmm_expert0_dw_zeroed`` (one expert's dw zeroed).
``chip_smoke.GRAD_F32_REL`` and ``GRAD_BF16_REL`` are set from these.
``grad`` also runs zamba2-2.7b's first hybrid group (5 Mamba2 + 1
attention layers, the full-width embedding; ``chip_smoke.
hybrid_grad_inputs`` of data seeds 1, 3, 5): its gradients by parameter
group (embed, ssm_proj, ssm_scalars, conv, attn, norms) against the CPU's
float32 plain ones, sound (card f32, card bf16, CPU bf16) and with a fault
in the SSD scan's backward: ``bwd_ssd_dB_dC_swapped`` (dB and dC in each
other's place), ``bwd_ssd_no_state_pass`` (the reverse state pass skipped:
each chunk's backward run on its own, no gradient carried back from the
chunks after it), ``bwd_ssd_dA_zeroed`` (dA zeroed).
``chip_smoke.HYBRID_GRAD_F32_REL`` is set from these.

``family`` does the same for the families added later:
the serving heads of ``chip_smoke.HEAD_ARCHS`` (mamba2-1.3b's first 2
layers with the SSD faults above; minicpm-2b's first 2 layers, gemma2-2b's
first local/global pair and internvl2-26b's first 2 layers, with its 256
frontend embeddings, with the flash faults), read against the CPU float32
run as above; ``chip_smoke.CUT_ARCHS`` at their cut depth (mixtral-8x22b
with the flash and MoE faults, command-r-plus-104b with the flash faults),
read against the same model's float32 run through the plain versions on
the card, as ``chip_smoke.cut_phase`` holds them; and the gradient heads of
``chip_smoke.FAMILY_TRAIN_ARCHS`` (mamba2 with the SSD-backward faults,
minicpm and gemma2 with the flash-backward faults; gemma2's softcap shows
``bwd_flash_softcap_ignored``), from which ``chip_smoke.FAMILY_GRAD_F32_REL``
is set.  ``family`` also runs whisper-large-v3 (``whisper`` alone runs only
it): its head (the first encoder and decoder layers, the full-width
embeddings, a 224-token prompt over 1500 frames, 3 decode steps after it)
with the flash faults and its own: ``encoder_causal`` (the encoder under
the causal mask), ``cross_decoder_kv`` (the cross-attention fed the
decoder's own stream for its keys and values; the cache keeps the
encoder's), ``no_sinusoids`` (the encoder's positions left out),
``decode_position_plus_1`` (a decode step's learned position taken one
row late), behind ``chip_smoke.GROUP_BF16_REL["whisper-large-v3"]``; and
its gradient head with the flash backward's dK and dV swapped,
``encoder_causal`` and ``no_sinusoids`` (``cross_decoder_kv`` leaves the
encoder out of the loss: no gradient to compare), behind
``chip_smoke.WHISPER_GRAD_F32_REL``.

    python3 chip_group_calibration.py [forward] [grad] [family] [whisper]

(no argument: the first three).  The full record goes to
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
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models import moe as moe_mod

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


def encoder_causal(flash, q, k, v, **kw):
    """The encoder's calls (as many queries as keys, no mask) run under the
    causal mask."""
    if not kw.get("causal", True) and q.shape[1] == k.shape[1]:
        kw = dict(kw, causal=True)
    return flash(q, k, v, **kw)


def cross_decoder_kv(cross, p, y, cfg, enc):
    out, _ = cross(p, y, cfg, y)
    return out, cross(p, y, cfg, enc)[1]


def no_sinusoids(sinusoids, *a, **kw):
    return torch.zeros_like(sinusoids(*a, **kw))


def decode_position_plus_1(position, model, pos):
    return position(model, pos + 1)


def wrap(module, attr, fault):
    """A patch of ``module.<attr>`` that calls ``fault`` with the sound
    function first."""
    return module, attr, lambda good: (
        lambda *a, **kw: fault(good, *a, **kw))


def moe_w_in_experts_swapped(state):
    state = dict(state)
    for k in [k for k in state if k.endswith(".moe.w_in")]:
        state[k] = state[k][[1, 0, *range(2, state[k].shape[0])]]
    return state


def moe_w_in_w_gate_swapped(state):
    state = dict(state)
    for k in [k for k in state if k.endswith(".moe.w_in")]:
        gate = k[:-len("w_in")] + "w_gate"
        state[k], state[gate] = state[gate], state[k]
    return state


def keep_every_slot(cfg, n_tokens):
    """A capacity no expert reaches: every slot kept."""
    return max(8, -(-n_tokens // 8) * 8)


def route_not_renormalised(x2d, p, cfg):
    probs = moe_mod.router_probs(x2d, p, cfg)
    w, idx = moe_mod.top_k(probs, cfg.moe.top_k)
    return w.to(x2d.dtype), idx, torch.zeros((), device=x2d.device)


#: name -> (module, attribute, patch of the sound function) or a transform
#: of the head's parameters, by model
FLASH_FAULTS = {f.__name__: wrap(ops, "flash_attention_bshd", f) for f in (
    flash_noncausal, flash_misplaced_tile, flash_scale_1_over_hd)}
SSD_FAULTS = {f.__name__: wrap(ops, "ssd_scan", f)
              for f in (ssd_no_carry, ssd_B_C_swapped, ssd_dt_shift)}
MOE_FAULTS = {
    "moe_w_in_experts_swapped": moe_w_in_experts_swapped,
    "moe_w_in_w_gate_swapped": moe_w_in_w_gate_swapped,
    "moe_no_capacity_drop": (moe_mod, "capacity",
                             lambda good: keep_every_slot),
    "moe_weights_not_renormalised": (moe_mod, "route",
                                     lambda good: route_not_renormalised),
}
WHISPER_FAULTS = {
    "encoder_causal": wrap(ops, "flash_attention_bshd", encoder_causal),
    "cross_decoder_kv": wrap(lm_mod, "_cross_part", cross_decoder_kv),
    "no_sinusoids": wrap(lm_mod, "_sinusoids", no_sinusoids),
    "decode_position_plus_1": wrap(lm_mod, "_decode_position",
                                   decode_position_plus_1),
}
FAULTS = {
    "zamba2-2.7b": dict(FLASH_FAULTS, **SSD_FAULTS),
    "granite-moe-3b-a800m": dict(FLASH_FAULTS, **MOE_FAULTS),
    "mamba2-1.3b": SSD_FAULTS,
    "minicpm-2b": FLASH_FAULTS,
    "gemma2-2b": FLASH_FAULTS,
    "internvl2-26b": FLASH_FAULTS,
    "mixtral-8x22b": dict(FLASH_FAULTS, **MOE_FAULTS),
    "command-r-plus-104b": FLASH_FAULTS,
    "whisper-large-v3": dict(FLASH_FAULTS, **WHISPER_FAULTS),
}


def faulty(head, state, tokens, fault, moe_in, dtype=torch.bfloat16,
           extras=None):
    """A card prefill of the head with ``fault`` put in."""
    if callable(fault):
        return cs.head_prefill(head, fault(state), tokens, dtype, "cuda",
                               moe_in, extras)
    module, attr, patch = fault
    good = getattr(module, attr)
    setattr(module, attr, patch(good))
    try:
        return cs.head_prefill(head, state, tokens, dtype, "cuda", moe_in,
                               extras)
    finally:
        setattr(module, attr, good)


def drops(head, state, tokens):
    """Slots past the capacity in each MoE layer of the CPU float32 run."""
    K, E = head.moe.top_k, head.moe.n_experts
    C = moe_mod.capacity(head, tokens.numel())
    out = []
    for probs in cs.head_routes(head, state, tokens, "cpu"):
        load = torch.bincount(moe_mod.top_k(probs, K)[1].reshape(-1),
                              minlength=E)
        out.append(int((load - C).clamp(min=0).sum()))
    return out


def calibrate(arch):
    cfg = cs.get_config(arch)
    model = cs.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    head, state = cs.model_head(cfg, model)
    del model
    torch.cuda.empty_cache()
    names = cs.head_outputs(cfg)
    f32, bf16 = torch.float32, torch.bfloat16
    sound = [("card_f32", f32, "cuda"), ("card_bf16", bf16, "cuda")]
    if arch not in cs.HEAD_NO_CPU_BF16:
        sound.append(("cpu_bf16", bf16, "cpu"))
    record = {}
    for seed in SEEDS:
        tokens, extras = cs.head_check_inputs(cfg, seed)
        t0 = time.perf_counter()
        moe_in = (cs.moe_inputs(head, state, tokens, "cpu")[0][0]
                  if cfg.moe is not None else None)
        want = cs.head_prefill(head, state, tokens, f32, "cpu", moe_in,
                               extras)
        runs = {name: cs.head_prefill(head, state, tokens, dtype, dev,
                                      moe_in, extras)
                for name, dtype, dev in sound}
        for name, fault in FAULTS[arch].items():
            runs[name] = faulty(head, state, tokens, fault, moe_in,
                                extras=extras)
        row = {name: {k: cs.rel_l2(r[k], want[k]) for k in names}
               for name, r in runs.items()}
        if cfg.moe is not None:
            row["drops_per_layer"] = drops(head, state, tokens)
            scale = want["moe"].abs().max()
            for name, fault in FAULTS[arch].items():
                if name.startswith("moe"):
                    got = faulty(head, state, tokens, fault, moe_in, f32)
                    row[name + "_f32"] = {"moe": ((got["moe"] - want["moe"])
                                                  .abs().max() / scale).item()}
        record[seed] = row
        print(f"{arch} seed {seed} ({time.perf_counter() - t0:.1f} s), "
              "relative L2 against CPU f32:", flush=True)
        for name, r in row.items():
            print(f"  {name}: " + (", ".join(f"{k} {v:.4g}"
                                             for k, v in r.items())
                                   if isinstance(r, dict) else str(r)),
                  flush=True)
    return record


def calibrate_cut(arch):
    """``chip_smoke.cut_phase``'s check: the cut model in bf16 on the
    kernels, sound and with each fault, against its float32 run through
    the plain versions on the card, for three prompts."""
    cfg = cs.get_config(arch).scaled(n_layers=cs.CUT_LAYERS)
    model = cs.LM(cfg, dtype=torch.float32, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))

    def run(tokens):
        logits, cache = cs.prefill(model, tokens)
        return {"logits": logits[:, :cfg.vocab].float(),
                "k": cache["k"].float(), "v": cache["v"].float()}

    wants = {}
    for seed in SEEDS:
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (1, cs.LM_CHECK_TOKENS))).cuda()
        with cs.plain_on_card():
            wants[seed] = (tokens, run(tokens))
    card_f32 = {seed: run(tokens) for seed, (tokens, _) in wants.items()}
    model.to(torch.bfloat16)
    torch.cuda.empty_cache()
    record = {}
    for seed, (tokens, want) in wants.items():
        runs = {"card_f32": card_f32[seed], "card_bf16": run(tokens)}
        for name, fault in FAULTS[arch].items():
            if callable(fault):
                saved = {k: v.clone() for k, v in model.state_dict().items()}
                model.load_state_dict(fault(saved))
                runs[name] = run(tokens)
                model.load_state_dict(saved)
                del saved
            else:
                module, attr, patch = fault
                good = getattr(module, attr)
                setattr(module, attr, patch(good))
                try:
                    runs[name] = run(tokens)
                finally:
                    setattr(module, attr, good)
        row = {name: {k: cs.rel_l2(r[k], want[k]) for k in want}
               for name, r in runs.items()}
        record[seed] = row
        print(f"{arch} cut to {cs.CUT_LAYERS} layers, seed {seed}, relative "
              "L2 against the plain float32 run on the card:", flush=True)
        for name, r in row.items():
            print(f"  {name}: " + ", ".join(f"{k} {v:.4g}"
                                            for k, v in r.items()),
                  flush=True)
    del model
    torch.cuda.empty_cache()
    return record


def bwd_flash_dk_dv_swapped(good):
    def backward(*a, **kw):
        dq, dk, dv = good(*a, **kw)
        return dq, dv, dk
    return backward


def bwd_flash_softcap_ignored(good):
    return lambda *a, **kw: good(*a, **dict(kw, logit_cap=0.0))


def bwd_gmm_expert0_dw_zeroed(good):
    def backward(ctx, dy):
        dx, dw = good(ctx, dy)
        if dw is not None:
            dw = dw.clone()
            dw[0] = 0
        return dx, dw
    return staticmethod(backward)


#: name -> (owner, attribute, patch of the sound function)
GRAD_FAULTS = {
    "bwd_flash_dk_dv_swapped": (flash_mod, "flash_attention_backward",
                                bwd_flash_dk_dv_swapped),
    "bwd_flash_softcap_ignored": (flash_mod, "flash_attention_backward",
                                  bwd_flash_softcap_ignored),
    "bwd_gmm_expert0_dw_zeroed": (ops._GroupedMatmul, "backward",
                                  bwd_gmm_expert0_dw_zeroed),
}


def bwd_ssd_dB_dC_swapped(good):
    def backward(*a, **kw):
        dx, ddt, dB, dC, dA, dh0 = good(*a, **kw)
        return dx, ddt, dC, dB, dA, dh0
    return backward


def bwd_ssd_no_state_pass(good):
    """Each chunk's backward on its own (its start state from the forward's
    states, no end-state gradient from the chunks after it)."""
    def backward(x, dt, B, C, A, h0, states, cum, dy, dh_final, *, chunk):
        nc = x.shape[1] // chunk
        parts = []
        for c in range(nc):
            sl = slice(c * chunk, (c + 1) * chunk)
            parts.append(good(
                *(t[:, sl].contiguous() for t in (x, dt, B, C)), A,
                h0 if c == 0 else None, states[:, c:c + 1].contiguous(),
                cum[:, :, sl].contiguous(), dy[:, sl].contiguous(),
                dh_final if c == nc - 1 else None, chunk=chunk))
        return (*(torch.cat([p[i] for p in parts], 1) for i in range(4)),
                sum(p[4] for p in parts), parts[0][5])
    return backward


def bwd_ssd_dA_zeroed(good):
    def backward(*a, **kw):
        dx, ddt, dB, dC, dA, dh0 = good(*a, **kw)
        return dx, ddt, dB, dC, torch.zeros_like(dA), dh0
    return backward


#: zamba2's faults: name -> (owner, attribute, patch of the sound function)
HYBRID_GRAD_FAULTS = {
    name: (ssd_mod, "ssd_scan_backward", patch) for name, patch in (
        ("bwd_ssd_dB_dC_swapped", bwd_ssd_dB_dC_swapped),
        ("bwd_ssd_no_state_pass", bwd_ssd_no_state_pass),
        ("bwd_ssd_dA_zeroed", bwd_ssd_dA_zeroed))}


def patched(fault, fn, *args):
    """``fn(*args)`` with ``fault`` put in."""
    owner, attr, patch = fault
    saved = owner.__dict__[attr]
    setattr(owner, attr, patch(getattr(owner, attr)))
    try:
        return fn(*args)
    finally:
        setattr(owner, attr, saved)


def calibrate_grads():
    cfg = cs.get_config(cs.TRAIN_ARCH)
    model = cs.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    f32, bf16 = torch.float32, torch.bfloat16
    record = {}
    for seed in SEEDS:
        t0 = time.perf_counter()
        head, state, batch, x_in, dy = cs.grad_check_inputs(cfg, model, seed)
        want = cs.head_grads(head, state, batch, f32, "cpu")
        want_moe = cs.moe_grads(head, state, x_in, dy, f32, "cpu")

        def head_run(dtype, dev="cuda"):
            return cs.grad_rel(cs.head_grads(head, state, batch, dtype, dev),
                               want)

        def moe_run(dtype, dev="cuda"):
            return cs.grad_rel(cs.moe_grads(head, state, x_in, dy, dtype,
                                            dev), want_moe,
                               cs.MOE_GRAD_GROUPS)

        row = {"head card_f32": head_run(f32), "head card_bf16":
               head_run(bf16), "head cpu_bf16": head_run(bf16, "cpu"),
               "moe card_f32": moe_run(f32), "moe card_bf16": moe_run(bf16),
               "moe cpu_bf16": moe_run(bf16, "cpu")}
        for name, fault in GRAD_FAULTS.items():
            row[f"head f32 {name}"] = patched(fault, head_run, f32)
            row[f"head bf16 {name}"] = patched(fault, head_run, bf16)
            row[f"moe bf16 {name}"] = patched(fault, moe_run, bf16)
        record[seed] = row
        print(f"{cfg.arch} gradients, data seed {seed} "
              f"({time.perf_counter() - t0:.1f} s), relative L2 against "
              "CPU f32:", flush=True)
        for name, r in row.items():
            print(f"  {name}: " + ", ".join(f"{k} {v:.4g}"
                                            for k, v in r.items()),
                  flush=True)
    del model
    torch.cuda.empty_cache()
    return record


def calibrate_hybrid_grads():
    cfg = cs.get_config(cs.HYBRID_TRAIN_ARCH)
    model = cs.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    f32, bf16 = torch.float32, torch.bfloat16
    groups = cs.HYBRID_GRAD_GROUPS
    record = {}
    for seed in SEEDS:
        t0 = time.perf_counter()
        head, state, batch = cs.hybrid_grad_inputs(cfg, model, seed)
        want = cs.head_grads(head, state, batch, f32, "cpu")

        def head_run(dtype, dev="cuda"):
            return cs.grad_rel(cs.head_grads(head, state, batch, dtype, dev),
                               want, groups)

        row = {"head card_f32": head_run(f32), "head card_bf16":
               head_run(bf16), "head cpu_bf16": head_run(bf16, "cpu")}
        for name, fault in HYBRID_GRAD_FAULTS.items():
            row[f"head f32 {name}"] = patched(fault, head_run, f32)
            row[f"head bf16 {name}"] = patched(fault, head_run, bf16)
        record[seed] = row
        print(f"{cfg.arch} gradients, data seed {seed} "
              f"({time.perf_counter() - t0:.1f} s), relative L2 against "
              "CPU f32:", flush=True)
        for name, r in row.items():
            print(f"  {name}: " + ", ".join(f"{k} {v:.4g}"
                                            for k, v in r.items()),
                  flush=True)
    del model
    torch.cuda.empty_cache()
    return record


def calibrate_family_grads(arch):
    """The gradient head of one of ``chip_smoke.FAMILY_TRAIN_ARCHS``, sound
    and with the backward faults that reach it, as
    ``chip_smoke.grad_head_check`` reads it."""
    cfg = cs.get_config(arch)
    model = cs.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    f32, bf16 = torch.float32, torch.bfloat16
    if cfg.enc_dec:
        groups = cs.WHISPER_GRAD_GROUPS
        faults = {"bwd_flash_dk_dv_swapped":
                  GRAD_FAULTS["bwd_flash_dk_dv_swapped"],
                  **{k: WHISPER_FAULTS[k] for k in (
                      "encoder_causal", "no_sinusoids")}}
    else:
        groups = cs.FAMILY_GRAD_GROUPS[arch]
        faults = (HYBRID_GRAD_FAULTS if cfg.ssm is not None else
                  {k: GRAD_FAULTS[k] for k in ("bwd_flash_dk_dv_swapped",
                                               "bwd_flash_softcap_ignored")})
    record = {}
    for seed in SEEDS:
        t0 = time.perf_counter()
        head, state, batch = cs.hybrid_grad_inputs(cfg, model, seed)
        want = cs.head_grads(head, state, batch, f32, "cpu")

        def head_run(dtype, dev="cuda"):
            return cs.grad_rel(cs.head_grads(head, state, batch, dtype, dev),
                               want, groups)

        row = {"head card_f32": head_run(f32), "head card_bf16":
               head_run(bf16)}
        for name, fault in faults.items():
            row[f"head f32 {name}"] = patched(fault, head_run, f32)
        record[seed] = row
        print(f"{cfg.arch} gradients, data seed {seed} "
              f"({time.perf_counter() - t0:.1f} s), relative L2 against "
              "CPU f32:", flush=True)
        for name, r in row.items():
            print(f"  {name}: " + ", ".join(f"{k} {v:.4g}"
                                            for k, v in r.items()),
                  flush=True)
    del model
    torch.cuda.empty_cache()
    return record


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("chip_group_calibration: no CUDA device", file=sys.stderr)
        return 2
    parts = set((sys.argv[1:] if argv is None else argv)
                or ("forward", "grad", "family"))
    print(cs.gpu_line(), flush=True)
    _build.library()
    torch.set_num_threads(os.cpu_count() or 1)
    record = {}
    if "forward" in parts:
        record.update({arch: calibrate(arch) for arch in cs.LM_ARCHS})
    if "grad" in parts:
        record["grad " + cs.TRAIN_ARCH] = calibrate_grads()
        record["grad " + cs.HYBRID_TRAIN_ARCH] = calibrate_hybrid_grads()
    if "family" in parts:
        record.update({arch: calibrate(arch) for arch in cs.HEAD_ARCHS})
        record.update({f"{arch} {cs.CUT_LAYERS} layers": calibrate_cut(arch)
                       for arch in cs.CUT_ARCHS})
        record.update({"grad " + arch: calibrate_family_grads(arch)
                       for arch in cs.FAMILY_TRAIN_ARCHS})
    if parts & {"family", "whisper"}:
        record[cs.WHISPER_ARCH] = calibrate(cs.WHISPER_ARCH)
        record["grad " + cs.WHISPER_ARCH] = calibrate_family_grads(
            cs.WHISPER_ARCH)
    out = cs.ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_group_calibration.json").write_text(json.dumps(record,
                                                                indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
