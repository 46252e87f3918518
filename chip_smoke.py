#!/usr/bin/env python3
"""Bring-up check of the PyTorch port on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the hand-written kernels (``src/repro_torch/csrc/*.cu``, with
``nvcc`` for ``sm_90a``, into ``build/kernels/``), holds each kernel
against its plain PyTorch version on the card, then drives the port's
main paths, each with the kernels' launch counters set to 0 just before it
and read just after:

- the scheduler: ``Session`` -> ``Scheduler`` -> ``ThreadedExecutor``,
  host fission slots plus two CUDA-stream slots on ``cuda:0``, over the
  paper's five benchmark SCTs at the paper's sizes (the FFT's bodies are
  cuFFT: it has no hand-written kernel), every output checked, and a
  filter -> filter chain resident on the card between its steps;
- the main path's own gates (``repro_torch.bench``: locality, pipeline and
  the telemetry smoke, at their full sizes, each on its own schedulers,
  the accelerator slots on CUDA streams), every deterministic gate held
  and the wall-clock ratios recorded, each accelerator slot span of the
  exported trace (``build/trace_torch.json``) held to at least its
  work's CUDA-event time; the quickstart; flash attention's forward and
  backward at head dims 84 and 96 (padded up to 128) against the plain
  version, and dim 84 timed beside 80 and 128;
- the paper's experiments on this host (``repro_torch.bench``): for each
  of the five SCTs (saxpy and the FFT at their middle size class, the
  others at their smallest), Algorithm 1 searching the
  host's fission slots and four CUDA-stream slots (``hybrid --testbed
  host``), then the tuned profile and the GPU-only baseline re-timed in
  turns, both outputs held to the plain versions and the kernels'
  launches to the accelerator segments; FFT-256's search trace
  (``profile_construction``); the timed partition sweep of ``fission``
  part (b).  Wall-clock numbers are printed (``paper ...`` lines), never
  gated;
- the decode step's four kernels (``csrc/rmsnorm.cu``, ``rope_cache.cu``,
  ``decode_attention.cu``, ``ssd_decode.cu``: no TPU kernel, the JAX
  engine's jit fuses that work) against their plain versions at every
  decode arch's shapes (``kernel rmsnorm|rope_cache_write|
  decode_attention|ssd_decode_step <case>`` lines: head dims 64, 80, 128
  and 256, gemma2 past its window, whisper's self- and cross-attention,
  zamba2's and mamba2's SSD heads), each timed in turns with its plain
  version and, where one PyTorch call computes it, ``F.rms_norm`` or SDPA;
- LM serving, two models in turn, each at full width in bf16 with random
  weights from a seed, behind ``ServeEngine``: 8 requests of 256 to 1536
  prompt tokens and 32 new tokens each.  zamba2-2.7b (54 layers, d_model
  2560) runs the flash attention and SSD scan kernels; granite-moe-3b-a800m
  (32 layers, d_model 1536, 40 experts top-8) runs flash attention and the
  MoE grouped GEMM.  Every decode step of every served model is one replay
  of the step's CUDA graph (``DecodeGraph``, captured when the engine is
  made), and every prefill of a prompt length seen before one replay of
  that length's graph (``PrefillGraphs``, captured at the length's second
  prefill; its first runs eagerly: an ``lm prefill graphs`` line gives
  the share of prefills that repeat a length, the lengths captured with
  their capture seconds, and those replayed); for zamba2, granite,
  mamba2, minicpm and gemma2 an ``lm prefill graph`` line gives the
  graphed against the eager prefill at two lengths (the short one and the
  longest eager, captured, then the short one replayed, each on a prompt
  drawn anew): logits and cache bit-identical, one prefill's launches a
  call, a replay's device operations those of an eager prefill, seconds
  a request in turns, the capture seconds, the graphs' pool and static
  bytes against an eager prefill's peak, and the idle share of one
  profiled call of each; for
  zamba2, granite, gemma2 (past its window) and whisper an
  ``lm decode graph`` line gives graphed against eager decode tokens/s in
  turns on one cache and one set of tokens, the idle share of 8 steps of
  each, and a replay's device operations against an eager step's, with
  the greedy tokens equal and the logits bit-identical; and the graphed
  step with the decode kernels against a graph of the same step with
  their plain versions, in turns (tokens/s, the logits' distances at
  every step printed), and an ``lm decode head`` line: at the model's
  head, full width, each step from a shared cache, the kernels' logits
  within 2e-2 relative L2 of the plain versions' in float32 (bf16
  printed), greedy tokens that differ only at near ties.  Then the head of
  each model (zamba2's first hybrid
  group of 5 Mamba2 + 1 attention layers, granite's first 2 layers, each
  with the full-width embedding) on the card against the same parameters
  on the CPU (plain versions);
- LM training, after serving's models are freed: flash attention's forward
  and backward and the grouped GEMM's dx and dw at the training shapes
  against autograd through their plain versions (timed beside the SDPA
  backward and ``torch.bmm``), dx's and dw's own kernels
  (``grouped_matmul_dx``, ``grouped_matmul_dw``: the operands read in
  place) each alone against its plain version at granite's two shapes and
  a ragged capacity, then four steps of granite-moe-3b-a800m at
  full width (bf16 parameters, float32 AdamW moments, random weights from
  seed 0) through ``make_train_step`` on ``batch_at``'s 8 x 512 tokens,
  with no plain version called, every bf16 gradient of the grouped GEMM
  through the dx and dw kernels, each step's optimizer three calls of
  AdamW's kernels (``csrc/adamw.cu``), and the gradients of the model's
  first 2 layers (bf16, kernels) against the CPU's (float32, plain
  versions); the optimizer's step alone on the trained state, plain
  against the kernels by device time (also for zamba2); the four steps
  again with the plain update at the kernels' norm, the same bits; and
  AdamW's kernels over granite's parameters (bf16, float32 moments warm
  from a step) against the plain loop bit for bit, timed in turns; the
  microbatch accumulation on the same model (one 8 x 512 batch at 4
  microbatches, ``csrc/grad_accum.cu`` against the plain loop patched
  into ``ops``: every accumulated gradient the same bits, both peaks),
  then its kernel over granite's 322 gradients timed in turns with the
  plain loop and ``torch._foreach_add_``;
- zamba2-2.7b training, after granite's state is freed: the SSD scan's
  backward kernel at the training shape (x 8 x 512 x 80 heads of 64,
  d_state 64, chunk 256) and on a chained ragged tail with h0 and
  dh_final, against autograd through the plain recurrence (timed in turns
  with it), the gradients of the model's first hybrid group (5 Mamba2 + 1
  attention layers, with the full-width embedding) card float32 against
  CPU float32 by parameter group, then four full-width, full-depth steps
  (54 layers: 45 Mamba2 + 9 attention) through ``make_train_step`` on
  ``batch_at``'s 8 x 512 tokens, with no plain version called;
- the other families, each model freed before the next: mamba2-1.3b,
  minicpm-2b, gemma2-2b, nemotron-4-15b and internvl2-26b served at full
  width and depth behind ``ServeEngine`` (4 requests of 256-1536 prompt
  tokens, 16 new tokens each), each kernel first held to its plain
  version at the arch's shapes; gemma2 once more past its 4096-token
  window, internvl2 with 256 frontend embeddings; a head check card
  against CPU for one model of each family; mixtral-8x22b and
  command-r-plus-104b at full width with their depth cut to 2 layers,
  their kernels held to the plain versions on the card; mamba2, minicpm
  and gemma2 trained at full width and depth (4 steps each, a gradient
  head check, no plain version called); ``repro_torch.examples.train_lm``
  run to a checkpoint and resumed from it;
- whisper-large-v3, the encoder-decoder, at full width and depth (32
  encoder and 32 decoder layers, d_model 1280, 20 heads of 64; bf16,
  random weights from seed 0): flash's forward and backward at its shapes
  (the encoder's non-causal 1500 frames, the cross-attention's queries
  against 1500 keys, the decoder's causal 448 tokens) against the plain
  version in float32 and bf16, timed beside SDPA; 4 requests with their
  own 1500 frames and 4-token prompts, prefilled together at capacity 448
  and decoded 60 greedy steps through ``prefill`` and the decode step's
  graph (the engine, like the JAX package's, takes no frames), then one
  request with a 224-token prompt and 32 steps; a profiled prefill and 8
  decode steps;
  its head (the first encoder and decoder layers, the full-width
  embeddings) card against CPU, through the cross-attention cache and 3
  decode steps; its head's gradients; four training steps of 8 x 448
  tokens over 8 x 1500 frames;
- the launch layer (``repro_torch.launch.dryrun``): one dry-run cell of
  each shape traced on the meta device on this host (gemma2-2b train_4k,
  granite-moe-3b-a800m prefill_32k, mamba2-1.3b decode_32k, zamba2-2.7b
  long_500k; ``dryrun`` lines: fit, peak GiB, bottleneck, roofline
  fraction, trace seconds), no plain version called; the dry-run's cells at
  the shapes of three steps measured above (mamba2's and gemma2's
  training steps, zamba2's 1536-token prefill) held to them: predicted
  kernel calls equal to the launches counted, predicted peak memory
  within PEAK_MEMORY_TOL of ``max_memory_allocated``, and each step's
  model-FLOPs utilisation beside the roofline's step time (``check``
  lines); the card's total memory equal to ``HBM_PER_CARD``;
  ``repro_torch.examples.serve_llm`` on the card to the end of its
  asserts;
- the multi-card layer (``repro_torch.launch.dryrun.build_cell`` on a
  ``DeviceMesh``): a sequence shard's attention
  (``ops.flash_attention_offset_bshd``, two flash calls merged, the
  backward kernel on each) at a shard of minicpm-2b's train_4k cell,
  without and with a window, against the plain version with the query
  offset (``kernel flash_offset`` lines, launches counted, timed beside
  SDPA with the same mask); granite-moe-3b-a800m at full width and depth,
  once unsharded and once through the sharded path on a (1, 1) mesh of a
  world-1 NCCL group (parameters, batch and cache DTensors placed by the
  logical rules, the MoE dispatched per data shard): a 1536-token prefill
  at capacity 2048 and one 8 x 512 training step each, the sharded held
  to the unsharded (the same greedy token, logits and loss within
  MESH_LOGITS_REL / MESH_LOSS_RTOL, the updated parameters and first
  moments leaf by leaf, equal kernel launches; the gradient norm's
  largest leaves printed); the quad_2x2 dry-run (4 cards, rank 0 of a
  fake process group on the meta device, one process a cell, run beside
  the kernels' build and ended before anything is measured) of
  nemotron-4-15b and internvl2-26b training 8 x 512 tokens and
  mixtral-8x22b and command-r-plus-104b prefilling 1536 tokens at full
  depth (``dryrun quad_2x2`` lines: per-card peak, fit, collective bytes
  by kind, roofline step).

Standard output ends with three lines: the card's name and power limit as
``nvidia-smi`` prints them, one JSON object describing each kernel
(``{"kernels": [...]}``), and the result line
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before the result line; so does a machine without a CUDA device.  A fuller
record is written to ``build/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))   # flash_bwd_bounds: a check's bound

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from flash_bwd_bounds import attention_bwd_rounding, cancelling  # noqa: E402
from repro_torch import suite  # noqa: E402
from repro_torch.bench import fission as paper_fission  # noqa: E402
from repro_torch.bench import hybrid as paper_hybrid  # noqa: E402
from repro_torch.bench import locality as gate_locality  # noqa: E402
from repro_torch.bench import paper_suite  # noqa: E402
from repro_torch.bench import profile_construction as paper_pc  # noqa: E402
from repro_torch.bench import pipeline as gate_pipeline  # noqa: E402
from repro_torch.bench import telemetry_smoke as gate_telemetry  # noqa: E402
from repro_torch.examples import quickstart, serve_llm, train_lm  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.core import (AcceleratorPlatform, DeviceInfo,  # noqa: E402
                              ExecutionSlot, HostPlatform, JobGraph,
                              KnowledgeBase, LoadBalancer, PlatformConfig,
                              Profile, Scheduler, Session, ThreadedExecutor,
                              Workload, build_plan)
from repro_torch.data import DataConfig, batch_at  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_step as dec_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import moe_gemm as gmm_mod  # noqa: E402
from repro_torch.kernels import nbody as nbody_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.models import (LM, decode_step, init_cache,  # noqa: E402
                                prefill)
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import (embed, rmsnorm,  # noqa: E402
                                       rope_frequencies)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cells import CellConfig, cell_runtime  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_PER_CARD, PEAK_FLOPS, adamw_bound, bound_ms, flash_bound,
    flash_bwd_bound, grad_accum_bound,
    gmm_bound, gmm_bwd_bound, mfu, ssd_bound, ssd_bwd_bound,
    ssd_bwd_split_bound, ssd_split_bound)
from repro_torch.launch.train import build_optimizer  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402
from repro_torch.runtime import (DecodeGraph, PrefillGraphs,  # noqa: E402
                                 RuntimeConfig, ServeEngine, init_state,
                                 make_loss_fn, make_train_step)
from repro_torch.runtime.train import (_accumulate_grads,  # noqa: E402
                                       trainable)

#: the paper's sizes (benchmarks/paper_suite.py BENCHMARKS); segmentation
#: is cut from its largest class (3840 planes, ~15 GiB in and out on the
#: host) to 512 planes for the run's time; the FFT runs its largest class,
#: 1024 FFTs of 65536 float32 (256 MiB in)
SIZE = {"saxpy": 5 * 10 ** 7, "filter_pipeline": 8192, "nbody": 32768,
        "segmentation": 512, "fft": 1024}
ORDER = ["saxpy", "segmentation", "filter_pipeline", "nbody", "fft"]
#: the SCTs whose bodies run no hand-written kernel (the FFT is cuFFT, as
#: the JAX package computes it with jnp.fft outside any Pallas kernel)
NO_KERNEL = ("fft",)
REQUESTS = 3
SHARE_A = 0.8           # accelerator share of the KB profile carried in
OVERLAP = 2             # CUDA streams on cuda:0
FISSION = "L2"          # host fission level of that profile
NBODY_TOL = paper_suite.NBODY_TOL   # max |err| / max |acc| vs float64
#: (targets, bodies) of one accelerator slot (share SHARE_A / OVERLAP) at
#: the paper's N-body size classes, as the main path partitions them; the
#: timing scripts use them
NBODY_SLOTS = [(3277, 8192), (6554, 16384), (13107, 32768)]
#: operations a filtered pixel costs in csrc/filter_pipeline.cu: two
#: integer hashes (~8 each: multiply-add, two shift-xors, a multiply, a
#: mask, a conversion) and two IEEE divisions (~8 each: reciprocal,
#: refinement, range check), then noise, clip, solarize and addressing
FILTER_OPS = 50.0

KERNELS = {
    "saxpy": ("src/repro_torch/csrc/saxpy.cu",
              "src/repro/kernels/saxpy.py:17"),
    # the gradient of the TPU flash kernel's function (the JAX package has
    # no backward kernel: it differentiates its jnp attention)
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention.py:88"),
    "segmentation": ("src/repro_torch/csrc/segmentation.cu",
                     "src/repro/kernels/segmentation.py:23"),
    "filter_pipeline": ("src/repro_torch/csrc/filter_pipeline.cu",
                        "src/repro/kernels/filter_pipeline.py:46"),
    "nbody": ("src/repro_torch/csrc/nbody.cu",
              "src/repro/kernels/nbody.py:44"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:88"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:84"),
    # the gradient of the TPU SSD kernel's function (the JAX package has no
    # backward kernel: it differentiates its jnp chunk loop)
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                     "src/repro/kernels/ssd_scan.py:84"),
    "grouped_matmul": ("src/repro_torch/csrc/moe_gemm.cu",
                       "src/repro/kernels/moe_gemm.py:39"),
    # the gradients of the TPU grouped GEMM's function, dx = dy w^T and
    # dw = x^T dy (the JAX package differentiates its einsum)
    "grouped_matmul_dx": ("src/repro_torch/csrc/moe_gemm.cu",
                          "src/repro/kernels/moe_gemm.py:39"),
    "grouped_matmul_dw": ("src/repro_torch/csrc/moe_gemm.cu",
                          "src/repro/kernels/moe_gemm.py:39"),
    # no TPU kernel: the JAX step is jitted whole and XLA fuses its
    # AdamW.update (global_norm at :22 included)
    "adamw": ("src/repro_torch/csrc/adamw.cu",
              "src/repro/optim/adamw.py:81"),
    # no TPU kernel: the JAX step scans its microbatches under jit and XLA
    # fuses the float32 accumulation of the scan's body
    "grad_accum": ("src/repro_torch/csrc/grad_accum.cu",
                   "src/repro/runtime/train.py:134"),
    # no TPU kernel: the JAX engine jits its whole decode step
    # (src/repro/runtime/serve.py:83) and XLA fuses each layer's rmsnorm,
    # apply_rope with update_cache, decode_attention and ssd_decode
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/models/layers.py:90"),
    "rope_cache_write": ("src/repro_torch/csrc/rope_cache.cu",
                         "src/repro/models/layers.py:141"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/models/attention.py:217"),
    "ssd_decode_step": ("src/repro_torch/csrc/ssd_decode.cu",
                        "src/repro/models/ssm.py:163"),
}
#: the decode step's kernels, each entry of ``ops`` beside its plain version
DECODE_PLAIN = {"rmsnorm": ref.rmsnorm_ref,
                "rope_cache_write": ref.rope_cache_ref,
                "decode_attention": ref.decode_attention_ref,
                "ssd_decode_step": ref.ssd_decode_step_ref}

#: the paper phase: hybrid's host testbed at the middle size class, as the
#: reference's hybrid runs by default (benchmarks/hybrid.py), for saxpy and
#: the FFT; at the smallest for the three whose plain versions on the host
#: slots cost most (at the middle class, on an H100 host of 8 cores,
#: N-body's search took 75 s, the filter's 45 s, segmentation's 27 s;
#: python -m repro_torch.bench.run runs those)
PAPER_SMALLEST = ("filter_pipeline", "nbody", "segmentation")
PAPER_SIZE = {name: sizes[0 if name in PAPER_SMALLEST else 1]
              for name, sizes in paper_hybrid.CLASSES.items()}

#: the LM serve phase: the models, the engine and its requests
LM_ARCHS = ("zamba2-2.7b", "granite-moe-3b-a800m")
LM_SLOTS = 4
LM_CAPACITY = 2048
LM_REQUESTS = 8
LM_PROMPTS = (256, 1536)          # prompt lengths drawn in this range
LM_MAX_NEW = 32
LM_CHECK_TOKENS = 512             # the card-against-CPU prompt
#: kernel tolerances.  float32: flash absolute as tests/test_kernels.py;
#: SSD relative to max(1, max |y|) and max(1, max |h|) (outputs reach ~30
#: at the model's shapes).  bf16: kernel and plain version both compute in
#: float32 from the same bf16 inputs and round the output once, so each
#: element may differ by one bf16 step (2^-7 of its value) plus the float32
#: tolerance: |got - want| <= BF16_STEP x |want| + the float32 bound
FLASH_TOL = 3e-4
SSD_TOL = 3e-4
BF16_STEP = 2.0 ** -7
#: grouped GEMM: float32 max |err| <= GMM_TOL x max |plain|; bf16 each
#: element within one bf16 step plus that
GMM_TOL = 2e-4
#: the grouped GEMM's shapes: (E, C, d, f) of each call on the main path
#: (granite-moe-3b: a 1536-token prefill's w_in/w_gate and w_out, a decode
#: step at 4 slots), a capacity that leaves a ragged last 128-row tile, and
#: an odd shape whose every edge is ragged (rows the TMA cannot take: the
#: WMMA kernel)
GMM_SHAPES = {"prefill_in": (40, 384, 1536, 512),
              "prefill_out": (40, 384, 512, 1536),
              "decode": (40, 8, 1536, 512), "ragged_c": (40, 72, 1536, 512),
              "odd": (3, 37, 65, 41)}
#: the shapes timed beside torch.bmm
GMM_TIMED = ("prefill_in", "prefill_out", "decode")
#: the redesigned kernels, whose ptxas report must show no spills (every
#: kernel of the SSD backward: "ssd_bwd_")
NO_SPILL = ("flash_mma_kernel", "gmm_wgmma_kernel", "gmm_bwd_kernel",
            "ssd_cb", "ssd_chunk_state", "ssd_state_pass", "ssd_output",
            "saxpy_vec4", "nbody_pack", "nbody_tiles", "nbody_reduce",
            "flash_bwd_dot", "flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_dkdv_mma",
            "flash_bwd_dq_mma", "ssd_bwd_")
#: the head of each model (zamba2: one hybrid group; granite: 2 layers),
#: card (kernels, cuBLAS) against CPU (plain versions, CPU matmuls), same
#: parameters, for the last-token logits and the cache the head fills
#: (zamba2: the SSM state h; granite: k and v).  float32: max |card - CPU|
#: <= GROUP_F32_TOL x max |CPU|, and for k/v, which the cache stores in
#: bf16, each element within one bf16 step plus that.  bf16: with random
#: weights the head amplifies bf16 rounding until max-abs differences say
#: nothing (the CPU alone moves zamba2's logits by ~26% of their max between
#: bf16 and float32), so the bf16 card run is held to the CPU float32 run by
#: relative L2 norm, ||card bf16 - CPU f32|| / ||CPU f32||, under limits set
#: between the readings of sound runs and of runs with a deliberate fault
#: (chip_group_calibration.py, PERF.md)
GROUP_F32_TOL = 1e-3
#: whisper's head decodes from the bf16 cache each run wrote itself, where
#: one element a bf16 step apart (0.25 in xk at |39|) moves its near-argmax
#: attention: its float32 decode logits are held by relative L2 under
#: DECODE_F32_REL (card f32 readings <= 2.8e-3, chip_group_calibration.py
#: family, seeds 1, 3, 5; max |err| reached 3.5x GROUP_F32_TOL's bound)
DECODE_F32_REL = 1e-2
GROUP_BF16_REL = {"zamba2-2.7b": {"logits": 0.3, "h": 0.05},
                  "granite-moe-3b-a800m": {"logits": 0.5, "k": 0.08,
                                           "v": 0.08, "moe": 0.1},
                  "mamba2-1.3b": {"logits": 0.05, "h": 0.05},
                  "minicpm-2b": {"logits": 0.4, "k": 0.1, "v": 0.1},
                  "gemma2-2b": {"logits": 0.05, "k_local": 0.01,
                                "v_local": 0.01, "k_global": 0.05,
                                "v_global": 0.05},
                  "internvl2-26b": {"logits": 0.56, "k": 0.09, "v": 0.09},
                  "mixtral-8x22b": {"logits": 0.5, "k": 0.09, "v": 0.09},
                  "command-r-plus-104b": {"logits": 0.55, "k": 0.09,
                                          "v": 0.09},
                  "whisper-large-v3": {"logits": 0.5, "k": 0.01, "v": 0.01,
                                       "xk": 0.12, "xv": 0.12,
                                       "decode": 0.4}}
#: the later entries' readings (chip_group_calibration.py family, prompt
#: seeds 1, 3, 5; PERF.md): sound bf16 runs (card, and CPU where it runs)
#: against the planted faults (flash: the causal mask dropped, a key tile
#: misplaced, the scale 1/hd; SSD: B and C swapped, dt one position late;
#: MoE: experts' w_in swapped, w_in and w_gate swapped, no capacity drop,
#: weights not renormalised):
#:   mamba2 logits <= 0.0144 vs >= 0.288, h <= 0.0113 vs >= 0.899 (the SSD
#:   state carried across chunks decays to nothing within a 256-token
#:   chunk at the init's A = -1: dropping the carry does not show);
#:   minicpm logits <= 0.193 vs >= 0.689, k/v <= 0.0270 vs >= 0.229;
#:   gemma2 logits <= 0.0071 vs >= 0.545, global k/v <= 0.0117 vs >=
#:   0.536; its local k/v come before any attention (no fault reaches
#:   them: 0.0038 and 0.0033, limits 2.7-3x that);
#:   internvl2 (with its frontend embeddings) logits <= 0.522 vs >=
#:   0.595, the narrowest gap, k/v <= 0.0517 vs >= 0.127;
#:   mixtral at 2 layers, against the plain float32 run on the card,
#:   logits <= 0.409 vs >= 0.619, k/v <= 0.0598 vs >= 0.131 (no MoE fault
#:   shows in bf16 past the attention output: 0.229-0.412; the float32
#:   check, within 1e-5 of its bound's scale when sound, is the MoE's);
#:   command-r-plus at 2 layers logits <= 0.452 vs >= 0.646, k/v <=
#:   0.0642 vs >= 0.125;
#:   whisper's head (its first encoder and decoder layers, a 224-token
#:   prompt over 1500 frames, 3 decode steps; faults also: the encoder
#:   causal, the cross-attention fed the decoder's own stream, the
#:   sinusoids left out, the decode position one row late) logits <=
#:   0.259 vs >= 0.726, xk/xv <= 0.0385 vs >= 0.252, decode <= 0.276 vs
#:   >= 0.524 (the late position; the others >= 0.542); k/v come before
#:   any attention (no fault reaches them: <= 0.00316, limits ~3x that);
#:   with one decoder layer the causal mask dropped moves neither the last
#:   token's logits nor the cache, and the cross-attention fed the
#:   decoder's stream only the logits (>= 1.331)
#: granite's head: its first layers
MOE_CHECK_LAYERS = 2
#: the training phase: granite at full width, batch x sequence tokens a
#: step, the reference launcher's recipe (cosine schedule, lr 3e-3), no
#: activation checkpointing (it fits: PERF.md section 4)
TRAIN_ARCH = "granite-moe-3b-a800m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 512, 4, 3e-3
TRAIN_REMAT = "none"
#: flash backward: float32 gradients max |err| <= BWD_TOL x max |plain|;
#: bf16 inputs each element within one bf16 step plus that, plus for dq/dk
#: how far D = rowsum(dO o) moves with o rounded to bf16
#: (tests/flash_bwd_bounds.py)
BWD_TOL = 1e-4
#: the gradient head check, on granite's first MOE_CHECK_LAYERS layers and
#: the full-width embedding: the loss's gradients on one 1 x TRAIN_SEQ batch
#: by parameter group, card float32 held to the CPU's float32 plain ones by
#: relative L2 under GRAD_F32_REL.  In bf16 the head's gradients are noise
#: at these random weights (q and k reach ~14 an element, bf16 rounding
#: moves scores by ~1 and flips which key wins: card and CPU bf16 both read
#: 0.94-1.36 against CPU float32, as far as a fault), so they are reported,
#: not bounded; bf16 is bounded on the first layer's MoE FFN alone, on the
#: CPU float32 run's input to it and one output gradient shared by every
#: run, under GRAD_BF16_REL by group.  Limits set between sound and faulty
#: readings (chip_group_calibration.py grad, data seeds 1, 3, 5; PERF.md):
#: head f32 sound <= 1.21e-3, dK/dV swapped >= 0.757 in every group, one
#: expert's dw zeroed >= 0.0912 in experts; MoE FFN bf16 experts sound <=
#: 0.0238, that fault >= 0.117.  No calibrated fault reaches the MoE FFN's
#: router or x gradients (sound <= 0.0439 and 0.0303): their limits are
#: 2-3x the sound readings.
GRAD_GROUPS = ("embed", "attn", "router", "experts", "norms")
MOE_GRAD_GROUPS = ("router", "experts", "x")
GRAD_F32_REL = 1e-2
GRAD_BF16_REL = {"router": 0.1, "experts": 0.06, "x": 0.1}
#: zamba2's training phase: the same batch, steps, lr and schedule, under
#: HYBRID_TRAIN_REMAT: no activation checkpointing (it fits at a 65.3 GiB
#: peak; PERF.md section 4)
HYBRID_TRAIN_ARCH = "zamba2-2.7b"
HYBRID_TRAIN_REMAT = "none"
#: SSD backward: every gradient max |err| <= SSD_BWD_TOL x max |plain|, as
#: the CPU emulation of the kernel is held (tests/test_torch_ssd_bwd_emu.py)
SSD_BWD_TOL = 1e-4
#: zamba2's gradient head check, on its first hybrid group and the
#: full-width embedding: the loss's gradients on one 1 x TRAIN_SEQ batch by
#: parameter group (the Mamba2 projections w_z/w_x/w_B/w_C/w_dt/w_out,
#: their scalars A_log/D/dt_bias, the convolutions, the attention block,
#: the norms, the embedding), card float32 against the CPU's float32 plain
#: ones by relative L2 under HYBRID_GRAD_F32_REL.  The limit sits between
#: sound and faulty readings (chip_group_calibration.py grad, data seeds 1,
#: 3, 5; PERF.md): sound <= 4.73e-4 in every group; each SSD-backward
#: fault >= 0.016 in the groups it reaches (the reverse state pass skipped
#: 0.0161-0.0264 everywhere but the attention block, which follows the
#: Mamba2 layers; dB and dC swapped >= 1.17 there; dA zeroed 0.249-0.261 in
#: ssm_scalars).  bf16 gradients are noise at these random weights (card
#: and CPU bf16 both 0.86-1.05 against CPU float32, as far as a fault), so
#: they are reported, not bounded.
HYBRID_GRAD_GROUPS = ("embed", "ssm_proj", "ssm_scalars", "conv", "attn",
                      "norms")
HYBRID_GRAD_F32_REL = 5e-3
#: AdamW's kernels (csrc/adamw.cu) at ADAMW_ARCH's parameter shapes (bf16
#: parameters and gradients, float32 moments warm from a step; as many
#: tensors, in the model's order, as fit beside the plain run's copies):
#: the update bit for bit against the plain loop at the same scale; the
#: norm within ADAMW_NORM_RTOL of torch's sums (float32 sums in another
#: order: ~1e-7 seen at 3.3e8 elements), its two runs the same bits
ADAMW_ARCH = TRAIN_ARCH
ADAMW_NORM_RTOL = 1e-5
#: the microbatch accumulation's check on TRAIN_ARCH's model
#: (``grad_accum_phase``): one TRAIN_BATCH x TRAIN_SEQ batch at this many
#: microbatches, the cell runtime's count for a model of its size
ACCUM_MICROBATCHES = 4
#: the kernels' names in a profile (summed as "adamw" in train profiles)
ADAMW_KERNELS = ("adamw_chunks", "sumsq_chunks", "sumsq_tensors",
                 "sum_vector")
#: TRAIN_ARCH's steps with the kernels against a second run from the same
#: weights in this process with the plain update (the eager loop) at the
#: kernels' norm: every step's loss and gradient norm the same bits (the
#: update is bit-identical at one scale); and each step's plain norm (the
#: eager sums) within ADAMW_NORM_RTOL of the kernels'.  With the plain norm
#: driving the clip too, the two runs part after step 2: the norms differ
#: in their last bits, the scale with them, a few bf16 parameters round
#: the other way, and at granite's initialisation a step's gradient norm
#: moves 1.4-1.8x from step to step in one run (ROADMAP.md section 3 item
#: 13): the later norms then hold to no useful tolerance
#: the profiled window: one prefill of the largest prompt, decode steps
PROFILE_DECODE_STEPS = 8
#: the decode step's CUDA graph against the eager step, for these archs
#: (every arch serves through the graph): DECODE_GRAPH_STEPS greedy steps
#: from one prefilled cache and its first tokens, eager and graphed in
#: turns (eager, graph, graph, eager); gemma2 past its window, whisper
#: over its frames
DECODE_GRAPH_ARCHS = ("zamba2-2.7b", "granite-moe-3b-a800m", "gemma2-2b",
                      "whisper-large-v3")
DECODE_GRAPH_STEPS = 8
#: the decode kernels' part: every decode arch's shapes at LM_SLOTS slots,
#: a step DECODE_AHEAD positions past the longest prompt (gemma2's past its
#: window, whisper's past its prompt); the bf16 outputs within one bf16
#: step and DECODE_ATOL x max |plain|, the float32 state within
#: SSD_STATE_RTOL x max |plain|; each timed in turns, DECODE_REPS calls in
#: a CUDA graph (``graph_ms``)
DECODE_AHEAD, DECODE_ATOL, SSD_STATE_RTOL, DECODE_REPS = 16, 1e-4, 1e-5, 50
#: the archs whose decode shapes the part covers, and the shape of each
#: kernel's line in the ``kernels`` record
DECODE_ARCHS = (LM_ARCHS + ("mamba2-1.3b", "minicpm-2b", "gemma2-2b",
                            "nemotron-4-15b", "internvl2-26b",
                            "mixtral-8x22b", "command-r-plus-104b",
                            "whisper-large-v3"))
DECODE_REPORTED = {"rmsnorm": "zamba2-2.7b gated 5120",
                   "rope_cache_write": "granite-moe-3b-a800m",
                   "decode_attention": "granite-moe-3b-a800m",
                   "ssd_decode_step": "zamba2-2.7b"}
#: the decode step with the kernels against the same step with the plain
#: versions: the logits' relative L2 at every step, each step from a shared
#: cache, at the model's head (``head_decode_parity``) in float32.  At
#: random init the full-depth step is chaotic (the attention is near
#: argmax, head_prefill): one bf16 step of a norm's output flips near-tied
#: keys, the plain bf16 step is itself about 1 from the float32 one, and
#: even float32 rounding grows over the layers; the full-depth distances
#: (bf16 graphs, float32 steps) and the head's in bf16 are printed
DECODE_LOGITS_REL = 2e-2
#: profiler windows (of 4 calls each) a replay's and an eager call's device
#: operations are counted over, at most, a pair (one of each) at a time
#: until the two agree, a kernel's launches a call being the median over
#: its side's windows: a window can miss or take in launches at its edges
#: (seen: a third of a replay missed, 2 launches of a kernel taken in; 8 of
#: granite's 4691 prefill replay launches missed in two windows of three),
#: and a count that one window of two misses, or one of three or more,
#: holds (``matched_launches``)
LAUNCH_WINDOWS = 5
#: the prefill as one CUDA graph per prompt length against the eager
#: prefill, for these archs (every served arch prefills through the
#: graphs; mamba2, minicpm and gemma2 are the host-bound eager prefills):
#: two prompt lengths, one drawn from seed 9 in the lower half of
#: LM_PROMPTS (with a ragged SSD tail on an SSM stack) and the longest
PREFILL_GRAPH_ARCHS = LM_ARCHS + ("mamba2-1.3b", "minicpm-2b", "gemma2-2b")
#: prefills of each kind a turn (eager, graph, graph, eager) at each length
PREFILL_GRAPH_CALLS = 3
#: the full-width prefill the launch phase holds the dry-run against
CHECKED_PREFILL_ARCH = "zamba2-2.7b"
CHECKED_PREFILL_TOKENS = 1536
#: where the families' phases run (the card; a rehearsal on the host sets
#: "cpu")
CARD = "cuda"
#: the other families, served in turn at full width and depth (bf16, random
#: weights from seed 0) behind ServeEngine: 4 slots, capacity 2048, 4
#: requests of 256-1536 prompt tokens and 16 new tokens each
FAMILY_ARCHS = ("mamba2-1.3b", "minicpm-2b", "gemma2-2b", "nemotron-4-15b",
                "internvl2-26b")
FAMILY_REQUESTS, FAMILY_MAX_NEW = 4, 16
#: their head checks (one model of each family: ssm, dense, local/global,
#: vlm; nemotron's dense stack is minicpm's with another MLP, both plain
#: PyTorch around the same flash kernel); the CPU's bf16 run is left out
#: where the head is too large for the CPU in the run's time
HEAD_ARCHS = ("mamba2-1.3b", "minicpm-2b", "gemma2-2b", "internvl2-26b")
HEAD_NO_CPU_BF16 = ("gemma2-2b", "internvl2-26b", "whisper-large-v3")
#: gemma2 past its sliding window: one request of WINDOW_PROMPT tokens at
#: capacity WINDOW_CAPACITY, then WINDOW_DECODE decode steps through the
#: rolling local cache
WINDOW_ARCH = "gemma2-2b"
WINDOW_PROMPT, WINDOW_CAPACITY, WINDOW_DECODE = 5120, 8192, 8
#: the VLM's stub frontend: one direct prefill with frontend embeddings of
#: (1, frontend_positions, d_model) from generator seed 7
VLM_ARCH = "internvl2-26b"
#: the configurations too large for one card, at full width with their depth
#: cut to CUT_LAYERS (mixtral's 56 layers hold 1.41e11 parameters, 281 GB in
#: bf16; command-r-plus's 64 hold 1.07e11, 214 GB): one CUT_PROMPT-token
#: prefill and CUT_DECODE decode steps on the kernels, and the same model
#: in float32 through the kernels and through the plain versions on the
#: card at LM_CHECK_TOKENS tokens
CUT_ARCHS = ("mixtral-8x22b", "command-r-plus-104b")
CUT_LAYERS, CUT_PROMPT, CUT_DECODE = 2, 1536, 8
#: trained in turn at full width and depth, TRAIN_STEPS steps of
#: TRAIN_BATCH x TRAIN_SEQ tokens, the launcher's recipe for the arch
#: (minicpm: WSD), no activation checkpointing (each fits: PERF.md)
FAMILY_TRAIN_ARCHS = ("mamba2-1.3b", "minicpm-2b", "gemma2-2b")
FAMILY_TRAIN_REMAT = "none"
#: their gradient head checks: the head's gradients on one 1 x TRAIN_SEQ
#: batch by parameter group, card float32 against the CPU's float32 plain
#: ones by relative L2 under FAMILY_GRAD_F32_REL; bf16 reported.  Readings
#: (chip_group_calibration.py family, data seeds 1, 3, 5): sound mamba2 <=
#: 8.1e-6, minicpm <= 4.3e-4, gemma2 <= 5.1e-5; faults: the SSD backward's
#: reverse state pass skipped >= 0.0165 in every group, dB and dC swapped
#: >= 0.656, dA zeroed 0.341-0.389 in ssm_scalars; the flash backward's dK
#: and dV swapped >= 0.837; gemma2's softcap left out of the backward NaN
FAMILY_GRAD_GROUPS = {"mamba2-1.3b": ("embed", "ssm_proj", "ssm_scalars",
                                      "conv", "norms"),
                      "minicpm-2b": ("embed", "attn", "ffn", "norms"),
                      "gemma2-2b": ("embed", "attn", "ffn", "norms")}
FAMILY_GRAD_F32_REL = 5e-3
#: repro_torch.examples.train_lm on the card: a first run to TRAIN_LM_STEPS[0]
#: (saved at its end), a second from the same directory to
#: TRAIN_LM_STEPS[1].  The loss is not held to a fall: with the reference's
#: recipe and init it does not fall in 300 steps, in this port on the card
#: (9.72 -> 9.83) or in the JAX package's example on the CPU (ROADMAP.md
#: section 3).  The resume is what the phase checks: 20 + 10 steps keep
#: the script inside its time on a slow host
TRAIN_LM_STEPS = (20, 30)
#: whisper-large-v3, served and trained at full width and depth: capacity
#: WHISPER_CAPACITY (Whisper's decoder context, arXiv:2212.04356); one batch
#: of WHISPER_BATCH requests, each with its own (enc_frames, d_model) frames
#: from generator seed 7 and a WHISPER_PROMPT-token prompt, decoded
#: WHISPER_DECODE greedy steps; then one request of WHISPER_LONG_PROMPT
#: tokens (the previous window's text, on which long-form transcription
#: conditions) decoded WHISPER_LONG_DECODE steps.  Training: TRAIN_BATCH x
#: WHISPER_CAPACITY tokens a step over TRAIN_BATCH x enc_frames frames,
#: remat none
WHISPER_ARCH = "whisper-large-v3"
WHISPER_CAPACITY = 448
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_DECODE = 4, 4, 60
WHISPER_LONG_PROMPT, WHISPER_LONG_DECODE = 224, 32
WHISPER_TRAIN_REMAT = "none"
#: its head check decodes HEAD_DECODE steps after a WHISPER_LONG_PROMPT
#: prompt (the decode position and the cross-attention cache are read only
#: there)
HEAD_DECODE = 3
#: its gradient head check: card float32 against CPU float32 by relative L2
#: under WHISPER_GRAD_F32_REL, by parameter group; bf16 reported.  Readings
#: (chip_group_calibration.py family, data seeds 1, 3, 5): sound <= 4.17e-3
#: (the decoder's FFN 3.2e-4; near-argmax attention at these weights: the
#: other families' heads read <= 4.3e-4); the flash backward's dK and dV
#: swapped >= 0.97 in every group but the decoder's FFN, which comes after
#: every attention; the encoder causal >= 0.557, the sinusoids left out
#: >= 0.669 in every group
WHISPER_GRAD_GROUPS = ("embed", "pos_embed", "enc_attn", "enc_ffn", "attn",
                       "xattn", "ffn", "norms")
WHISPER_GRAD_F32_REL = 1e-2

#: the launch phase: one dry-run cell of each shape, four archs among them
#: (a MoE and two with Mamba2 blocks), traced on the meta device
LAUNCH_CELLS = (("gemma2-2b", "train_4k"),
                ("granite-moe-3b-a800m", "prefill_32k"),
                ("mamba2-1.3b", "decode_32k"), ("zamba2-2.7b", "long_500k"))
#: the steps measured above that the dry-run's predictions are held to:
#: training at TRAIN_BATCH x TRAIN_SEQ, remat none, and the checked prefill
CHECKED_TRAIN_ARCHS = ("mamba2-1.3b", "gemma2-2b")
#: |predicted peak / max_memory_allocated - 1| allowed: the allocator's
#: rounding, cuBLAS's workspaces and what earlier phases leave allocated
#: are on the card and not in the meta trace.  On an H100 80GB HBM3 at
#: 700 W the ratios read 0.9973 (mamba2), 0.9977 (gemma2) and 0.9863
#: (zamba2's prefill), the card holding 0.065-0.142 GiB more than the
#: step's arguments before each
PEAK_MEMORY_TOL = 0.03

#: the multi-card layer's world-1 check (granite at full width and depth,
#: sharded on a (1, 1) mesh against unsharded): a prefill of MESH_PREFILL
#: tokens at capacity MESH_CAPACITY and one TRAIN_BATCH x TRAIN_SEQ step.
#: On one rank the same bf16 kernels run on the same tensors, but the
#: sharded step's float32 sums (the gradient norm over the parameters'
#: blocks) may come in another order, so the logits are held to a relative
#: L2 of MESH_LOGITS_REL (a fiftieth of the granite head check's
#: card-against-CPU 0.5), the loss and the gradient norm to
#: MESH_LOSS_RTOL (a norm that a few leaves dominate: see the leaves'
#: shares the phase prints); leaf by leaf, the
#: first moment (the clipped gradient, float32) to MESH_LOSS_RTOL of the
#: leaf's largest and the updated bf16 parameters to one bf16 step of each
#: element plus MESH_LOSS_RTOL of the learning rate (an AdamW step moves an
#: element at most about lr, and its rounding may land one step apart)
MESH_ARCH = "granite-moe-3b-a800m"
MESH_PREFILL, MESH_CAPACITY = 1536, 2048
MESH_LOGITS_REL = 1e-2
MESH_LOSS_RTOL = 1e-3
#: the sequence-parallel attention of one rank (``ops.
#: flash_attention_offset_bshd``: its query shard at an offset over the
#: keys up to it): minicpm-2b's train_4k cell on pod_32x8 splits 4096
#: tokens over the model axis of 8 (512 queries a rank) and 256 rows over
#: the data axis of 32 in 4 microbatches (2 rows); the last rank's shard
#: (offset 3584), without a window and with one shorter than the shard
#: (rows past it see no key before the shard: the case of the backward's
#: rule for a row without keys).  bf16: each call's output and dq are
#: rounded before they are merged, so the card test's bound: BWD_TOL and
#: 3e-3 of the largest value plus three bf16 steps of each element
FLASH_OFFSET_ARCH = "minicpm-2b"
FLASH_OFFSET_B, FLASH_OFFSET_SQ, FLASH_OFFSET_AT = 2, 512, 3584
FLASH_OFFSET_WINDOWS = (None, 384)
#: the quad_2x2 dry-run's cells: (arch, kind, seq, batch, cache capacity)
QUAD_CELLS = (("nemotron-4-15b", "train", 512, 8, None),
              ("internvl2-26b", "train", 512, 8, None),
              ("mixtral-8x22b", "prefill", 1536, 1, 2048),
              ("command-r-plus-104b", "prefill", 1536, 1, 2048))
#: one quad_2x2 cell traced in a process of its own
QUAD_SCRIPT = """
import json, sys
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.cells import cell_runtime
arch, kind, seq, b, cap = json.loads(sys.argv[2])
cfg = get_config(arch)
shape = ShapeSpec(f"{kind}_{b}x{seq}", kind, seq, b)
with dryrun.fake_world(4):
    rec = dryrun.trace_cell(cfg, shape, cell_runtime(cfg, shape),
                            dryrun.mesh_for("quad_2x2"), capacity=cap)
with open(sys.argv[1], "w") as f:
    json.dump(dict(rec, arch=arch, kind=kind, seq=seq, batch=b,
                   capacity=cap), f)
"""


def reset_counts() -> None:
    """Every kernel's launch counter, the grouped GEMM's bf16 counters by
    kernel and the flash backward's by path, to 0."""
    for c in [*ops.COUNTERS.values(), *gmm_mod.bf16_launches.values(),
              gmm_mod.bwd_launches, *flash_mod.bwd_paths.values()]:
        c.reset()


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def part(name: str):
    """Print the seconds the block took as a ``part <name>:`` line: where
    a phase's time goes."""
    t0 = time.perf_counter()
    yield
    print(f"part {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the card, from CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_us(event) -> float:
    """The device time of one ``torch.profiler`` key-average entry, in
    microseconds (the attribute's name differs between torch versions)."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def kernel_name(key: str) -> str:
    """A profiler's kernel name without its unnamed namespaces, return type
    and argument list."""
    name = key.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0]


def profiled_window(fn, reps: int):
    """{kernel name: (device us, launches)} of the CUDA kernels that
    ``torch.profiler`` saw over ``reps`` calls of ``fn``, after a warm-up
    window of as many."""
    from torch.profiler import ProfilerActivity, profile, schedule
    windows = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: windows.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    seen = {}
    for e in windows[-1] if windows else ():
        # the schedule's step annotation shows on the device too
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("ProfilerStep")):
            name = kernel_name(e.key)
            us, n = seen.get(name, (0.0, 0))
            seen[name] = (us + kernel_device_us(e), n + e.count)
    return seen


#: profiler sessions a measurement may take before it falls back to CUDA
#: events: late in a long process a session now and then reports no
#: device activity at all, and the next one sees it again
PROFILE_ATTEMPTS = 4


def profiled_kernels(fn, reps: int = 10):
    """{kernel name: (device ms a call, launches a call)} of the CUDA
    kernels ``fn`` launches, from ``torch.profiler`` over ``reps`` calls
    after a warm-up window of as many.  A profiler started late in a long
    process can still miss the first few kernels of its window, and a
    window can take in a few of the warm-up's last kernels, so each kernel
    counts its mean time a launch times its launches a call (the launches
    seen over ``reps``, rounded to the nearest: a kernel missed or taken in
    fewer than ``reps`` / 2 times moves no count, and a kernel seen fewer
    times than that is no kernel of a call).  A session that saw no
    device time is taken again, over twice the calls; after
    ``PROFILE_ATTEMPTS`` such sessions the result is empty."""
    for attempt in range(PROFILE_ATTEMPTS):
        n_reps = reps * 2 ** attempt
        seen = profiled_window(fn, n_reps)
        if sum(us for us, _ in seen.values()) > 0:
            return {name: (us / n / 1e3 * round(n / n_reps),
                           round(n / n_reps))
                    for name, (us, n) in seen.items() if round(n / n_reps)}
        print(f"torch.profiler saw no device time over {n_reps} calls "
              f"(session {attempt + 1} of {PROFILE_ATTEMPTS})", flush=True)
    return {}


def matched_launches(fn_a, fn_b, calls: int = 4, fold=lambda ops: ops):
    """{kernel name: launches a call} of ``fn_a`` and of ``fn_b``, each
    ``fold``-ed, from ``profiled_kernels`` windows of ``calls`` calls taken
    in pairs (one of each) until the two agree or LAUNCH_WINDOWS pairs are
    taken; each kernel's count the median over its side's windows (of two,
    the larger: a window that misses launches lowers a count; a window
    that saw nothing counts every kernel 0); kernels whose median is 0 left
    out.  Also the pairs taken."""
    windows = ([], [])

    def median(side):
        med = {k: sorted(w.get(k, 0) for w in side)[len(side) // 2]
               for k in set().union(*side)}
        return fold({k: n for k, n in med.items() if n})

    for taken in range(1, LAUNCH_WINDOWS + 1):
        for side, fn in zip(windows, (fn_a, fn_b)):
            side.append({k: n for k, (_, n)
                         in profiled_kernels(fn, calls).items()})
        a, b = median(windows[0]), median(windows[1])
        if a == b:
            break
    return a, b, taken


def device_ms(fn, reps: int = 10):
    """Device time per call of ``fn``, the sum of its CUDA kernels' device
    time (so the host's dispatch is not in it), in ms; and the kernels a
    call launches.  Where every profiler session saw nothing, the time is
    taken with CUDA events instead (host gaps between launches included)
    and the kernels a call are None."""
    kernels = profiled_kernels(fn, reps).values()
    if not kernels:
        ms = cuda_ms(fn, reps)
        print(f"device time from CUDA events instead: {ms:.4f} ms a call",
              flush=True)
        return ms, None
    return sum(ms for ms, _ in kernels), sum(n for _, n in kernels)


def bf16_excess(got: torch.Tensor, want: torch.Tensor, atol: float) -> float:
    """The largest |got - want| / (BF16_STEP x |want| + atol) over the
    elements: at most 1 when they differ by no more than one bf16 rounding
    step and ``atol``."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (BF16_STEP * want.abs() + atol)).max().item()


# ---------------------------------------------------------------------------
# inputs: the paper's sizes, made on the card from a seed, kept pinned
# ---------------------------------------------------------------------------

def pinned(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def make_inputs(seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    n = SIZE["saxpy"]
    saxpy = {"a": 2.5, "x": pinned(torch.randn(n, generator=g, device=dev)),
             "y": pinned(torch.randn(n, generator=g, device=dev))}
    planes = SIZE["segmentation"]
    vol = torch.empty((planes, 1024, 1024), pin_memory=True)
    for p in range(0, planes, 64):     # 256 MiB at a time
        vol[p:p + 64].copy_(torch.rand((min(64, planes - p), 1024, 1024),
                                       generator=g, device=dev) * 255)
    side = SIZE["filter_pipeline"]
    img = pinned(torch.rand((side, side), generator=g, device=dev) * 255)
    nb = SIZE["nbody"]
    pos = pinned(torch.randn((nb, 3), generator=g, device=dev))
    nbody = {"pos": pos, "vel": pinned(torch.zeros((nb, 3), device=dev)),
             "all_pos": pos,
             "mass": pinned(torch.rand(nb, generator=g, device=dev) + 0.1)}
    sig = pinned(torch.randn((SIZE["fft"], suite.FFT_ELEMS), generator=g,
                             device=dev))
    return {"saxpy": saxpy, "segmentation": {"vol": vol},
            "filter_pipeline": {"img": img, "seed": 7}, "nbody": nbody,
            "fft": {"sig": sig}}


def sct_for(name: str):
    build, _, _ = suite.BENCHMARKS[name]
    return build(SIZE[name])


# ---------------------------------------------------------------------------
# the runtime: hybrid host + CUDA-stream slots, a KB carried in
# ---------------------------------------------------------------------------

def make_scheduler(balancer=None) -> Scheduler:
    """Host fission slots from this machine's cores; OVERLAP streams on
    cuda:0; a KB holding one profile per SCT at the paper's smallest size
    class, which the first request at full size derives its
    configuration from."""
    kb = KnowledgeBase()
    for name in ORDER:
        sct = sct_for(name)
        _, classes, _ = suite.BENCHMARKS[name]
        dims = {"saxpy": (classes[0],), "segmentation": (classes[0], 1024,
                                                         1024),
                "filter_pipeline": (classes[0], classes[0]),
                "nbody": (classes[0], 3),
                "fft": (classes[0], suite.FFT_ELEMS)}[name]
        kb.store(Profile(sct_id=sct.unique_id(), workload=Workload(dims),
                         share_a=SHARE_A,
                         config=PlatformConfig(fission_level=FISSION,
                                               overlap=OVERLAP),
                         best_time=1.0))
    props = torch.cuda.get_device_properties(0)
    host = HostPlatform(DeviceInfo("cpu0", "cpu",
                                   compute_units=os.cpu_count() or 1))
    accel = AcceleratorPlatform(
        [DeviceInfo("gpu0", "gpu", compute_units=props.multi_processor_count)],
        max_overlap=OVERLAP)
    return Scheduler(host=host, accel=accel, executor=ThreadedExecutor(),
                     kb=kb, balancer=balancer)


def first_partitioning(sched: Scheduler, sct, shapes):
    """The partitioning a first request of ``sct`` on arrays of ``shapes``
    runs under (the KB profile's slots and shares), for the kernel phase's
    main-path shapes."""
    host_slots = sched.host.topology[FISSION]
    slots = [ExecutionSlot(f"gpu0/q{i}", "gpu") for i in range(OVERLAP)] + \
        [ExecutionSlot(f"cpu0/f{i}", "cpu") for i in range(host_slots)]
    shares = [SHARE_A / OVERLAP] * OVERLAP + \
        [(1 - SHARE_A) / host_slots] * host_slots
    return build_plan(sct, shapes).partition(slots, shares)


def nbody_slot_targets(sched: Scheduler):
    """{bodies: one accelerator slot's targets} at each of the paper's
    N-body size classes."""
    return {n: first_partitioning(
        sched, suite.nbody_sct(n), {"pos": (n, 3), "vel": (n, 3),
                                    "all_pos": (n, 3), "mass": (n,)}).units[0]
            for n in suite.BENCHMARKS["nbody"][1]}


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn`` (its enqueue), after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version on the card
# ---------------------------------------------------------------------------

def kernel_phase(inputs, gpu_units, nbody_slots):
    dev = torch.device("cuda")
    results = {}

    # saxpy: one accelerator slot's slice; ragged N; a misaligned view
    a = inputs["saxpy"]["a"]
    u = gpu_units["saxpy"]
    x = inputs["saxpy"]["x"][:u].to(dev)
    y = inputs["saxpy"]["y"][:u].to(dev)
    err = (ops.saxpy(a, x, y) - ref.saxpy_ref(a, x, y)).abs().max().item()
    k = min(u - 3, 4_000_001)
    for xs, ys in [(x[:1_000_003], y[:1_000_003]), (x[1:1 + k], y[3:3 + k])]:
        torch.testing.assert_close(ops.saxpy(a, xs, ys),
                                   ref.saxpy_ref(a, xs, ys),
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ops.saxpy(a, x, y), ref.saxpy_ref(a, x, y),
                               rtol=1e-5, atol=1e-5)
    results["saxpy"] = dict(
        max_abs_err=err, ms=cuda_ms(lambda: ops.saxpy(a, x, y), 20),
        plain_ms=cuda_ms(lambda: ref.saxpy_ref(a, x, y), 20),
        library_ms=cuda_ms(lambda: torch.add(y, x, alpha=a), 20),
        shape=list(x.shape), tolerance="rtol 1e-5, atol 1e-5",
        bound=bound_ms(12.0 * u, 2.0 * u))

    # segmentation: exact; NaN -> 128; ragged and misaligned flat views
    u = gpu_units["segmentation"]
    vol = inputs["segmentation"]["vol"][:u].to(dev)
    vol.view(-1)[::1_000_003] = float("nan")
    got, want = ops.segmentation(vol), ref.segmentation_ref(vol)
    expect(torch.equal(got, want), "segmentation kernel == plain, exactly")
    flat = vol.view(-1)
    for v in (flat[:1_000_003], flat[1:1_000_002], vol[:3]):
        expect(torch.equal(ops.segmentation(v), ref.segmentation_ref(v)),
               f"segmentation exact on {tuple(v.shape)} "
               f"offset {v.storage_offset()}")
    n = vol.numel()
    results["segmentation"] = dict(
        max_abs_err=(got - want).abs().max().item(),
        ms=cuda_ms(lambda: ops.segmentation(vol), 10),
        plain_ms=cuda_ms(lambda: ref.segmentation_ref(vol), 10),
        library_ms=None, shape=list(vol.shape), tolerance="exact",
        bound=bound_ms(8.0 * n, 2.0 * n))

    # filter pipeline: one slot's rows; odd widths; a row-offset view
    u = gpu_units["filter_pipeline"]
    img = inputs["filter_pipeline"]["img"][:u].to(dev)
    seed = inputs["filter_pipeline"]["seed"]
    got, want = ops.filter_pipeline(img, seed), ref.filter_pipeline_ref(img,
                                                                        seed)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    for im in (img[:1001, :777].contiguous(), img[5:700],
               img[:64, :8191].contiguous()):
        torch.testing.assert_close(ops.filter_pipeline(im, seed),
                                   ref.filter_pipeline_ref(im, seed),
                                   rtol=1e-5, atol=1e-4)
    hw = img.numel()
    results["filter_pipeline"] = dict(
        max_abs_err=(got - want).abs().max().item(),
        ms=cuda_ms(lambda: ops.filter_pipeline(img, seed), 10),
        plain_ms=cuda_ms(lambda: ref.filter_pipeline_ref(img, seed), 3),
        library_ms=None, shape=list(img.shape),
        tolerance="rtol 1e-5, atol 1e-4",
        bound=bound_ms(8.0 * hw, FILTER_OPS * hw))

    # nbody: one slot's targets against every body at each of the paper's
    # size classes (the first N bodies), vs float64, repeated bit for bit;
    # ragged N.  The kernel line reports the main path's class.
    pos = inputs["nbody"]["pos"].to(dev)
    mass = inputs["nbody"]["mass"].to(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    classes = {}
    for n, n_i in nbody_slots.items():
        p, m, tgt = pos[:n], mass[:n], pos[:n_i]
        got = ops.nbody_accelerations(p, m, targets=tgt)
        want = ref.nbody_ref(p.double(), m.double(), targets=tgt.double())
        err = (got.double() - want).abs().max().item()
        scale = want.abs().max().item()
        expect(err <= NBODY_TOL * scale,
               f"nbody {n_i}x{n} max err {err} <= {NBODY_TOL} x max |acc| "
               f"{scale}")
        expect(torch.equal(got, ops.nbody_accelerations(p, m, targets=tgt)),
               f"nbody {n_i}x{n}: a repeated call is bit-identical")
        plan = nbody_mod.launch_plan(n_i, n, sms)
        classes[n] = dict(
            shape=[n_i, n], max_abs_err=err, max_abs_acc=scale,
            ms=cuda_ms(lambda: ops.nbody_accelerations(p, m, targets=tgt),
                       20),
            host_us=host_us(lambda: ops.nbody_accelerations(p, m,
                                                            targets=tgt)),
            splits=plan.splits, blocks=plan.blocks,
            bound=bound_ms(24.0 * n_i + 16.0 * n, 20.0 * n_i * n))
        print(f"kernel nbody class {n}: {classes[n]}", flush=True)
    for n_i, n_j in [(1000, 1001), (129, 32767)]:
        p, m = pos[:n_j], mass[:n_j]
        g2 = ops.nbody_accelerations(p, m, targets=p[:n_i])
        w2 = ref.nbody_ref(p.double(), m.double(), targets=p[:n_i].double())
        expect((g2.double() - w2).abs().max().item()
               <= NBODY_TOL * w2.abs().max().item(),
               f"nbody ragged {n_i}x{n_j}")
    n_j = pos.shape[0]
    main = classes[n_j]
    slots = [tuple(c["shape"]) for c in classes.values()]
    expect(main["shape"][0] == gpu_units["nbody"] and slots == NBODY_SLOTS,
           f"the timed classes {slots} are the main path's slots")
    tgt = pos[:main["shape"][0]]
    results["nbody"] = dict(
        main, plain_ms=cuda_ms(lambda: ref.nbody_ref(pos, mass, targets=tgt),
                               2),
        library_ms=None, classes=classes,
        tolerance=f"max |err| <= {NBODY_TOL} x max |acc| (float64 plain)")
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def check_outputs(name: str, arrays, run) -> float:
    """Hold one request's merged outputs against the plain versions on the
    card (``paper_suite.check_outputs``: the filter per slot slice, the FFT
    against numpy's float64 on 64 rows, N-body against float64); returns
    the largest absolute error."""
    return paper_suite.check_outputs(name, arrays, run.outputs,
                                     run.node_plan.part)


def gpu_segments(run) -> int:
    part = run.node_plan.part
    return sum(1 for s, u in zip(part.slots, part.units)
               if s.device_type != "cpu" and u > 0)


def units_by_class(run):
    part = run.node_plan.part
    gpu = sum(u for s, u in zip(part.slots, part.units)
              if s.device_type != "cpu")
    return {"gpu": gpu, "cpu": sum(part.units) - gpu,
            "slots": [s.device for s in part.slots]}


def main_path(sched: Scheduler, inputs):
    need = {k: 0 for k in ORDER if k not in NO_KERNEL}
    requests = []
    reset_counts()
    with Session(sched) as session:
        for name in ORDER:
            arrays = inputs[name]
            for r in range(REQUESTS):
                t0 = time.perf_counter()
                run = session.run(sct_for(name), **arrays).get()
                seconds = time.perf_counter() - t0
                expect(run.stats.ok, f"main {name} #{r} ran without a "
                       f"fault: {[f.message for f in run.stats.failures]}")
                err = check_outputs(name, arrays, run)
                if name not in NO_KERNEL:
                    need[name] += gpu_segments(run)
                requests.append(dict(
                    sct=name, request=r, action=run.action,
                    share_a=run.profile.share_a, seconds=seconds,
                    merge_bytes=run.stats.merge_bytes,
                    units=units_by_class(run), max_abs_err=err,
                    slot_seconds=run.stats.times))
                print(f"main {name} #{r}: {run.action} share_a="
                      f"{run.profile.share_a:.3f} {seconds:.3f}s "
                      f"units={units_by_class(run)['gpu']}gpu/"
                      f"{units_by_class(run)['cpu']}cpu "
                      f"merge_bytes={run.stats.merge_bytes}", flush=True)
    chain = chain_phase(inputs["filter_pipeline"], need)
    launches = {k: c.value for k, c in ops.COUNTERS.items()}
    for k, n in need.items():
        expect(launches[k] >= n and n > 0,
               f"{k}: {launches[k]} launches >= {n} accelerator segments")
    return requests, chain, launches


def chain_phase(arrays, need):
    """filter -> filter as one JobGraph: resident on the accelerator slots
    between the steps, bit-identical to the same graph merged between.

    The filter's row ids are local to each slot's slice, so the two graphs
    must run under one partitioning: each runs on a fresh scheduler whose
    load balancer never adjusts the KB profile's distribution."""
    side = SIZE["filter_pipeline"]
    outs = {}
    info = {}
    for residency in (None, False):
        session = Session(make_scheduler(LoadBalancer(trigger=math.inf)))
        g = JobGraph()
        first = g.add(suite.filter_pipeline_sct(side, dst="mid"),
                      residency=residency)
        g.add(suite.filter_pipeline_sct(side, src="mid", dst="out2"),
              after=first)
        t0 = time.perf_counter()
        h = session.submit(g, **arrays)
        res = h.result(timeout=600)
        seconds = time.perf_counter() - t0
        outs[residency] = res.outputs["out2"].clone()
        runs = [h.runs[n] for n in g.names()]
        for run in runs:
            need["filter_pipeline"] += gpu_segments(run)
        head = runs[0]
        info["resident" if residency is None else "merged"] = dict(
            seconds=seconds, handoff=head.stats.resident,
            merge_bytes=[r.stats.merge_bytes for r in runs])
        if residency is None:
            expect(head.stats.resident, "chain handoff stayed resident")
            resident = [r.stats.merge_bytes for r in runs if r.stats.resident]
            expect(resident and max(resident) == 0,
                   f"resident chain steps copied no bytes at merge: "
                   f"{resident}")
            handle = head.resident_handle
            on_card = [env["mid"].device.type
                       for env, slot in zip(handle.envs, handle.part.slots)
                       if slot.device_type != "cpu" and "mid" in env]
            expect(on_card and all(d == "cuda" for d in on_card),
                   f"resident accelerator-slot values on the card: {on_card}")
        session.shutdown()
        print(f"chain residency={residency}: {seconds:.3f}s "
              f"handoff={head.stats.resident}", flush=True)
    expect(torch.equal(outs[None], outs[False]),
           "resident chain bit-identical to the merged chain")
    return info


# ---------------------------------------------------------------------------
# phase 3b: the main path's own gates on CUDA-stream slots, the quickstart,
# and flash attention at head dims padded up to an instantiated one
# ---------------------------------------------------------------------------

def gates_phase():
    """The three gates of ``repro_torch.bench`` in this process, at their
    full sizes, each on its own schedulers and sessions, with the
    accelerator slots on CUDA streams of ``cuda:0``.  Every deterministic
    gate must hold; the wall-clock ones are recorded.  The telemetry
    smoke's trace goes to ``build/trace_torch.json``, and every clean
    accelerator slot span in it must last at least its work's CUDA-event
    time (the span closes after the stream's synchronize)."""
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    gates = {}
    for name, mod, n in (("locality", gate_locality, 1 << 20),
                         ("pipeline", gate_pipeline, 1 << 20)):
        t0 = time.perf_counter()
        res = mod.bench(False, n, "cuda")
        seconds = time.perf_counter() - t0
        det, wall = mod.deterministic_failures(res), mod.wall_failures(res)
        expect(not det, f"gate {name} on the card: {det}")
        gates[name] = dict(res, seconds=seconds, wall_failures=wall)
    loc, pipe = gates["locality"], gates["pipeline"]
    print(f"gate locality: hit_rate={loc['plan_cache_hit_rate']:.3f} "
          f"plan_cache={loc['recurrent']['plan_cache']} "
          f"resident_merge_bytes={loc['chain']['resident_merge_bytes']} "
          f"bit_identical={loc['bit_identical']}/"
          f"{loc['bit_identical_faulted']} "
          f"retries={loc['faulted_retries']} | wall: recurrent overhead "
          f"{loc['recurrent']['overhead_reduction_x']:.3f}x, chain "
          f"{loc['chain']['overhead_reduction_x']:.3f}x | "
          f"{loc['seconds']:.1f}s", flush=True)
    th, gpc, fus = pipe["threaded"], pipe["graph_plan_cache"], pipe["fusion"]
    print(f"gate pipeline: virtual_gain="
          f"{pipe['virtual_throughput']['throughput_gain_x']:.3f}x "
          f"in_flight={pipe['virtual_overlap']['max_concurrent_nodes']} "
          f"bit_identical={th['bit_identical']}/"
          f"{th['bit_identical_faulted']} node_retries={th['node_retries']} "
          f"graph_hits={gpc['graph_hits']} locks="
          f"{gpc['decide_locks_second']}/{gpc['plan_locks_second']} "
          f"preplanned={gpc['preplanned_nodes']}/{gpc['nodes']} "
          f"fused={fus['fused_actions']}/{fus['requests']} "
          f"fused_bit_identical={fus['bit_identical']}/"
          f"{fus['bit_identical_faulted']} | wall: throughput "
          f"{th['wall_throughput_gain_x']:.3f}x (floor 1.0: "
          f"{'held' if not pipe['wall_failures'] else 'missed'}), distinct "
          f"{th['wall_distinct_gain_x']:.3f}x | {pipe['seconds']:.1f}s",
          flush=True)

    trace_path = out_dir / "trace_torch.json"
    t0 = time.perf_counter()
    tel = gate_telemetry.smoke(str(trace_path), "cuda")
    expect(not tel["deterministic_failures"],
           f"gate telemetry_smoke on the card: "
           f"{tel['deterministic_failures']}")
    spans = gate_telemetry.slot_spans(json.loads(trace_path.read_text()))
    card = [sp for sp in spans if sp["device"].startswith("gpu")
            and "fault" not in sp["args"]]
    expect(card and all("device_ms" in sp["args"] for sp in card),
           f"accelerator slot spans carry their CUDA-event time: {card}")
    ratios = [sp["us"] / (sp["args"]["device_ms"] * 1e3) for sp in card]
    expect(min(ratios) >= 1.0,
           f"every accelerator slot span lasts at least its CUDA-event "
           f"time: span / device time {ratios}")
    gates["telemetry_smoke"] = dict(
        tel, seconds=time.perf_counter() - t0, trace=str(trace_path),
        card_slot_spans=[dict(device=sp["device"], us=sp["us"],
                              device_ms=sp["args"]["device_ms"])
                         for sp in card])
    print(f"gate telemetry_smoke: events={tel['trace_events']} "
          f"retry_spans={tel['retry_spans']} retries={tel['stats_retries']} "
          f"kinds={tel['event_kinds']} card slot spans={len(card)}, span / "
          f"CUDA-event time min {min(ratios):.3f} | wall: no-op span "
          f"{tel['noop_span_cost_us']:.3f} us (bound "
          f"{gate_telemetry.NOOP_SPAN_BOUND * 1e6:.0f})", flush=True)

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        quickstart.main(["--device", "cuda"])
    lines = buf.getvalue().strip().splitlines()
    expect(lines[-1] == "quickstart OK", f"quickstart on the card: {lines}")
    gates["quickstart"] = dict(lines=lines,
                               seconds=time.perf_counter() - t0)
    print("quickstart: " + " | ".join(lines), flush=True)
    return gates


#: head dims the flash kernels are not instantiated for, held on the card
#: through the padding (84: examples/train_lm.py's)
FLASH_PAD_DIMS = (84, 96)
#: the timed flash call: (B, H, KV, S) at the bf16 training shape's layout
FLASH_PAD_TIMED = (8, 24, 8, 512)


def flash_padding_phase():
    """Flash forward (with and without the log-sum-exp) and backward, bf16
    and float32, at head dims padded up to an instantiated one, GQA 4/2,
    causal and windowed, against the plain version at dim 80's bounds;
    then dim 84 timed beside 80 and 128 (the forward also by its device
    time alone, pads and slice included), each beside SDPA's forward and
    backward at the same shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {}
    before = ops.COUNTERS["flash_attention"].value, \
        ops.COUNTERS["flash_attention_bwd"].value
    calls = 0
    for hd in FLASH_PAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for name, kw in (("causal", dict(causal=True)),
                             ("window", dict(causal=True, window=40))):
                q, do = (torch.randn(2, 4, 150, hd, generator=g,
                                     device=dev).to(dtype)
                         for _ in range(2))
                k, v = (torch.randn(2, 2, 150, hd, generator=g,
                                    device=dev).to(dtype) for _ in range(2))
                got = ops.flash_attention(q, k, v, **kw)
                want = ref.attention_ref(q.float(), k.float(), v.float(),
                                         **kw)
                fwd = (bf16_excess(got, want, FLASH_TOL)
                       if dtype == torch.bfloat16
                       else (got - want).abs().max().item() / FLASH_TOL)
                expect(got.shape == q.shape and fwd <= 1.0,
                       f"flash hd {hd} {dtype} {name}: forward at {fwd:.3f} "
                       f"of its bound")
                both, _ = flash_grads_excess(q, k, v, do, kw)
                worst[f"hd{hd} {str(dtype)[6:]} {name}"] = max(fwd, both)
                calls += 1
    torch.cuda.synchronize()
    launched = (ops.COUNTERS["flash_attention"].value - before[0],
                ops.COUNTERS["flash_attention_bwd"].value - before[1])
    expect(launched == (2 * calls, calls),
           f"the padded calls launched the kernels: {launched}")

    B, H, KV, S = FLASH_PAD_TIMED
    timed = {}
    sdpa = lambda *t: F.scaled_dot_product_attention(*t, is_causal=True,
                                                     enable_gqa=True)
    for hd in (80, 84, 128):
        q, do = (torch.randn(B, H, S, hd, generator=g, device=dev)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, KV, S, hd, generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        fwd_device_ms, launched_a_call = device_ms(
            lambda: ops.flash_attention(q, k, v), 10)
        timed[hd] = dict(
            ms=cuda_ms(lambda: ops.flash_attention(q, k, v), 20),
            device_ms=fwd_device_ms, kernels_a_call=launched_a_call,
            bwd_ms=grad_ms(ops.flash_attention, (q, k, v), do, 10),
            # the yardstick at the same shapes: SDPA, forward and backward
            sdpa_ms=cuda_ms(lambda: sdpa(q, k, v), 20),
            sdpa_bwd_ms=grad_ms(sdpa, (q, k, v), do, 10),
            bound=flash_bound(B, H, KV, S, S, hd, torch.bfloat16),
            bwd_bound=flash_bwd_bound(B, H, KV, S, hd, torch.bfloat16))
    print(f"kernel flash_attention hd84 (bf16, causal, {B}x{H}/{KV}x{S}, "
          f"padded to 128): " + ", ".join(
              f"hd {hd} {t['ms']:.4f} ms (device {t['device_ms']:.4f} in "
              f"{t['kernels_a_call']} kernels; bound {t['bound'][0]:.4f}; "
              f"SDPA {t['sdpa_ms']:.4f}), backward {t['bwd_ms']:.4f} ms "
              f"(bound {t['bwd_bound'][0]:.4f}; SDPA backward "
              f"{t['sdpa_bwd_ms']:.4f})" for hd, t in timed.items())
          + f"; worst share of the bounds over hd {FLASH_PAD_DIMS}: "
          f"{max(worst.values()):.3f}", flush=True)
    return dict(worst=worst, launches=list(launched),
                timed={str(hd): t for hd, t in timed.items()},
                shape=list(FLASH_PAD_TIMED))


# ---------------------------------------------------------------------------
# phase 3c: the paper's experiments on this host (repro_torch.bench):
# Algorithm 1 searching the card's stream slots and the host's fission
# slots, hybrid against GPU-only
# ---------------------------------------------------------------------------

def paper_phase():
    """``hybrid --testbed host`` for the five SCTs at PAPER_SIZE (each
    cell: Algorithm 1, every evaluation without a fault, the tuned run and
    the GPU-only baseline re-timed in turns and their outputs held to the
    plain versions), ``profile_construction`` (FFT-256's trace) and
    ``fission``'s timed partition sweep.  Wall-clock numbers are printed,
    not gated.  Returns the record and the kernels' launches."""
    t0 = time.perf_counter()
    cells, launched = {}, {k: 0 for k in ops.COUNTERS}
    for name, size in PAPER_SIZE.items():
        reset_counts()
        c = paper_hybrid.host_cell(name, size, "cuda")
        counts = {k: cnt.value for k, cnt in ops.COUNTERS.items()}
        expect(c["evals"] == len(c["trace"]) > 0
               and math.isfinite(c["hybrid_time"]),
               f"paper hybrid {name}: Algorithm 1 returned a profile")
        if name not in NO_KERNEL:
            expect(counts[name] >= c["gpu_segments"] > 0,
                   f"paper hybrid {name}: {counts[name]} launches >= "
                   f"{c['gpu_segments']} accelerator segments")
        for k, n in counts.items():
            launched[k] += n
        c["launches"] = counts[name] if name not in NO_KERNEL else None
        cells[name] = c
        print(f"paper hybrid {name} {c['size']}: speedup={c['speedup']:.3f} "
              f"speedup_turns={c['speedup_turns']:.3f} gpu_share="
              f"{c['gpu_share']:.4f} fission={c['fission']} overlap="
              f"{c['overlap']} evals={c['evals']} hybrid_s="
              f"{c['hybrid_s']:.5f} gpu_only_s={c['gpu_only_s']:.5f} "
              f"search_s={c['search_s']:.1f} launches={c['launches']}/"
              f"{c['gpu_segments']} cores={c['host']['cores']} topology="
              f"{c['host']['topology']} max_abs_err={c['max_abs_err']}",
              flush=True)
    pc = paper_pc.collect(testbed="host", device="cuda")
    trace = pc["cell"]
    expect(trace["evals"] == len(trace["trace"]) > 0
           and math.isfinite(trace["best_time"]),
           "paper profile_construction: Algorithm 1 returned a profile")
    print(f"paper profile_construction fft {trace['size']}: evals="
          f"{trace['evals']} "
          f"best={trace['best_time']:.5f} s gpu_share="
          f"{trace['gpu_share']:.4f} fission={trace['fission']} overlap="
          f"{trace['overlap']} search_s={trace['search_s']:.1f} "
          f"max_abs_err={trace['max_abs_err']:.3g}", flush=True)
    sweep = paper_fission.timed_partition_sweep()
    seconds = time.perf_counter() - t0
    print("paper fission (b) saxpy 2^20 on host slots: "
          + ", ".join(f"x{r['partitions']} {r['seconds'] * 1e3:.3f} ms"
                      for r in sweep) + f" | paper phase {seconds:.1f} s",
          flush=True)
    return dict(hybrid=cells, profile_construction=pc["cell"],
                fission_real=sweep, host=pc["host"],
                seconds=seconds), launched


# ---------------------------------------------------------------------------
# phase 4: LM serving at full width, zamba2-2.7b then granite-moe-3b-a800m
# ---------------------------------------------------------------------------

def lm_kernel_phase(cfg):
    """Flash attention and the SSD scan against their plain versions on
    the card, at the model's prefill shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    H, hd = cfg.n_heads, cfg.head_dim
    results = {}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # flash: (1, H, S, hd) bf16 causal at a ragged S and the largest prompt
    worst, excess = 0.0, 0.0
    for S in (1000, LM_PROMPTS[1]):
        q, k, v = (randn(1, H, S, hd, dtype=bf16) for _ in range(3))
        got = ops.flash_attention(q, k, v)
        want = ref.attention_ref(q, k, v)
        ex = bf16_excess(got, want, FLASH_TOL)
        expect(ex <= 1.0, f"flash S={S}: |err| within one bf16 step + "
               f"{FLASH_TOL} (worst element at {ex:.3f} of its bound)")
        bshd = ops.flash_attention_bshd(*(t.transpose(1, 2).contiguous()
                                          for t in (q, k, v)))
        expect(torch.equal(bshd.transpose(1, 2), got),
               "flash in the model's (B, S, H, hd) layout == (B, H, S, hd)")
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        excess = max(excess, ex)
    # GQA + window + softcap + kv_len, float32, small
    kw = dict(window=64, logit_cap=30.0, kv_len=250)
    qs, ks, vs = randn(2, 8, 300, 64), randn(2, 2, 300, 64), randn(2, 2, 300,
                                                                   64)
    err_v = (ops.flash_attention(qs, ks, vs, **kw)
             - ref.attention_ref(qs, ks, vs, **kw)).abs().max().item()
    expect(err_v <= FLASH_TOL,
           f"flash GQA/window/softcap/kv_len: max err {err_v}")
    # the same in bf16 (the tensor-core kernel), and with every row masked
    ex_v = 0.0
    qb, kb, vb = (t.to(bf16) for t in (qs, ks, vs))
    for kwb in (kw, dict(window=8, kv_len=20)):
        ex = bf16_excess(ops.flash_attention(qb, kb, vb, **kwb),
                         ref.attention_ref(qb, kb, vb, **kwb), FLASH_TOL)
        expect(ex <= 1.0, f"flash bf16 {kwb}: worst element at {ex:.3f} "
               "of its bound")
        ex_v = max(ex_v, ex)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True), 20)
    results["flash_attention"] = dict(
        max_abs_err=worst, ms=cuda_ms(lambda: ops.flash_attention(q, k, v),
                                      20),
        plain_ms=cuda_ms(lambda: ref.attention_ref(q, k, v), 5),
        library_ms=lib, shape=list(q.shape), dtype="bfloat16",
        variants_max_abs_err=err_v, bf16_worst_share_of_bound=excess,
        bf16_variants_worst_share_of_bound=ex_v,
        tolerance=f"bf16: |err| <= 2^-7 |plain| + {FLASH_TOL} elementwise; "
                  f"f32 (GQA/window/softcap/kv_len): {FLASH_TOL}",
        bound=flash_bound(1, H, H, q.shape[2], q.shape[2], hd, bf16))
    expect(cfg.n_kv_heads == H, "zamba2's attention has as many kv heads")

    # ssd: x (1, S, nh*hd) float32 as the model feeds it, chunk 256, then a
    # tail of chunk 232 chained through h0; then the same in bf16
    s = cfg.ssm
    nh, shd, ds, Q = s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.chunk
    S, tail = LM_PROMPTS[1], 232
    x = randn(1, S + tail, nh * shd) * 0.5
    dt = F.softplus(randn(1, S + tail, nh))
    Bm, Cm = randn(1, S + tail, ds) * 0.5, randn(1, S + tail, ds) * 0.5
    A = -torch.exp(randn(nh) * 0.3)
    main = (x[:, :S], dt[:, :S], Bm[:, :S], Cm[:, :S], A)
    y1, h1 = ops.ssd_scan(*main, chunk=Q)
    y2, h2 = ops.ssd_scan(x[:, S:], dt[:, S:], Bm[:, S:], Cm[:, S:], A,
                          chunk=tail, h0=h1)
    wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=1)
    err_y = (torch.cat([y1, y2], 1) - wy).abs().max().item()
    err_h = (h2 - wh).abs().max().item()
    sy, sh = wy.abs().max().item(), wh.abs().max().item()
    expect(err_y <= SSD_TOL * max(1.0, sy) and err_h <= SSD_TOL * max(1.0, sh),
           f"ssd f32 + chained tail: y err {err_y} (max {sy}), h err "
           f"{err_h} (max {sh})")
    xb, Bb, Cb = x[:, :S].to(bf16), Bm[:, :S].to(bf16), Cm[:, :S].to(bf16)
    yb, hb = ops.ssd_scan(xb, dt[:, :S], Bb, Cb, A, chunk=Q)
    wyb, whb = ref.ssd_scan_ref(xb, dt[:, :S], Bb, Cb, A, chunk=Q)
    err_b = (yb.float() - wyb.float()).abs().max().item()
    ex_b = bf16_excess(yb, wyb, SSD_TOL * max(1.0, wyb.float().abs().max()
                                              .item()))
    expect(ex_b <= 1.0 and (hb - whb).abs().max().item()
           <= SSD_TOL * max(1.0, whb.abs().max().item()),
           f"ssd bf16: y err {err_b}, worst element at {ex_b:.3f} of its "
           "bound")
    results["ssd_scan"] = dict(
        max_abs_err=max(err_y, err_h), ms=cuda_ms(
            lambda: ops.ssd_scan(*main, chunk=Q), 10),
        plain_ms=cuda_ms(lambda: ref.ssd_scan_ref(*main, chunk=Q), 2),
        library_ms=None, shape=list(main[0].shape), dtype="float32",
        max_abs_y=sy, max_abs_h=sh, bf16_max_abs_err=err_b,
        bf16_worst_share_of_bound=ex_b,
        tolerance=f"f32: {SSD_TOL} x max(1, max |y|) and x max(1, max |h|); "
                  f"bf16 y: 2^-7 |plain| + {SSD_TOL} x max(1, max |y|) "
                  "elementwise",
        bound=ssd_bound(1, S, Q, nh, shd, ds, torch.float32),
        bound_split_tf32=ssd_split_bound(1, S, Q, nh, shd, ds,
                                         torch.float32),
        kernels_per_call=ssd_mod.KERNELS_PER_CALL)
    torch.cuda.synchronize()
    return results


def moe_kernel_phase(cfg):
    """The grouped GEMM against its plain version on the card at the
    model's shapes and an odd one, in float32 and bf16, weights of std
    1/sqrt(d) as the model draws them; timed (with ``torch.bmm`` as the
    library's yardstick) at the prefill and decode shapes in bf16.  Then
    flash attention at granite's own shape (head_dim 64, GQA 24/8)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    m = cfg.moe
    E, d, f = m.n_experts, cfg.d_model, m.d_ff
    expect((GMM_SHAPES["prefill_in"], GMM_SHAPES["decode"])
           == ((E, 384, d, f), (E, 8, d, f)),
           "GMM_SHAPES are the model's")
    checks, timed = {}, {}
    for name, (E_, C, d_, f_) in GMM_SHAPES.items():
        for dtype in (torch.float32, bf16):
            x = torch.randn((E_, C, d_), generator=g, device=dev).to(dtype)
            w = (torch.randn((E_, d_, f_), generator=g, device=dev)
                 * d_ ** -0.5).to(dtype)
            path = ("f32" if dtype == torch.float32 else
                    "tma" if gmm_mod.tma_rows(x, w) else "wmma")
            got, want = ops.grouped_matmul(x, w), ref.grouped_matmul_ref(x, w)
            expect(got.dtype == dtype and tuple(got.shape) == (E_, C, f_),
                   f"grouped_matmul {name}: dtype and shape")
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            if dtype == torch.float32:
                ex = err / (GMM_TOL * scale)
            else:
                ex = bf16_excess(got, want, GMM_TOL * scale)
            expect(ex <= 1.0, f"grouped_matmul {name} {dtype}: max err {err} "
                   f"(max |plain| {scale}), worst element at {ex:.3f} of "
                   "its bound")
            checks[f"{name}/{str(dtype)[6:]}"] = dict(
                max_abs_err=err, max_abs=scale, share_of_bound=ex,
                kernel=path)
            if dtype == bf16 and name in GMM_TIMED:
                timed[name] = dict(
                    ms=cuda_ms(lambda: ops.grouped_matmul(x, w), 20),
                    plain_ms=cuda_ms(lambda: ref.grouped_matmul_ref(x, w),
                                     5),
                    library_ms=cuda_ms(lambda: torch.bmm(x, w), 20),
                    bound=gmm_bound(E_, C, d_, f_, dtype), max_abs_err=err)
    expect(all(checks[f"{n}/bfloat16"]["kernel"] == "tma"
               for n in GMM_TIMED),
           "the model's bf16 shapes take the TMA + wgmma kernel")
    main = timed["prefill_in"]
    results = {"grouped_matmul": dict(
        main, shape=list(GMM_SHAPES["prefill_in"]), dtype="bfloat16",
        prefill_out=timed["prefill_out"], decode=timed["decode"],
        checks=checks,
        max_abs_err=max(c["max_abs_err"] for k, c in checks.items()
                        if k.endswith("bfloat16") and not
                        k.startswith("odd")),
        tolerance=f"f32: max |err| <= {GMM_TOL} x max |plain|; bf16: "
                  f"|err| <= 2^-7 |plain| + {GMM_TOL} x max |plain| "
                  "elementwise")}

    # flash at granite's attention: (1, 24, 1536, 64) queries, 8 kv heads
    H, KV, hd, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, LM_PROMPTS[1]
    q = torch.randn((1, H, S, hd), generator=g, device=dev).to(bf16)
    k = torch.randn((1, KV, S, hd), generator=g, device=dev).to(bf16)
    v = torch.randn((1, KV, S, hd), generator=g, device=dev).to(bf16)
    got, want = ops.flash_attention(q, k, v), ref.attention_ref(q, k, v)
    ex = bf16_excess(got, want, FLASH_TOL)
    expect(ex <= 1.0, f"flash GQA {H}/{KV} hd {hd}: worst element at "
           f"{ex:.3f} of its bound")
    results["flash_attention_gqa"] = dict(
        max_abs_err=(got.float() - want.float()).abs().max().item(),
        ms=cuda_ms(lambda: ops.flash_attention(q, k, v), 20),
        plain_ms=cuda_ms(lambda: ref.attention_ref(q, k, v), 5),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20),
        shape=[1, H, KV, S, hd], dtype="bfloat16",
        bf16_worst_share_of_bound=ex,
        tolerance=f"bf16: |err| <= 2^-7 |plain| + {FLASH_TOL} elementwise",
        bound=flash_bound(1, H, KV, S, S, hd, bf16))
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# the decode step's kernels at every decode arch's shapes
# ---------------------------------------------------------------------------

def graph_ms(fn, reps: int = DECODE_REPS) -> float:
    """Milliseconds a call of ``fn`` takes on the device with the host out
    of the way: ``reps`` calls captured in one CUDA graph after a warm-up
    call, one replay timed with CUDA events after a warm-up replay (a
    decode kernel's launch from Python takes longer than the kernel).  The
    capture adds to the launch counters; every main path resets them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timed_turns(fns):
    """{name: [ms, ms]} of each of ``fns`` ({name: fn}) by ``graph_ms``,
    in turns: in order, then in reverse (kernel, plain, library, library,
    plain, kernel)."""
    out = {n: [] for n in fns}
    for n in [*fns, *reversed(list(fns))]:
        out[n].append(graph_ms(fns[n]))
    return out


def decode_cases():
    """Each decode kernel call the served archs make, by shape: {kernel:
    {case name: (cfg, shape dict)}}.  The norm at each d_model with its
    residual and at each d_inner alone (the gated norm); per attention
    arch its rope write and its attention at the engine's cache (LM_SLOTS
    slots, LM_CAPACITY rows; gemma2's rolling local cache and its global
    one at WINDOW_CAPACITY, past the window; whisper's self-attention at
    WHISPER_CAPACITY without rope and its cross-attention); the SSD step
    of each Mamba2 arch."""
    B = LM_SLOTS
    cases = {k: {} for k in DECODE_PLAIN}
    for arch in DECODE_ARCHS:
        cfg = get_config(arch)
        d = cfg.d_model
        cases["rmsnorm"].setdefault(f"d {d} residual", (cfg, dict(
            d=d, residual=True)))
        if cfg.ssm is not None:
            s = cfg.ssm
            di = s.d_inner(d)
            cases["rmsnorm"][f"{arch} gated {di}"] = (cfg, dict(
                d=di, residual=False))
            cases["ssd_decode_step"][arch] = (cfg, dict(
                nh=s.n_heads(d), hd=s.head_dim, ds=s.d_state,
                K=s.conv_dim))
        if cfg.family == "ssm":
            continue
        if cfg.enc_dec:
            cap, pos = WHISPER_CAPACITY, WHISPER_PROMPT + DECODE_AHEAD
        elif cfg.local_global_pattern:
            cap, pos = WINDOW_CAPACITY, WINDOW_PROMPT + DECODE_AHEAD
        else:
            cap, pos = LM_CAPACITY, LM_PROMPTS[1] + DECODE_AHEAD
        shapes = lm_mod.cache_defs(cfg, B, cap)
        keys = (("k_local", "local"), ("k_global", "global")
                ) if cfg.local_global_pattern else (("k", ""),)
        for key, tag in keys:
            rows = shapes[key][2]
            window = (cfg.sliding_window if cfg.sliding_window
                      and rows == cfg.sliding_window else None)
            shape = dict(H=cfg.n_heads, KV=cfg.n_kv_heads, hd=cfg.head_dim,
                         S=rows, pos=pos, window=window,
                         cap=cfg.attn_softcap, scale=cfg.attn_scale,
                         rope=cfg.use_rope)
            name = f"{arch} {tag}".strip()
            cases["rope_cache_write"][name] = (cfg, shape)
            cases["decode_attention"][name] = (cfg, shape)
        if cfg.enc_dec:
            frames = shapes["xk"][2]
            cases["decode_attention"][f"{arch} cross"] = (cfg, dict(
                H=cfg.n_heads, KV=cfg.n_kv_heads, hd=cfg.head_dim, S=frames,
                pos=frames - 1, window=None, cap=cfg.attn_softcap,
                scale=cfg.attn_scale, rope=False))
    return cases


def conv1_in_order(val: torch.Tensor, w: torch.Tensor, buf: torch.Tensor):
    """``ref._conv1`` with the taps summed k = 0..K-1 one rounded float32
    op at a time, the SSD kernel's order (the plain version's einsum leaves
    the order to the matmul library): a check-only stand-in, so that the
    kernel's bf16 conv outputs, which feed the float32 state, can be held
    bit for bit and the state to SSD_STATE_RTOL."""
    window = torch.cat([buf.to(val.dtype), val], dim=1)
    wf = w.float()
    y = window[:, 0].float() * wf[0]
    for k in range(1, w.shape[0]):
        y = y + window[:, k].float() * wf[k]
    return F.silu(y.to(val.dtype)[:, None]), window[:, 1:]


@contextlib.contextmanager
def conv_in_order():
    """``ref.ssd_decode_step_ref`` on ``conv1_in_order`` inside."""
    saved = ref._conv1
    ref._conv1 = conv1_in_order
    try:
        yield
    finally:
        ref._conv1 = saved


def decode_kernel_phase():
    """The decode step's kernels against their plain versions on the card
    at every decode arch's shapes (``decode_cases``), bf16 as the models
    call them.  Pass: each output within one bf16 step and DECODE_ATOL x
    max |plain| (``bf16_excess`` <= 1), the cache rows' v and the conv
    buffers the same bits, the float32 state within SSD_STATE_RTOL x max
    |plain|, an int and a tensor position the same bits.  The SSD step is
    held to its plain version with the conv taps summed in the kernel's
    order (``conv_in_order``); its distance from the plain version as it
    is, y's share of the bound and the state's relative error, is
    reported beside.  Each timed in
    turns against its plain version and, where one PyTorch call computes
    the same function, that call (``F.rms_norm`` of the norm without a
    residual; SDPA with a boolean mask where there is no softcap).  Returns
    {kernel: its record at DECODE_REPORTED's shape, with every shape's}."""
    dev = torch.device(CARD)
    g = torch.Generator(device=dev).manual_seed(33)
    bf16 = torch.bfloat16
    B = LM_SLOTS

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(shape, generator=g, device=dev) * scale
                ).to(dtype)

    def record(name, case, got_want, fns, bound, ok_extra=True, **extra):
        worst = max(bf16_excess(a, b, DECODE_ATOL * b.float().abs().max()
                                .item()) for a, b in got_want)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in got_want)
        expect(worst <= 1.0 and ok_extra,
               f"decode kernel {name} {case}: within one bf16 step + "
               f"{DECODE_ATOL} x max (worst element at {worst:.3f} of its "
               f"bound) {extra}")
        ms = timed_turns(fns)
        r = dict(shape=case, ms=float(np.mean(ms["kernel"])),
                 plain_ms=float(np.mean(ms["plain"])),
                 library_ms=(float(np.mean(ms["library"])) if "library" in ms
                             else None), turns_ms=ms, bound=bound,
                 max_abs_err=err, worst_share_of_bound=worst, **extra)
        print(f"kernel {name} {case}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
              f"{bound[0]:.5f} ms ({bound[1]}), max err {err:.3g} "
              f"(worst at {worst:.3f} of its bound){' ' if extra else ''}"
              f"{extra if extra else ''}", flush=True)
        return r

    out = {k: {} for k in DECODE_PLAIN}
    cases = decode_cases()
    for case, (cfg, sh) in cases["rmsnorm"].items():
        d, res = sh["d"], sh["residual"]
        x, r = randn(B, 1, d, scale=3.0), randn(B, 1, d)
        sc = randn(d, scale=0.1) + 1
        eps = cfg.norm_eps
        kw = dict(residual=r) if res else {}
        got, want = ops.rmsnorm(x, sc, eps, **kw), ref.rmsnorm_ref(
            x, sc, eps, **kw)
        same_sum = not res or torch.equal(got[0], want[0])
        pairs = [(got[1], want[1])] if res else [(got, want)]
        fns = {"kernel": lambda: ops.rmsnorm(x, sc, eps, **kw),
               "plain": lambda: ref.rmsnorm_ref(x, sc, eps, **kw)}
        if not res:
            fns["library"] = lambda: F.rms_norm(x, (d,), sc, eps)
        out["rmsnorm"][case] = record(
            "rmsnorm", case, pairs, fns,
            rl.rmsnorm_bound(B, d, bf16, bf16, res), same_sum,
            sum_bit_identical=same_sum)
    for case, (cfg, sh) in cases["rope_cache_write"].items():
        H, KV, hd, S, pos = sh["H"], sh["KV"], sh["hd"], sh["S"], sh["pos"]
        q, k, v = randn(B, 1, H, hd), randn(B, 1, KV, hd), randn(B, 1, KV, hd)
        base = randn(B, S, KV, hd), randn(B, S, KV, hd)
        freqs = (rope_frequencies(hd, cfg.rope_theta, dev) if sh["rope"]
                 else None)
        kw = dict(freqs=freqs, window=sh["window"])
        kc, vc, kt, vt, kp, vp = (t.clone() for t in base * 3)
        qo = ops.rope_cache_write(q, k, v, kc, vc, pos, **kw)
        qt = ops.rope_cache_write(q, k, v, kt, vt, torch.tensor(pos,
                                                                device=dev),
                                  **kw)
        qp = ref.rope_cache_ref(q, k, v, kp, vp, pos, **kw)
        same = (torch.equal(qo, qt) and torch.equal(kc, kt)
                and torch.equal(vc, vt) and torch.equal(vc, vp))
        out["rope_cache_write"][case] = record(
            "rope_cache_write", case, [(qo, qp), (kc, kp)],
            {"kernel": lambda: ops.rope_cache_write(q, k, v, kc, vc, pos,
                                                    **kw),
             "plain": lambda: ref.rope_cache_ref(q, k, v, kp, vp, pos,
                                                 **kw)},
            rl.rope_cache_bound(B, H, KV, hd, bf16, bf16, sh["rope"]), same,
            int_tensor_and_v_bit_identical=same)
        del base, kc, vc, kt, vt, kp, vp
    for case, (cfg, sh) in cases["decode_attention"].items():
        H, KV, hd, S, pos = sh["H"], sh["KV"], sh["hd"], sh["S"], sh["pos"]
        W = sh["window"]
        q = randn(B, 1, H, hd)
        kc, vc = randn(B, S, KV, hd), randn(B, S, KV, hd)
        kw = dict(window=W, logit_cap=sh["cap"], scale=sh["scale"])
        got = ops.decode_attention(q, kc, vc, pos=pos, **kw)
        again = ops.decode_attention(q, kc, vc, pos=torch.tensor(
            pos, device=dev), **kw)
        want = ref.decode_attention_ref(q, kc, vc, pos=pos, **kw)
        fns = {"kernel": lambda: ops.decode_attention(q, kc, vc, pos=pos,
                                                      **kw),
               "plain": lambda: ref.decode_attention_ref(q, kc, vc, pos=pos,
                                                         **kw)}
        rows = rl.decode_rows(S, pos, W)
        if not sh["cap"]:
            j = torch.arange(S, device=dev)
            valid = j <= pos
            if W is not None and S > W:
                valid &= j > pos - W
            qh, kh, vh = (t.transpose(1, 2) for t in (q, kc, vc))
            fns["library"] = lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=valid[None, None, None],
                scale=sh["scale"],
                enable_gqa=True)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rows_split, splits = dec_mod.split_plan(B, KV, S, sms)
        out["decode_attention"][case] = record(
            "decode_attention", case, [(got, want)], fns,
            rl.decode_attention_bound(B, H, KV, rows, hd, bf16, bf16),
            torch.equal(got, again), int_tensor_bit_identical=bool(
                torch.equal(got, again)), rows_read=rows,
            splits=splits, rows_a_split=rows_split)
        del kc, vc
    for case, (cfg, sh) in cases["ssd_decode_step"].items():
        nh, hd, ds, K = sh["nh"], sh["hd"], sh["ds"], sh["K"]
        di = nh * hd
        p = dict(dt_bias=randn(nh, scale=0.5), A_log=randn(nh, scale=0.5),
                 D=randn(nh), conv_x=randn(K, di, scale=0.5),
                 conv_B=randn(K, ds, scale=0.5),
                 conv_C=randn(K, ds, scale=0.5))
        z, x, Bv, Cv = (randn(B, 1, di), randn(B, 1, di), randn(B, 1, ds),
                        randn(B, 1, ds))
        dt = randn(B, 1, nh)
        h0 = randn(B, nh, ds, hd, dtype=torch.float32)
        conv0 = {"x": randn(B, K - 1, di), "B": randn(B, K - 1, ds),
                 "C": randn(B, K - 1, ds)}
        states = [(h0.clone(), {k: t.clone() for k, t in conv0.items()})
                  for _ in range(3)]
        (h, conv), (hp, convp), (ho, convo) = states
        y = ops.ssd_decode_step(z, x, Bv, Cv, dt, p, h=h, conv=conv)
        yp = ref.ssd_decode_step_ref(z, x, Bv, Cv, dt, p, h=hp, conv=convp)
        with conv_in_order():
            yo = ref.ssd_decode_step_ref(z, x, Bv, Cv, dt, p, h=ho,
                                         conv=convo)
        h_err = (h - ho).abs().max().item() / ho.abs().max().item()
        plain_h_err = (h - hp).abs().max().item() / hp.abs().max().item()
        plain_y = bf16_excess(y, yp, DECODE_ATOL * yp.float().abs().max()
                              .item())
        same_conv = all(torch.equal(conv[k], convp[k]) for k in conv)
        out["ssd_decode_step"][case] = r = record(
            "ssd_decode_step", case, [(y, yo)],
            {"kernel": lambda: ops.ssd_decode_step(z, x, Bv, Cv, dt, p, h=h,
                                                   conv=conv),
             "plain": lambda: ref.ssd_decode_step_ref(z, x, Bv, Cv, dt, p,
                                                      h=hp, conv=convp)},
            rl.ssd_decode_bound(B, nh, hd, ds, K, bf16, bf16),
            h_err <= SSD_STATE_RTOL and same_conv,
            state_rel_err=h_err, conv_bit_identical=same_conv,
            plain_state_rel_err=plain_h_err,
            plain_worst_share_of_bound=plain_y,
            plain_max_abs_err=(y.float() - yp.float()).abs().max().item())
        # the kernels line's error is the plain version's as it is
        r["in_order_max_abs_err"] = r["max_abs_err"]
        r["max_abs_err"] = r["plain_max_abs_err"]
    torch.cuda.synchronize()
    return {k: dict(out[k][DECODE_REPORTED[k]], shapes=out[k])
            for k in out}


def lm_prompts(cfg, n_requests: int = LM_REQUESTS):
    """``n_requests`` prompts, lengths drawn from seed 0 in LM_PROMPTS; for
    an SSM model at least one a multiple of the SSD chunk (no tail) and two
    not (a tail)."""
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(LM_PROMPTS[0], LM_PROMPTS[1] + 1,
                                            n_requests)]
    if cfg.ssm is not None:
        Q = cfg.ssm.chunk
        if not any(n % Q == 0 for n in lengths):
            lengths[0] -= lengths[0] % Q
        expect(sum(n % Q != 0 for n in lengths) >= 2,
               "two prompts with a tail")
    return [rng.integers(0, cfg.vocab, n).tolist() for n in lengths]


def decode_launches(cfg, steps: int):
    """The decode kernels' launches over ``steps`` unsharded decode steps:
    two norms a layer (a decoder layer of the encoder-decoder three, its
    cross-attention's included) and the final norm; one rope write and one
    attention an attention layer (and one more attention a layer for the
    cross-attention); one SSD step a Mamba2 layer."""
    L = cfg.n_layers
    n_attn = sum(cfg.is_attention_layer(i) for i in range(L))
    cross = L if cfg.enc_dec else 0
    return {"rmsnorm": steps * (2 * L + 1 + cross),
            "rope_cache_write": steps * n_attn,
            "decode_attention": steps * (n_attn + cross),
            "ssd_decode_step": steps * (L - n_attn)}


def want_launches(cfg, lengths, decode_steps):
    """Each LM kernel's launches over the requests: one flash call per
    attention layer per prefill (zamba2: one per hybrid group; gemma2: the
    local and the global layer of each pair; mamba2: none), one SSD call
    per Mamba2 layer per prefill (two when the prompt has a ragged tail),
    for a MoE model three grouped GEMMs per layer per prefill and decode
    step (a decode step runs neither flash nor the SSD scan), and the
    decode kernels' (``decode_launches``)."""
    n_attn = sum(cfg.is_attention_layer(i) for i in range(cfg.n_layers))
    n_ssm = cfg.n_layers - n_attn
    Q = cfg.ssm.chunk if cfg.ssm is not None else 0
    return {"flash_attention": n_attn * len(lengths),
            "ssd_scan": sum(n_ssm * (2 if Q and n > Q and n % Q else 1)
                            for n in lengths),
            "grouped_matmul": (3 * cfg.n_layers * (len(lengths)
                                                   + decode_steps)
                               if cfg.moe is not None else 0),
            **decode_launches(cfg, decode_steps)}


def lm_main_path(cfg, model, n_requests: int = LM_REQUESTS,
                 max_new: int = LM_MAX_NEW, prompts=None, slots=LM_SLOTS,
                 capacity=LM_CAPACITY):
    """``n_requests`` requests (``prompts``, default ``lm_prompts``) of
    ``max_new`` tokens through ServeEngine on cuda:0; the LM kernels'
    launch counters from 0 just before to just after, and the peak memory
    over the run."""
    prompts = prompts if prompts is not None else lm_prompts(cfg, n_requests)
    n_requests = len(prompts)
    prefills, decode = [], {"seconds": 0.0, "tokens": 0, "steps": 0}
    bad = []

    def on_step(kind, n, seconds, logits):
        if kind == "prefill":
            prefills.append((n, seconds))
        else:
            decode["seconds"] += seconds
            decode["steps"] += 1
            decode["tokens"] += n
        if not torch.isfinite(logits).all():
            bad.append(f"{kind} of {n}")

    engine = ServeEngine(cfg, model, slots=slots, capacity=capacity,
                         temperature=0.0, on_step=on_step)
    expect(engine.graph.cuda_graph is not None,
           "the engine replays its decode step's CUDA graph")
    for p in prompts:
        engine.submit(p, max_new=max_new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    done = engine.run_to_completion()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: c.value for k, c in ops.COUNTERS.items()}
    gmm_paths = {k: c.value for k, c in gmm_mod.bf16_launches.items()}

    expect(not bad, f"non-finite logits: {bad}")
    expect(len(done) == n_requests and len(prefills) == n_requests,
           f"{len(done)} of {n_requests} done, {len(prefills)} prefills")
    for r in done:
        expect(len(r.out) == max_new
               and all(0 <= t < cfg.vocab for t in r.out),
               f"request {r.rid}: {len(r.out)} tokens in the vocab")
    lengths = [len(p) for p in prompts]
    want = want_launches(cfg, lengths, decode["steps"])
    for k, n in want.items():
        expect(launches[k] == n, f"{k}: {launches[k]} launches == {n}")
    expect(gmm_paths == {"tma": launches["grouped_matmul"], "wmma": 0},
           f"every grouped GEMM launch took the TMA + wgmma kernel: "
           f"{gmm_paths}")
    for n, sec in prefills:
        print(f"lm prefill {n} tokens: {sec:.4f} s", flush=True)
    graphed = engine.prefill_graphs.lengths
    seen = collections.Counter(lengths)
    expect(sorted(graphed) == sorted(seen) and all(
        (g.graph is not None) == (seen[n] > 1) and g.replays == seen[n] - 1
        for n, g in graphed.items()),
           f"a prompt length's first prefill eager, its second captured, "
           f"every repeat a replay: "
           f"{ {n: (g.calls, g.replays) for n, g in graphed.items()} }")
    captures = {n: g.capture_s for n, g in graphed.items()
                if g.capture_s is not None}
    replayed = [n for i, n in enumerate(lengths) if n in lengths[:i]]
    print(f"lm prefill graphs {cfg.arch}: {len(replayed)} of {n_requests} "
          f"prefills repeat a length; captured "
          f"{ {n: round(s, 4) for n, s in captures.items()} } (seconds of "
          f"the capture), replayed {replayed}, the rest eager", flush=True)
    tok_s = decode["tokens"] / decode["seconds"]
    print(f"lm decode: {decode['tokens']} tokens in {decode['steps']} steps, "
          f"{decode['seconds']:.3f} s, {tok_s:.1f} tokens/s; all "
          f"{n_requests} requests in {seconds:.2f} s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    return dict(prompt_lengths=lengths, prefill_seconds=prefills,
                decode=decode, decode_tokens_per_s=tok_s, seconds=seconds,
                peak_memory_bytes=peak, cache_shapes={
                    k: list(v.shape) for k, v in engine.cache.items()},
                launches=launches, want_launches=want,
                grouped_matmul_bf16_launches=gmm_paths,
                prefill_captures_s=captures, prefill_replayed=replayed,
                first_tokens=[r.out[:8] for r in done])


def head_outputs(cfg):
    """What the head check compares: the last-token logits, the cache the
    head fills (the SSM state h; k and v, gemma2's by local and global
    layer, whisper's also its cross-attention's xk and xv), for the MoE
    family the first layer's MoE FFN on a shared input, and for whisper the
    logits of HEAD_DECODE decode steps (``head_prefill``)."""
    if cfg.ssm is not None:
        return ("logits", "h")
    if cfg.local_global_pattern:
        return ("logits", "k_local", "v_local", "k_global", "v_global")
    if cfg.enc_dec:
        return ("logits", "k", "v", "xk", "xv", "decode")
    return ("logits", "k", "v") + (("moe",) if cfg.moe is not None else ())


def model_head(cfg, model):
    """The config and parameters of the model's head, with its full-width
    embedding: zamba2's first hybrid group (5 Mamba2 + 1 attention
    layers), gemma2's first local/global pair, whisper's first encoder and
    first decoder layer (with the encoder's final norm and the learned
    positions), any other model's first MOE_CHECK_LAYERS layers."""
    if cfg.family == "hybrid":
        n, blocks = cfg.hybrid_attn_every, 1
    elif cfg.local_global_pattern or cfg.enc_dec:
        n, blocks = (1 if cfg.enc_dec else 2), 1
    else:
        n = blocks = MOE_CHECK_LAYERS
    stacks = ("layers.", "encoder.layers.")
    keep = tuple(f"{st}{i}." for st in stacks for i in range(blocks))
    state = {k: v for k, v in model.state_dict().items()
             if not k.startswith(stacks) or k.startswith(keep)}
    head = cfg.scaled(n_layers=n, n_enc_layers=1 if cfg.enc_dec else 0)
    return head, state


def head_model(head, state, dtype, dev):
    m = LM(head, dtype=dtype, device=dev)
    m.load_state_dict({k: v.to(dev) for k, v in state.items()})
    return m


def moe_inputs(head, state, tokens, dev):
    """Each MoE layer's input (the post-attention hidden state, normalised
    by ``ln2``) and parameters, in a float32 prefill of the head on
    ``dev``."""
    m = head_model(head, state, torch.float32, dev)
    x = embed(tokens.to(dev), m.embed, head)
    positions = torch.arange(tokens.shape[1], device=dev)[None]
    out = []
    for blk in m.layers:
        y, _ = lm_mod._attn_part(blk, x, head, positions=positions,
                                 causal=True)
        out.append((rmsnorm(y, blk["ln2"]["scale"], head.norm_eps),
                    blk["moe"]))
        x = lm_mod._ffn_part(blk, y, head)
    return out


def head_routes(head, state, tokens, dev):
    """Each MoE layer's router probabilities (N, E), float32, from the
    layer's own input in a float32 prefill of the head on ``dev``."""
    return [moe_mod.router_probs(h.reshape(-1, head.d_model), p, head).cpu()
            for h, p in moe_inputs(head, state, tokens, dev)]


def head_prefill(head, state, tokens, dtype, dev, moe_in=None, extras=None):
    """The last-token logits over the vocab and the cache entries of the
    head's prefill, on ``dev`` in ``dtype``: kernels on the card, plain
    versions on the CPU.  For the MoE family also ``moe``: the first
    layer's MoE FFN applied to ``moe_in``, that layer's input from the CPU
    float32 run, which every run shares up to its dtype.  Behind the
    attention layers the expert path is hidden: with the JAX package's
    init rule (fan-in = the heads axis) q and k reach ~14 per element, the
    softmax is near argmax, bf16 rounding flips which key wins, and the
    attention output (~70 per element) drowns the MoE's (~0.3) in the
    residual stream.  ``extras`` (a VLM's ``frontend_embeds``) go to the
    prefill in ``dtype`` (whisper's ``frames``).  Whisper's prefill then
    decodes HEAD_DECODE steps, fed the prompt's first tokens (the same in
    every run), its cache copied first (the steps write it in place)."""
    m = head_model(head, state, dtype, dev)
    S = tokens.shape[1]
    logits, cache = prefill(m, tokens.to(dev), capacity=S + (
        HEAD_DECODE if head.enc_dec else 0), **{
        k: v.to(dev, dtype) for k, v in (extras or {}).items()})
    # the padded vocab tail is masked to -2^30 on every run: left out
    out = {"logits": logits[:, :head.vocab].float().cpu()}
    for k in head_outputs(head)[1:]:
        if k == "decode":
            steps, live = [], {n: c.clone() for n, c in cache.items()}
            for i in range(HEAD_DECODE):
                lg, live = decode_step(m, live, tokens[:, i].to(dev), S + i)
                steps.append(lg[:, :head.vocab].float().cpu())
            out[k] = torch.stack(steps)
            continue
        out[k] = (moe_mod.moe_ffn(moe_in.to(dev, dtype), m.layers[0]["moe"],
                                  head)[0] if k == "moe"
                  else cache[k]).float().cpu()
    return out


def route_check(head, state, tokens):
    """(token, expert) assignments that differ between the card's and the
    CPU's float32 runs, the gap between the k-th and (k+1)-th CPU
    probability of each token where they differ, and the smallest such gap
    over every token."""
    K = head.moe.top_k
    differ, gaps, nearest = 0, [], math.inf
    for pc, pg in zip(head_routes(head, state, tokens, "cpu"),
                      head_routes(head, state, tokens, "cuda")):
        vals, ic = moe_mod.top_k(pc, K + 1)
        sc = ic[:, :K].sort(-1).values
        sg = moe_mod.top_k(pg, K)[1].sort(-1).values
        kth_gap = vals[:, K - 1] - vals[:, K]
        nearest = min(nearest, kth_gap.min().item())
        for r in (sc != sg).any(-1).nonzero()[:, 0].tolist():
            differ += len(set(sc[r].tolist()) - set(sg[r].tolist()))
            gaps.append(kth_gap[r].item())
    return dict(assignments_differ=differ, gaps_where_differ=gaps,
                nearest_kth_gap=nearest)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm()).item()


def head_check_inputs(cfg, seed: int = 1):
    """The head check's 512-token prompt of ``seed`` (whisper's
    WHISPER_LONG_PROMPT tokens), and for a VLM its frontend embeddings (1,
    frontend_positions, d_model), for whisper its frames (1, enc_frames,
    d_model), drawn from a generator of the same seed."""
    rng = np.random.default_rng(seed)
    n = WHISPER_LONG_PROMPT if cfg.enc_dec else LM_CHECK_TOKENS
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n)))
    extras = {}
    stub = (("frames", cfg.enc_frames) if cfg.enc_dec
            else ("frontend_embeds", cfg.frontend_positions))
    if stub[1]:
        extras[stub[0]] = torch.randn(
            (1, stub[1], cfg.d_model),
            generator=torch.Generator().manual_seed(seed))
    return tokens, extras


def lm_head_check(cfg, model):
    """The model's head at full width: its own parameters on the card
    (kernels) and on the CPU (plain versions, chosen by device), one
    512-token prompt (and a VLM's frontend embeddings), in float32 and in
    bf16.  The CPU's bf16 run, which only shows how far bf16 alone moves
    the head, is left out for the archs of HEAD_NO_CPU_BF16."""
    head, state = model_head(cfg, model)
    tokens, extras = head_check_inputs(cfg)
    runs, cpu_s = {}, 0.0
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    moe_in = (moe_inputs(head, state, tokens, "cpu")[0][0] if cfg.moe
              else None)
    for dtype in (torch.float32, torch.bfloat16):
        for dev in ("cuda", "cpu"):
            if (dtype, dev) == (torch.bfloat16, "cpu") \
                    and cfg.arch in HEAD_NO_CPU_BF16:
                continue
            t0 = time.perf_counter()
            runs[dtype, dev] = head_prefill(head, state, tokens, dtype, dev,
                                            moe_in, extras)
            if dev == "cpu":
                cpu_s += time.perf_counter() - t0
    routes = route_check(head, state, tokens) if cfg.moe else None
    torch.set_num_threads(threads)
    f32, bf16 = torch.float32, torch.bfloat16
    limits = GROUP_BF16_REL[cfg.arch]
    out = {}
    for name in head_outputs(cfg):
        want = runs[f32, "cpu"][name]
        got = runs[f32, "cuda"][name]
        scale = want.abs().max().item()
        e32 = (got - want).abs().max().item()
        # k/v (and whisper's xk/xv) are stored in bf16: one bf16 step apart
        # where the float32 values round to neighbours; whisper's decode
        # steps read those rows, so its decode logits by relative L2
        ex32 = (bf16_excess(got, want, GROUP_F32_TOL * scale)
                if name[0] in "kv" or name in ("xk", "xv")
                else rel_l2(got, want) / DECODE_F32_REL if name == "decode"
                else e32 / (GROUP_F32_TOL * scale))
        rel16 = rel_l2(runs[bf16, "cuda"][name], want)
        noise = (rel_l2(runs[bf16, "cpu"][name], want)
                 if (bf16, "cpu") in runs else None)
        expect(math.isfinite(e32) and ex32 <= 1.0,
               f"card vs CPU {name}, float32: max err {e32} (max {scale}), "
               f"worst element at {ex32:.3f} of its bound")
        expect(math.isfinite(rel16) and rel16 <= limits[name],
               f"card bf16 vs CPU float32 {name}: relative L2 {rel16} <= "
               f"{limits[name]}")
        out[name] = dict(max_abs=scale, f32_max_abs_err=e32,
                         f32_share_of_bound=ex32, bf16_card_rel_l2=rel16,
                         bf16_cpu_rel_l2=noise)
    what = ("one group" if cfg.family == "hybrid"
            else "one local/global pair" if cfg.local_global_pattern
            else "one encoder and one decoder layer" if cfg.enc_dec
            else f"{MOE_CHECK_LAYERS} layers")
    print(f"lm {what} card vs CPU: {out} (CPU {cpu_s:.1f} s)", flush=True)
    if routes is not None:
        print(f"lm {what} routes, f32 card vs CPU: "
              f"{routes['assignments_differ']} (token, expert) assignments "
              f"differ; k-th vs (k+1)-th probability gap where they do: "
              f"{routes['gaps_where_differ']}; smallest gap of any token "
              f"{routes['nearest_kth_gap']:.3g}", flush=True)
    f32_rule = (f"{GROUP_F32_TOL} x max |CPU f32|" if cfg.ssm is not None
                else f"logits {GROUP_F32_TOL} x max |CPU f32|; k/v 2^-7 |CPU| "
                     f"+ {GROUP_F32_TOL} x max |CPU| elementwise" + (
                         f"; decode relative L2 {DECODE_F32_REL}"
                         if cfg.enc_dec else ""))
    return dict(out, routes=routes, cpu_seconds=cpu_s, tolerance=(
        f"f32: {f32_rule}; bf16: ||card bf16 - CPU f32|| / ||CPU f32|| <= "
        f"{limits}"))


def profile_steps(what: str, fn):
    """``fn()`` under ``torch.profiler``: device busy time against the host
    clock, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)),
                e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t, _ in kernels) / 1e6
    launches = sum(n for _, _, n in kernels)
    top = sorted(kernels, key=lambda ktn: -ktn[1])[:6]
    # the SSD scan's four kernels, summed
    ssd = [(t, n) for k, t, n in kernels if "ssd_" in k]
    out = dict(wall_s=wall, device_busy_s=busy, kernel_launches=launches,
               idle_share=1.0 - busy / wall if busy else None,
               ssd_s=sum(t for t, _ in ssd) / 1e6,
               ssd_launches=sum(n for _, n in ssd),
               top_kernels_s=[(k[:80], t / 1e6, n) for k, t, n in top])
    print(f"lm profile {what}: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s, {launches} kernel launches; SSD kernels "
          f"{out['ssd_s']:.4f} s in {out['ssd_launches']} "
          f"launches; top {out['top_kernels_s'][:3]}", flush=True)
    return out


def graphed_steps(graph: DecodeGraph, pos0: int, steps: int, tok=None):
    """``steps`` decode steps through ``graph`` as the engine runs them:
    a replay, the greedy tokens copied into the graph's token buffer, the
    host's read of them.  Returns the tokens read, by step."""
    out = []
    for i in range(steps):
        nxt = torch.argmax(graph(pos0 + i, tok), -1)
        tok = None
        graph.token.copy_(nxt)
        out.append(nxt.tolist())
    return out


def lm_profile(cfg, model):
    """Device busy time against the host clock, from ``torch.profiler``:
    one prefill of the largest prompt, then PROFILE_DECODE_STEPS graphed
    decode steps at LM_SLOTS slots (``graphed_steps``); the kernels that
    took the most device time."""
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, LM_PROMPTS[1]))).cuda()
    graph = DecodeGraph(model, init_cache(cfg, LM_SLOTS, LM_CAPACITY,
                                          device="cuda"), LM_SLOTS)
    prefill(model, tokens, capacity=LM_CAPACITY)        # warm-up

    def decode():
        graphed_steps(graph, LM_PROMPTS[1], PROFILE_DECODE_STEPS)

    out = {"prefill": profile_steps("prefill", lambda: prefill(
        model, tokens, capacity=LM_CAPACITY))}
    out["decode"] = profile_steps("decode", decode)
    return out


def decode_graph_phase(cfg, model):
    """The decode step as one CUDA graph against the eager step, on one
    cache and one set of tokens: a batch of prompts (LM_SLOTS of
    LM_PROMPTS[1] tokens at LM_CAPACITY; gemma2 WINDOW_PROMPT tokens at
    WINDOW_CAPACITY, past its window; whisper WHISPER_BATCH of
    WHISPER_PROMPT over their frames at WHISPER_CAPACITY) prefilled into a
    cache a ``DecodeGraph`` captured, then DECODE_GRAPH_STEPS greedy steps
    from a copy of it, eager (``decode_step`` at an int position, the
    tokens read as the engine reads them) and graphed (``graphed_steps``)
    in turns.  Checked: the same greedy tokens in every run, the logits
    bit-identical (an untimed pass), and a replay's device operations those
    of an eager step at the graph's tensor position, by name and count
    (``torch.profiler``).  Profiled: PROFILE_DECODE_STEPS steps of each.
    Then the kernels against their plain versions: the graphs in turns
    (``plain_graph_check``) and, bound, the model's head
    (``head_decode_parity``)."""
    rng = np.random.default_rng(8)
    extras = {}
    if cfg.enc_dec:
        B, S, cap = WHISPER_BATCH, WHISPER_PROMPT, WHISPER_CAPACITY
        extras["frames"] = torch.randn(
            (B, cfg.enc_frames, cfg.d_model), device=CARD,
            generator=torch.Generator(device=CARD).manual_seed(8)
        ).to(torch.bfloat16)
    elif cfg.local_global_pattern:
        B, S, cap = LM_SLOTS, WINDOW_PROMPT, WINDOW_CAPACITY
    else:
        B, S, cap = LM_SLOTS, LM_PROMPTS[1], LM_CAPACITY
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(CARD)
    cache = init_cache(cfg, B, cap, device=CARD)
    t0 = time.perf_counter()
    graph = DecodeGraph(model, cache, B)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    logits, _ = prefill(model, tokens, capacity=cap, cache=cache, **extras)
    first = torch.argmax(logits, -1)
    base = {k: v.clone() for k, v in cache.items()}
    eager_cache = {k: torch.empty_like(v) for k, v in base.items()}

    def reset(graphed: bool):
        for k, v in base.items():
            (cache if graphed else eager_cache)[k].copy_(v)
        torch.cuda.synchronize()

    def eager_steps(steps: int, keep=None):
        tok, out = first, []
        for i in range(steps):
            lg, _ = decode_step(model, eager_cache, tok, S + i)
            if keep is not None:
                keep.append(lg.clone())
            tok = torch.argmax(lg, -1)
            out.append(tok.tolist())
        return out

    # an untimed pass of each, every step's logits kept
    want, got = [], []
    reset(False)
    tokens_eager = eager_steps(DECODE_GRAPH_STEPS, want)
    reset(True)
    tok, tokens_graph = first, []
    for i in range(DECODE_GRAPH_STEPS):
        got.append(graph(S + i, tok).clone())
        tok = torch.argmax(got[-1], -1)
        tokens_graph.append(tok.tolist())
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    worst = max((g.float() - w.float()).abs().max().item()
                for g, w in zip(got, want))
    del want
    tok_s = {"eager": [], "graph": []}
    same = [tokens_eager == tokens_graph]
    for graphed in (False, True, True, False):
        reset(graphed)
        t0 = time.perf_counter()
        out = (graphed_steps(graph, S, DECODE_GRAPH_STEPS, first) if graphed
               else eager_steps(DECODE_GRAPH_STEPS))
        sec = time.perf_counter() - t0
        tok_s["graph" if graphed else "eager"].append(
            B * DECODE_GRAPH_STEPS / sec)
        same.append(out == tokens_eager)
    expect(all(same), f"{cfg.arch}: the graphed and eager decode give the "
           f"same greedy tokens in every run: {same}")
    expect(bitwise, f"{cfg.arch}: graphed logits bit-identical to the eager "
           f"step's (max |diff| {worst})")
    plain = plain_graph_check(model, cache, B, S, first, got, tokens_graph,
                              reset, graph)
    del got
    head = head_decode_parity(cfg, model, tokens, cap, extras)
    profiles = {}
    for name, fn in (("graph", lambda: graphed_steps(
            graph, S, PROFILE_DECODE_STEPS, first)),
            ("eager", lambda: eager_steps(PROFILE_DECODE_STEPS))):
        reset(name == "graph")
        profiles[name] = profile_steps(f"decode {name} {cfg.arch}", fn)
    # a bare replay's device operations against one eager step's at the
    # graph's tensor position (the code the capture recorded), a call's
    # counts from windows of 4 calls each (matched_launches)
    reset(True)
    graph.pos.fill_(S)
    graph.token.copy_(first)
    replay, step, windows = matched_launches(
        graph.cuda_graph.replay,
        lambda: decode_step(model, eager_cache, graph.token, graph.pos))
    if replay and step:
        expect(replay == step, f"{cfg.arch}: a replay runs the device "
               f"operations of an eager step: replay {replay}, step {step}")
    n_replay = sum(replay.values()) if replay else None
    idle = {k: p["idle_share"] for k, p in profiles.items()}
    print(f"lm decode graph {cfg.arch}: {B} x {DECODE_GRAPH_STEPS} steps from "
          f"position {S}, tokens/s graphed "
          f"{[round(x, 1) for x in tok_s['graph']]}, eager "
          f"{[round(x, 1) for x in tok_s['eager']]} (in turns: eager, "
          f"graph, graph, eager); idle share of {PROFILE_DECODE_STEPS} "
          f"steps graphed {idle['graph']}, eager {idle['eager']}; "
          f"{n_replay} device operations a replay (an eager step "
          f"{sum(step.values()) if step else None}, the same by name: "
          f"{replay == step if replay and step else 'not seen'}; "
          f"{windows} profiler windows of 4 calls a side); greedy "
          f"tokens equal, logits bit-identical; capture {capture_s:.2f} s",
          flush=True)
    dist = {k: [float(f"{r[k]:.6g}") for r in plain["rel_l2"]]
            for k in ("f32_kernels_plain", "kernels_plain", "plain_f32",
                      "kernels_f32")}
    print(f"lm decode graph {cfg.arch} against its plain versions: tokens/s "
          f"graphed with the kernels {[round(x, 1) for x in plain['kernels']]}"
          f", with the plain versions "
          f"{[round(x, 1) for x in plain['plain']]} (in turns: plain, "
          f"kernels, kernels, plain); logits relative L2 by step at full "
          f"depth, bf16 graphs kernels against plain "
          f"{dist['kernels_plain']}, plain bf16 against float32 "
          f"{dist['plain_f32']}, kernels bf16 against float32 "
          f"{dist['kernels_f32']}, float32 kernels against plain from a "
          f"shared cache {dist['f32_kernels_plain']}; greedy tokens that "
          f"differ (step, slot, top-two margin, max |diff|): bf16 "
          f"{plain['near_ties']}, float32 {plain['near_ties_f32']}",
          flush=True)
    hd = {k: [float(f"{x:.6g}") for x in r["rel_l2"]]
          for k, r in head.items()}
    print(f"lm decode head {cfg.arch} kernels against plain, each step from "
          f"a shared cache: logits relative L2 by step, float32 "
          f"{hd['float32']} (bound {DECODE_LOGITS_REL}), bf16 {hd['bf16']};"
          f" greedy tokens that differ: float32 "
          f"{head['float32']['near_ties']}, bf16 {head['bf16']['near_ties']}",
          flush=True)
    return dict(batch=B, position=S, capacity=cap, steps=DECODE_GRAPH_STEPS,
                against_plain=plain, head_against_plain=head,
                tokens_per_s=tok_s, idle_share=idle, profiles=profiles,
                replay_ops=replay, eager_step_ops=step,
                ops_a_replay=n_replay, op_windows=windows,
                capture_s=capture_s, logits_bit_identical=bitwise,
                first_tokens=tokens_eager[:4])


@contextlib.contextmanager
def decode_plain():
    """The decode step's four entries of ``ops`` pointed at their plain
    versions (DECODE_PLAIN), whatever the device."""
    saved = {n: getattr(ops, n) for n in DECODE_PLAIN}
    for n, fn in DECODE_PLAIN.items():
        setattr(ops, n, fn)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def differing_tokens(arch: str, i: int, kernels: torch.Tensor,
                     plain: torch.Tensor, what: str):
    """(step, slot, top-two margin, max |diff|) of each slot whose greedy
    token differs between the kernels' logits and the plain versions' at
    step ``i``; each must be a near tie (the plain logits' top-two margin
    under the step's max |diff|)."""
    diff = (kernels - plain).abs().max().item()
    top2 = plain.topk(2, -1).values
    out = []
    for b in torch.nonzero(kernels.argmax(-1) != plain.argmax(-1)
                           )[:, 0].tolist():
        margin = (top2[b, 0] - top2[b, 1]).item()
        out.append((i, b, margin, diff))
        expect(margin < diff, f"{arch} step {i} slot {b}, {what}: the "
               f"kernels' greedy token differs from the plain versions' at "
               f"a margin {margin} >= max |diff| {diff}")
    return out


def plain_graph_check(model, cache, B: int, S: int, first, got, tokens,
                      reset, graph):
    """The graphed step with the decode kernels (``graph``, its logits
    ``got`` by step from position S, its greedy ``tokens``) against a graph
    of the same step captured over the same cache with the decode entries
    of ``ops`` on their plain versions (``decode_plain``), both fed the
    kernels' tokens; and the same weights in float32, the kernels' step
    against the plain versions' step, each step from one shared cache.
    Reported at every step: the logits' relative L2 of the two bf16 graphs,
    of each against the float32 plain step and of the two float32 steps,
    and the greedy tokens that differ, each held to the near-tie rule
    (``differing_tokens``); the bound is the head's
    (``head_decode_parity``: at full depth the random-init step is
    chaotic).  Then tokens/s of both graphs in turns (plain, kernels,
    kernels, plain), each from the same cache and first tokens."""
    cfg = model.cfg
    with decode_plain():
        pgraph = DecodeGraph(model, cache, B)
    reset(True)
    shared = {k: v.clone() for k, v in cache.items()}
    step_cache = {k: torch.empty_like(v) for k, v in shared.items()}
    m32 = LM(cfg, dtype=torch.float32, device=CARD)
    m32.load_state_dict(model.state_dict())
    rows, ties, tok = [], {"bf16": [], "float32": []}, first
    V = cfg.vocab     # the padded vocab tail is masked to -2^30 on every run
    for i, kg in enumerate(got):
        pl = pgraph(S + i, tok)[:, :V].float()
        for k, v in shared.items():
            step_cache[k].copy_(v)
        with torch.no_grad():
            k32 = decode_step(m32, step_cache, tok, S + i)[0][:, :V].float()
            with decode_plain():
                f32 = decode_step(m32, shared, tok, S + i)[0][:, :V].float()
        kg = kg[:, :V].float()
        rows.append(dict(f32_kernels_plain=rel_l2(k32, f32),
                         kernels_plain=rel_l2(kg, pl),
                         plain_f32=rel_l2(pl, f32),
                         kernels_f32=rel_l2(kg, f32)))
        for what, k_, p_ in (("float32", k32, f32), ("bf16", kg, pl)):
            ties[what] += differing_tokens(cfg.arch, i, k_, p_, what)
        tok = torch.tensor(tokens[i], device=CARD)
    del m32, shared, step_cache
    tok_s = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain"):
        reset(True)
        t0 = time.perf_counter()
        graphed_steps(pgraph if which == "plain" else graph, S,
                      DECODE_GRAPH_STEPS, first)
        tok_s[which].append(B * DECODE_GRAPH_STEPS
                            / (time.perf_counter() - t0))
    del pgraph
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rel_l2=rows, near_ties=ties["bf16"],
                near_ties_f32=ties["float32"], **tok_s)


def head_decode_parity(cfg, model, tokens, cap: int, extras):
    """The decode kernels against their plain versions where the step is
    not chaotic: the model's head (``model_head``: zamba2's first hybrid
    group, granite's first 2 layers, gemma2's first local/global pair,
    whisper's first encoder and decoder layers) at full width, in float32
    and in bf16, prefilled with ``tokens`` (and ``extras``) at ``cap``,
    then DECODE_GRAPH_STEPS steps, each from one shared cache: the
    kernels' step against the plain versions' (``decode_plain``), fed the
    plain step's greedy tokens.  Bound at every step, in float32: the
    logits within relative L2 DECODE_LOGITS_REL; in both dtypes a greedy
    token that differs only at a near tie (``differing_tokens``).
    Returns {dtype: dict(rel_l2=[...], near_ties=[...])}."""
    head, state = model_head(cfg, model)
    S, V = tokens.shape[1], cfg.vocab
    out = {}
    for name, dtype in (("float32", torch.float32), ("bf16", torch.bfloat16)):
        m = head_model(head, state, dtype, CARD)
        with torch.no_grad():
            logits, cache = prefill(m, tokens, capacity=cap, **{
                k: v.to(dtype) for k, v in extras.items()})
        step_cache = {k: torch.empty_like(v) for k, v in cache.items()}
        tok, rows, ties = torch.argmax(logits, -1), [], []
        for i in range(DECODE_GRAPH_STEPS):
            for k, v in cache.items():
                step_cache[k].copy_(v)
            with torch.no_grad():
                kl = decode_step(m, step_cache, tok, S + i)[0][:, :V].float()
                with decode_plain():
                    pl = decode_step(m, cache, tok, S + i)[0][:, :V].float()
            rows.append(rel_l2(kl, pl))
            if dtype == torch.float32:
                expect(rows[-1] <= DECODE_LOGITS_REL, f"{cfg.arch} head "
                       f"step {i}: in float32, the decode kernels' logits "
                       f"within relative L2 {DECODE_LOGITS_REL} of the plain "
                       f"versions' from the same cache: {rows[-1]}")
            ties += differing_tokens(cfg.arch, i, kl, pl, f"head {name}")
            tok = torch.argmax(pl, -1)
        out[name] = dict(rel_l2=rows, near_ties=ties)
        del m, logits, cache, step_cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: what a device-to-device copy is called in a profile: eager, a copy
#: engine's "Memcpy DtoD"; in a replay, the graph's copy kernels
#: ("memcpy128", "memcpy32_post", ...) and, for a few of granite's copies,
#: "Memset" (the eager prefill shows no memset at all: 290 copies there,
#: 287 copy kernels and 3 memsets in its replay)
GRAPH_COPY = re.compile(r"^(Memcpy DtoD|Memset|memcpy\d*(_post)?)\b")


def fold_copies(ops_a_call):
    """{name: launches a call} with the device-to-device copies and sets
    under one name, however the device ran them."""
    out = {}
    for name, n in (ops_a_call or {}).items():
        key = "memcpy DtoD or memset" if GRAPH_COPY.match(name) else name
        out[key] = out.get(key, 0) + n
    return out


def prefill_graph_phase(cfg, model):
    """The prefill as one CUDA graph per repeated prompt length
    (``PrefillGraphs`` at LM_CAPACITY) against the eager prefill, at a
    short length L1 and the longest L2 (``PREFILL_GRAPH_ARCHS``).  Checked,
    in an untimed pass ordered L1, L2, L1, L2, L1 with each call's prompt
    drawn anew (a length's first call eager, its second captured and
    replayed, L1's third a replay after L2's graph used the shared pool
    and the static cache): each call's logits and every cache entry
    bit-identical to an eager ``prefill`` of its prompt into a fresh
    cache, and each call counting that eager prefill's launches, one
    prefill's (``want_launches``); a replay's device operations at L2
    those of the captured function run eagerly, by name and count
    (``matched_launches``; the device-to-device copies and sets, which a
    graph runs as nodes of its own, under one name: ``fold_copies``).
    Timed: seconds a request (the prefill and the host's read of its
    greedy token, as the engine reads it), eager against graph in turns
    (eager, graph, graph, eager) of PREFILL_GRAPH_CALLS calls at each
    length, each call on a prompt drawn for it (both kinds the same
    prompts); each length's capture seconds.  Memory: the pool's bytes,
    the static outputs' bytes and what the holder reserved, against the
    peak an eager prefill at L2 allocates above what it found (its
    intermediates and the fresh cache the eager engine makes a request).
    Profiled: the idle share of one replay against one eager prefill at
    L2."""
    rng = np.random.default_rng(9)
    short = int(rng.integers(LM_PROMPTS[0], LM_PROMPTS[1] // 2 + 1))
    if cfg.ssm is not None and short % cfg.ssm.chunk == 0:
        short += 1
    lengths = (short, LM_PROMPTS[1])

    def draw(n):
        return torch.from_numpy(rng.integers(0, cfg.vocab, (1, n))).to(CARD)

    def counts():
        torch.cuda.synchronize()
        return {k: c.value for k, c in ops.COUNTERS.items()}

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    graphs = PrefillGraphs(model, LM_CAPACITY)
    calls = []
    for n in (*lengths, *lengths, lengths[0]):
        toks = draw(n)
        kind = ("eager", "capture", "replay")[min(
            2, graphs.lengths[n].calls if n in graphs.lengths else 0)]
        reset_counts()
        logits, cache = graphs(toks)
        counted = counts()
        reset_counts()
        with torch.no_grad():
            want_logits, want = prefill(model, toks, capacity=LM_CAPACITY)
        eager = counts()
        same = torch.equal(logits, want_logits) and all(
            torch.equal(cache[k], want[k]) for k in want)
        expect(same, f"{cfg.arch}: the {n}-token prefill ({kind}) logits and "
               f"cache bit-identical to the eager prefill's")
        one = want_launches(cfg, [n], 0)
        expect(counted == eager and all(counted[k] == v
                                        for k, v in one.items()),
               f"{cfg.arch}: a {n}-token prefill ({kind}) counts one "
               f"prefill's launches: {counted}, eager {eager}, want {one}")
        calls.append(dict(tokens=n, kind=kind, launches=counted))
        del logits, cache, want_logits, want
    expect([c["kind"] for c in calls]
           == ["eager", "eager", "capture", "capture", "replay"],
           f"{cfg.arch}: a length's first prefill eager, its second "
           f"captured: {calls}")
    pool, static = graphs.pool_bytes(), graphs.static_bytes()
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved() - reserved
    toks = draw(lengths[1])
    torch.cuda.synchronize()
    found = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = prefill(model, toks, capacity=LM_CAPACITY)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() - found
    del out

    @torch.no_grad()
    def eager_call(t):
        logits, _ = prefill(model, t, capacity=LM_CAPACITY)
        return int(torch.argmax(logits[0]))

    def graph_call(t):
        return int(torch.argmax(graphs(t)[0][0]))

    prompts = {n: [draw(n) for _ in range(PREFILL_GRAPH_CALLS)]
               for n in lengths}
    seconds = {n: {"eager": [], "graph": []} for n in lengths}
    for n in lengths:
        for kind in ("eager", "graph", "graph", "eager"):
            fn = graph_call if kind == "graph" else eager_call
            t0 = time.perf_counter()
            for t in prompts[n]:
                fn(t)
            seconds[n][kind].append((time.perf_counter() - t0)
                                    / PREFILL_GRAPH_CALLS)
    # at L2, which a whole number of SSD chunks keeps to fewer operations
    # than L1's ragged tail
    longest = graphs.lengths[lengths[1]]

    @torch.no_grad()
    def captured_eagerly():
        graphs._run(longest.tokens)

    replay, step, windows = matched_launches(
        lambda: longest.graph.replay(), captured_eagerly, fold=fold_copies)
    if replay and step:
        expect(replay == step, f"{cfg.arch}: a prefill replay runs the "
               f"device operations of an eager prefill: replay {replay}, "
               f"eager {step}")
    n_replay = sum(replay.values()) if replay else None
    profiles = {
        "graph": profile_steps(f"prefill graph {cfg.arch} {lengths[1]}",
                               lambda: graph_call(prompts[lengths[1]][0])),
        "eager": profile_steps(f"prefill eager {cfg.arch} {lengths[1]}",
                               lambda: eager_call(prompts[lengths[1]][0]))}
    idle = {k: p["idle_share"] for k, p in profiles.items()}
    captures = {n: g.capture_s for n, g in graphs.lengths.items()
                if g.capture_s is not None}
    turns = "; ".join(
        f"{n} tokens graph {[round(x, 4) for x in seconds[n]['graph']]}, "
        f"eager {[round(x, 4) for x in seconds[n]['eager']]}"
        for n in lengths)
    print(f"lm prefill graph {cfg.arch}: {lengths[0]}, {lengths[1]} tokens "
          f"eager, captured, then {lengths[0]} replayed, at capacity "
          f"{LM_CAPACITY}, each prompt drawn anew: logits and cache "
          f"bit-identical to the eager prefill's, one prefill's launches a "
          f"call; s a request {turns} (in turns: eager, graph, graph, "
          f"eager; {PREFILL_GRAPH_CALLS} prompts each); capture s "
          f"{ {n: round(s, 4) for n, s in captures.items()} }; pool "
          f"{pool} bytes, static cache and logits {static} bytes, reserved "
          f"by the holder {reserved} bytes; an eager {lengths[1]}-token "
          f"prefill's peak above what it found {eager_peak} bytes; idle "
          f"share at {lengths[1]} graph {idle['graph']}, eager "
          f"{idle['eager']}; {n_replay} device operations a replay at "
          f"{lengths[1]} (eager "
          f"{sum(step.values()) if step else None}, the same by name: "
          f"{replay == step if replay and step else 'not seen'}; "
          f"{windows} profiler windows of 4 calls a side)", flush=True)
    return dict(lengths=list(lengths), calls=calls, seconds=seconds,
                capture_s=captures, pool_bytes=pool, static_bytes=static,
                reserved_bytes=reserved, eager_peak_bytes=eager_peak,
                idle_share=idle, profiles=profiles, replay_ops=replay,
                eager_ops=step, ops_a_replay=n_replay, op_windows=windows)


def checked_prefill(cfg, model, n: int = CHECKED_PREFILL_TOKENS):
    """One batch-1 prefill of ``n`` tokens at capacity ``n`` (the dry-run's
    prefill step at that shape), the model alone on the card before it:
    its launches and peak memory over one call after a warm-up, and the
    median seconds of three more."""
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, n))).cuda()
    prefill(model, tokens, capacity=n)                  # warm-up
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    out = prefill(model, tokens, capacity=n)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: c.value for k, c in ops.COUNTERS.items()}
    del out
    seconds = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill(model, tokens, capacity=n)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    want = want_launches(cfg, [n], 0)
    expect(all(launches[k] == v for k, v in want.items()),
           f"checked prefill launches {launches} == {want}")
    return dict(tokens=n, launches=launches, peak_memory_bytes=peak,
                allocated_before_bytes=base, seconds=sorted(seconds)[1],
                seconds_each=seconds)


def graph_parts(cfg, model, serve) -> None:
    """The prefill graphs' and the decode graph's phases where ``cfg``'s
    arch is among theirs, into ``serve``."""
    if cfg.arch in PREFILL_GRAPH_ARCHS:
        with part(f"{cfg.arch} prefill graph"):
            serve["prefill_graph"] = prefill_graph_phase(cfg, model)
    if cfg.arch in DECODE_GRAPH_ARCHS:
        with part(f"{cfg.arch} decode graph"):
            serve["decode_graph"] = decode_graph_phase(cfg, model)


def lm_phase(arch):
    """One model: its kernels at its shapes, its main path, a profiled
    window and the head check; the model is freed before returning."""
    cfg = get_config(arch)
    model = build_model(cfg)
    with part(f"{arch} kernels"):
        kernels = (lm_kernel_phase(cfg) if cfg.family == "hybrid"
                   else moe_kernel_phase(cfg))
    for name, r in kernels.items():
        print(f"kernel {name} {r['shape']} {r['dtype']}: {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), max err "
              f"{r['max_abs_err']:.3g}", flush=True)
    if "ssd_scan" in kernels:
        r = kernels["ssd_scan"]
        print(f"kernel ssd_scan: {r['kernels_per_call']} kernels a call "
              "(C.B^T per chunk, chunk end states, state passing, outputs); "
              f"bound at the split-TF32 tensor-core rate "
              f"{r['bound_split_tf32'][0]:.4f} ms "
              f"({r['bound_split_tf32'][1]})", flush=True)
    for shape in ("prefill_out", "decode"):
        if shape not in kernels.get("grouped_matmul", {}):
            continue
        r = kernels["grouped_matmul"][shape]
        print(f"kernel grouped_matmul {list(GMM_SHAPES[shape])} bfloat16: "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']}, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]})", flush=True)
    with part(f"{arch} main path and profile"):
        serve = lm_main_path(cfg, model)
        serve["profile"] = lm_profile(cfg, model)
    graph_parts(cfg, model, serve)
    if arch == CHECKED_PREFILL_ARCH:
        serve["checked_prefill"] = checked_prefill(cfg, model)
    with part(f"{arch} head check"):
        head = lm_head_check(cfg, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return kernels, serve, head


# ---------------------------------------------------------------------------
# LM training: the kernels' gradients, four full-width steps, a head check
# ---------------------------------------------------------------------------

def grads_of(fn, inputs, dout, **kw):
    """fn(*inputs) and its gradients for the output gradient ``dout``."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*xs, **kw)
    return out, torch.autograd.grad(out, xs, dout)


def backward_of(fn, inputs, dout, **kw):
    """A call of ``fn``'s backward for the output gradient ``dout`` through
    ``torch.autograd.grad`` (the graph built once)."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*xs, **kw)
    return lambda: torch.autograd.grad(out, xs, dout, retain_graph=True)


def grad_ms(fn, inputs, dout, reps, **kw):
    """Milliseconds of one backward of ``fn``, CUDA events around ``reps``
    calls: the host's dispatch is in it where it is slower than the card."""
    return cuda_ms(backward_of(fn, inputs, dout, **kw), reps)


def flash_grads_excess(q, k, v, do, kw):
    """The kernel's output (the forward that keeps the log-sum-exp) and its
    dq, dk, dv against autograd through the plain version in float32 from
    the same inputs: the largest share of the elementwise bound (at most 1
    when within it) and the largest |err| of the gradients."""
    o, got = grads_of(ops.flash_attention, (q, k, v), do, **kw)
    o_want, want = grads_of(ref.attention_ref,
                            (q.float(), k.float(), v.float()), do.float(),
                            **kw)
    worst = (bf16_excess(o, o_want, FLASH_TOL) if q.dtype == torch.bfloat16
             else (o - o_want).abs().max().item() / FLASH_TOL)
    expect(worst <= 1.0, f"flash forward with lse {list(q.shape)} {q.dtype}: "
           f"worst element at {worst:.3f} of its bound")
    rounding = (*attention_bwd_rounding(q, k, o, do, **kw), 0.0)
    err_max = 0.0
    for g, w, r in zip(got, want, rounding):
        err = (g.float() - w).abs()
        bound = BWD_TOL * w.abs().max()
        if q.dtype == torch.bfloat16:
            bound = bound + BF16_STEP * w.abs() + r
        worst = max(worst, (err / bound).max().item())
        err_max = max(err_max, err.max().item())
    return worst, err_max


def train_kernel_phase(cfg, dev="cuda"):
    """Flash attention's backward and the grouped GEMM's dx and dw against
    autograd through their plain versions on the card, at granite's
    training shapes, and timed: the flash backward kernel in turns with
    the SDPA backward, each grouped GEMM backward beside ``torch.bmm``'s."""
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    B, S, H, KV, hd = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, do = randn(B, H, S, hd), randn(B, H, S, hd)
    k, v = randn(B, KV, S, hd), randn(B, KV, S, hd)
    worst, err = flash_grads_excess(q, k, v, do, dict(causal=True))
    expect(worst <= 1.0, f"flash backward {list(q.shape)} bf16: worst "
           f"element at {worst:.3f} of its bound")
    variants = {}
    for dtype in (torch.float32, bf16):
        qs, dos = randn(2, 8, 300, 64, dtype=dtype), randn(2, 8, 300, 64,
                                                           dtype=dtype)
        ks, vs = randn(2, 2, 300, 64, dtype=dtype), randn(2, 2, 300, 64,
                                                          dtype=dtype)
        ex, _ = flash_grads_excess(qs, ks, vs, dos,
                                   dict(causal=True, window=64,
                                        logit_cap=30.0))
        expect(ex <= 1.0, f"flash backward window/softcap {dtype}: worst "
               f"element at {ex:.3f} of its bound")
        variants[str(dtype)[6:]] = ex
    # kv head 0 and its query heads built to cancel (tests/
    # flash_bwd_bounds.py), where one bf16 rounding of P or dS would break
    # the bound
    qc, kc, vc, doc = cancelling(randn(2, 8, S, hd), randn(2, 2, S, hd),
                                 randn(2, 2, S, hd), randn(2, 8, S, hd))
    cancel, _ = flash_grads_excess(qc, kc, vc, doc, dict(causal=True))
    expect(cancel <= 1.0, f"flash backward, cancelling head, bf16: worst "
           f"element at {cancel:.3f} of its bound")
    o, lse = flash_mod.flash_attention_with_lse(q, k, v)
    kernel = lambda: flash_mod.flash_attention_backward(q, k, v, o, do, lse)
    sdpa = lambda *t: F.scaled_dot_product_attention(*t, is_causal=True,
                                                     enable_gqa=True)
    turns = {"kernel": [], "sdpa": []}
    for _ in range(2):                 # in turns: kernel, SDPA, kernel, SDPA
        turns["kernel"].append(cuda_ms(kernel, 20))
        turns["sdpa"].append(grad_ms(sdpa, (q, k, v), do, 20))
    # device time alone (torch.profiler), beside the host-clocked turns
    device = {"kernel": device_ms(kernel),
              "sdpa": device_ms(backward_of(sdpa, (q, k, v), do))}
    # None: no profiler session saw the card (timed with CUDA events)
    expect(device["kernel"][1] in (None, flash_mod.BWD_KERNELS_PER_CALL),
           f"the profiler saw every backward kernel: {device}")
    results = {"flash_attention_bwd": dict(
        max_abs_err=err, ms=sum(turns["kernel"]) / 2,
        plain_ms=grad_ms(ref.attention_ref, (q, k, v), do, 3),
        library_ms=sum(turns["sdpa"]) / 2, turns=turns,
        device_ms=device, shape=[B, H, KV, S, hd], dtype="bfloat16",
        bf16_worst_share_of_bound=worst,
        window_softcap_worst_share_of_bound=variants,
        cancelling_worst_share_of_bound=cancel,
        kernels_per_call=flash_mod.BWD_KERNELS_PER_CALL,
        tolerance=f"f32: max |err| <= {BWD_TOL} x max |plain|; bf16: "
                  f"2^-7 |plain| + {BWD_TOL} x max |plain| + the "
                  "o-rounding bound on dq/dk, elementwise",
        bound=flash_bwd_bound(B, H, KV, S, hd, bf16))}
    fwd_turns = [cuda_ms(lambda: flash_mod.flash_attention_with_lse(q, k, v),
                         20) for _ in range(2)]
    results["flash_attention_bwd"]["forward_with_lse_ms"] = fwd_turns

    # the grouped GEMM's backward at the training capacity: autograd through
    # ops.grouped_matmul (dx and dw on their kernels), then each kernel
    # alone at granite's shapes and at a ragged capacity
    m = cfg.moe
    C = moe_mod.capacity(cfg, B * S)
    E, d, f = m.n_experts, cfg.d_model, m.d_ff
    gmm = {}
    before = gmm_mod.bf16_launches["wmma"].value
    for name, (d_, f_) in (("w_in", (d, f)), ("w_out", (f, d))):
        x, dy = randn(E, C, d_), randn(E, C, f_)
        w = (torch.randn((E, d_, f_), generator=g, device=dev)
             * d_ ** -0.5).to(bf16)
        _, got = grads_of(ops.grouped_matmul, (x, w), dy)
        _, want = grads_of(ref.grouped_matmul_ref, (x, w), dy)
        worst_g, err_g = 0.0, 0.0
        for a, b_ in zip(got, want):
            scale = b_.float().abs().max().item()
            worst_g = max(worst_g, bf16_excess(a, b_, GMM_TOL * scale))
            err_g = max(err_g, (a.float() - b_.float()).abs().max().item())
        expect(worst_g <= 1.0, f"grouped GEMM backward {name} "
               f"({E}, {C}, {d_}, {f_}): worst element at {worst_g:.3f} of "
               "its bound")
        gmm[name] = dict(
            shape=[E, C, d_, f_], max_abs_err=err_g,
            bf16_worst_share_of_bound=worst_g,
            ms=grad_ms(ops.grouped_matmul, (x, w), dy, 20),
            plain_ms=grad_ms(ref.grouped_matmul_ref, (x, w), dy, 5),
            library_ms=grad_ms(torch.bmm, (x, w), dy, 20),
            bound=gmm_bwd_bound(E, C, d_, f_, bf16))
        gmm[name].update(gmm_bwd_kernels(x, w, dy))
    ragged = 72               # w_out's operands, the first 72 rows
    x, dy = x[:, :ragged].contiguous(), dy[:, :ragged].contiguous()
    gmm["ragged_c"] = dict(shape=[E, ragged, *w.shape[1:]],
                           **gmm_bwd_kernels(x, w, dy, timed=False))
    expect(gmm_mod.bf16_launches["wmma"].value == before,
           "every grouped GEMM backward call took the TMA + wgmma kernels")
    results["grouped_matmul_bwd"] = gmm
    for prod in ("dx", "dw"):
        r = gmm["w_in"][prod]
        results[f"grouped_matmul_{prod}"] = dict(
            r, shape=gmm["w_in"]["shape"],
            w_out=gmm["w_out"][prod], ragged_c=gmm["ragged_c"][prod])
    torch.cuda.synchronize()
    return results


def gmm_bwd_kernels(x, w, dy, timed: bool = True):
    """``grouped_matmul_dx`` and ``grouped_matmul_dw`` each alone against
    their plain versions (one bf16 step plus GMM_TOL x max |plain|); timed
    beside the plain version and ``torch.bmm`` on transposed views, each
    with its own product's bound."""
    E, C, d = x.shape
    f = w.shape[2]
    bf16 = torch.bfloat16
    out = {}
    for prod, kernel, plain, lib, bound in (
            ("dx", lambda: gmm_mod.grouped_matmul_dx(dy, w),
             lambda: ref.grouped_matmul_dx_ref(dy, w),
             lambda: torch.bmm(dy, w.transpose(1, 2)),
             gmm_bound(E, C, f, d, bf16)),
            ("dw", lambda: gmm_mod.grouped_matmul_dw(x, dy),
             lambda: ref.grouped_matmul_dw_ref(x, dy),
             lambda: torch.bmm(x.transpose(1, 2), dy),
             gmm_bound(E, d, C, f, bf16))):
        got, want = kernel(), plain()
        scale = want.float().abs().max().item()
        worst = bf16_excess(got, want, GMM_TOL * scale)
        expect(got.shape == want.shape and worst <= 1.0,
               f"{prod} kernel ({E}, {C}, {d}, {f}): worst element at "
               f"{worst:.3f} of its bound")
        out[prod] = dict(max_abs_err=(got.float() - want.float()).abs()
                         .max().item(), bf16_worst_share_of_bound=worst,
                         bound=bound)
        if timed:
            out[prod].update(ms=cuda_ms(kernel, 20),
                             plain_ms=cuda_ms(plain, 5),
                             library_ms=cuda_ms(lib, 20),
                             device_ms=device_ms(kernel)[0])
    return out


def want_train_launches(cfg, remat: str = TRAIN_REMAT):
    """Each kernel's launches in one step: one flash forward and backward
    per attention layer (whisper: per encoder layer and per decoder layer's
    attention and cross-attention), one SSD scan forward and backward per Mamba2
    layer, and for the moe family three grouped GEMMs per layer forward,
    each with a dx and a dw behind it; AdamW's three calls (each
    gradient's sum of squares, their sum, the update).  Under a remat
    policy the kernels are recomputed (they are no matrix products to the
    dispatcher: models/lm.py REMAT_SAVED), so each forward runs twice."""
    L = cfg.n_layers
    n_attn = sum(cfg.is_attention_layer(i) for i in range(L))
    n_ssm = L - n_attn
    if cfg.enc_dec:       # the encoder's layers, the decoder's cross-attention
        n_attn += cfg.n_enc_layers + L
    again = 1 if remat in (None, "none") else 2
    return {"flash_attention": again * n_attn, "flash_attention_bwd": n_attn,
            "grouped_matmul": (again * 3 + 6) * L if cfg.moe else 0,
            "ssd_scan": again * n_ssm, "ssd_scan_bwd": n_ssm, "adamw": 3}


class PlainCalls:
    """Counts the calls of the LM kernels', the train step's and the decode
    step's plain versions while it is entered (the card's training path
    must make none)."""
    NAMES = ("attention_ref", "grouped_matmul_ref", "ssd_scan_ref",
             "grad_sumsq_ref", "sum_in_order_ref", "adamw_update_ref",
             "grad_accumulate_ref", "rmsnorm_ref", "rope_cache_ref",
             "decode_attention_ref", "ssd_decode_step_ref")

    def __enter__(self):
        self.calls = {n: 0 for n in self.NAMES}
        self.saved = {n: getattr(ref, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            def counted(*a, _n=n, _fn=fn, **kw):
                self.calls[_n] += 1
                return _fn(*a, **kw)
            setattr(ref, n, counted)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(ref, n, fn)


def train_extras(cfg, batch: int):
    """What an encoder-decoder's batches carry besides the tokens: the
    launcher's frames, (batch, enc_frames, d_model) bf16 from generator
    seed 7 (``repro_torch.launch.train``)."""
    if not cfg.enc_dec:
        return {}
    return {"frames": torch.randn(
        (batch, cfg.enc_frames, cfg.d_model), device=CARD,
        generator=torch.Generator(device=CARD).manual_seed(7)).to(
            torch.bfloat16)}


def train_seq(cfg) -> int:
    """Tokens a sequence in training: whisper's decoder context, else
    TRAIN_SEQ."""
    return WHISPER_CAPACITY if cfg.enc_dec else TRAIN_SEQ


def train_main_path(cfg, model, remat: str = TRAIN_REMAT,
                    profile_update: bool = False):
    """TRAIN_STEPS steps of ``make_train_step`` on ``batch_at``'s batches
    (and an encoder-decoder's frames), the launch counters from 0 just
    before to just after; with ``profile_update``, then the eager update's
    device time on the trained state (``update_profile``)."""
    opt = build_optimizer(cfg, TRAIN_LR, TRAIN_STEPS)
    rt = RuntimeConfig(microbatches=1, remat=remat, loss_chunks=1,
                       aux_weight=0.01)
    state = init_state(model, opt)
    step_fn = make_train_step(cfg, opt, rt)
    seq = train_seq(cfg)
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq,
                    global_batch=TRAIN_BATCH, seed=0)
    extras = train_extras(cfg, TRAIN_BATCH)
    batches = [{**batch_at(dc, i), **extras} for i in range(TRAIN_STEPS)]
    tokens = TRAIN_BATCH * seq
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    steps = []
    reset_counts()
    with PlainCalls() as plain:
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            m = {k: float(v) for k, v in metrics.items()}
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            steps.append(dict(m, seconds=sec, tokens_per_s=tokens / sec))
            print(f"train step {i + 1}: loss {m['loss']:.4f} aux "
                  f"{m['aux_loss']:.4f} grad_norm {m['grad_norm']:.4f} lr "
                  f"{m['lr']:.3e} {sec:.3f} s {tokens / sec:.0f} tokens/s",
                  flush=True)
    launches = {k: c.value for k, c in ops.COUNTERS.items()}
    gmm_paths = {k: c.value for k, c in gmm_mod.bf16_launches.items()}
    gmm_bwd = gmm_mod.bwd_launches.value
    gmm_bwd_kernels = {k: c.value for k, c in gmm_mod.bwd_kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    # whisper's gradient norm overflows float32 at the reference's init
    # (x30-50 a layer pair, in both packages: ROADMAP.md section 3), so
    # clipping scales its steps to 0 and only the decay moves it
    finite = ("loss", "aux_loss") + (() if cfg.enc_dec else ("grad_norm",))
    expect(all(math.isfinite(s[k]) for s in steps for k in finite),
           f"finite {finite}: {steps}")
    expect(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
           "finite parameters after the steps")
    expect(int(state.opt.step) == TRAIN_STEPS, "the optimizer counted "
           f"{int(state.opt.step)} steps")
    want = want_train_launches(cfg, remat)
    per_step = {k: launches[k] / TRAIN_STEPS for k in want}
    for k, n in want.items():
        expect(launches[k] == n * TRAIN_STEPS,
               f"{k}: {launches[k]} launches == {n} a step x {TRAIN_STEPS}")
    expect(gmm_bwd == (6 * cfg.n_layers if cfg.moe else 0) * TRAIN_STEPS,
           f"grouped GEMM backward launches {gmm_bwd}")
    expect(gmm_paths == {"tma": launches["grouped_matmul"] - gmm_bwd,
                         "wmma": 0},
           f"every grouped GEMM forward took the TMA + wgmma kernel: "
           f"{gmm_paths}")
    expect(gmm_bwd_kernels == {"dx": gmm_bwd // 2, "dw": gmm_bwd // 2},
           f"every bf16 grouped GEMM backward took the dx and dw kernels "
           f"(no transposed copy): {gmm_bwd_kernels} of {gmm_bwd}")
    bwd_paths = {k: c.value for k, c in flash_mod.bwd_paths.items()}
    expect(bwd_paths == {"mma": launches["flash_attention_bwd"], "fma": 0},
           f"every flash backward took the tensor-core kernels: {bwd_paths}")
    expect(not any(plain.calls.values()),
           f"no plain version on the card's training path: {plain.calls}")
    print(f"train: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {seq} "
          f"tokens, remat {remat}; peak memory {peak / 2 ** 30:.2f} "
          f"GiB; launches a step {per_step} (grouped GEMM "
          f"{gmm_bwd // TRAIN_STEPS} of them backward)", flush=True)
    profile = train_profile(step_fn, state, batches[-1])
    update = (update_profile(cfg, model, state, opt, rt, batches[-1])
              if profile_update else None)
    del state
    return dict(steps=steps, launches=launches, launches_per_step=per_step,
                profile=profile, update_profile=update,
                want_launches_per_step=want,
                grouped_matmul_backward_launches=gmm_bwd,
                grouped_matmul_bf16_launches=gmm_paths,
                grouped_matmul_backward_kernels=gmm_bwd_kernels,
                flash_bwd_paths=bwd_paths, peak_memory_bytes=peak,
                allocated_before_bytes=base, plain_calls=plain.calls,
                batch=TRAIN_BATCH, seq=seq, remat=remat,
                lr=TRAIN_LR, schedule=cfg.lr_schedule)


def train_profile(step_fn, state, batch):
    """One more step under ``torch.profiler`` (after the main path's
    counts are read): device busy time against the host clock, and the
    kernels that took the most device time, summed by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, kernel_device_us(e), e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(t for _, t, _ in kernels) / 1e6
    top = sorted(kernels, key=lambda ktn: -ktn[1])[:8]
    mine = {name: sum(t for k, t, _ in kernels if name in k) / 1e6
            for name in ("flash_mma_kernel", "flash_bwd_", "gmm_wgmma",
                         "gmm_bwd", "ssd_bwd_")}
    mine["adamw"] = sum(t for k, t, _ in kernels
                        if any(n in k for n in ADAMW_KERNELS)) / 1e6
    # copy kernels (the grouped GEMM's backward made two a call before its
    # own kernels): device seconds and launches
    copies = [(t, n) for k, t, n in kernels if "copy" in k.lower()]
    copy_s = sum(t for t, _ in copies) / 1e6
    mine["ssd_fwd"] = sum(t for k, t, _ in kernels
                          if "ssd_" in k and "ssd_bwd_" not in k) / 1e6
    # the backward kernels that ran: name -> (device seconds, launches)
    bwd = {kernel_name(k): (t / 1e6, n) for k, t, n in kernels
           if "_bwd_" in k}
    out = dict(wall_s=wall, device_busy_s=busy,
               kernel_launches=sum(n for _, _, n in kernels),
               idle_share=1.0 - busy / wall if busy else None,
               hand_written_s=mine, bwd_kernels=bwd, copy_s=copy_s,
               copy_launches=sum(n for _, n in copies),
               ssd_bwd_share=mine["ssd_bwd_"] / busy if busy else None,
               top_kernels_s=[(k[:80], t / 1e6, n) for k, t, n in top])
    print(f"train profile, one step: wall {wall:.4f} s, device busy "
          f"{busy:.4f} s, {out['kernel_launches']} kernel launches; "
          f"copy kernels {copy_s:.4f} s in {out['copy_launches']} "
          f"launches; hand-written kernels {mine}; backward kernels that ran "
          f"{bwd}; top {out['top_kernels_s'][:5]}", flush=True)
    return out


def adamw_lists(model, grads, moments, opt):
    """The optimizer's lists, in the model's order: parameters, gradients,
    first and second moments, decay flags."""
    names = list(grads)
    params = dict(model.named_parameters())
    return ([params[k].detach() for k in names], [grads[k] for k in names],
            [moments.m[k] for k in names], [moments.v[k] for k in names],
            [opt.decayed(k) for k in names])


def adamw_hyper(opt, step: int):
    """The update's scalars at ``step`` (1-based), as ``AdamW.update``
    computes them on the host."""
    c = opt.config
    sf = torch.tensor(float(step))
    return dict(lr=float(c.lr_at(torch.tensor(step))), b1=c.b1, b2=c.b2,
                b1c=float(1.0 - torch.pow(torch.tensor(c.b1), sf)),
                b2c=float(1.0 - torch.pow(torch.tensor(c.b2), sf)),
                eps=c.eps, wd=c.weight_decay)


def optimizer_step(lists, hyper, sumsq, total, update, clip: float = 1.0):
    """One norm, clip and update over ``lists`` (``adamw_lists``) with the
    given three functions (the kernels' ``ops`` entries or the plain
    versions); returns the norm."""
    ps, gs, ms, vs, decayed = lists
    with torch.no_grad():
        gnorm = torch.sqrt(total(sumsq(gs)))
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        update(ps, gs, ms, vs, decayed, scale, **hyper)
    return gnorm


PLAIN_UPDATE = (ref.grad_sumsq_ref, ref.sum_in_order_ref,
                ref.adamw_update_ref)


def kernel_update():
    """The kernels' three entries, looked up at the call (``ops``)."""
    return ops.grad_sumsq, ops.sum_in_order, ops.adamw_update


def update_profile(cfg, model, state, opt, rt, batch):
    """The optimizer's step by itself on the trained model's state and the
    gradients of one more batch: its device time (``torch.profiler``, the
    sum of its kernels) and kernels a call, the plain norm and loop (what
    every step ran before the kernels) beside the kernels'.  Each profiled
    call moves the parameters again; nothing is checked after."""
    batch = {k: v.to(CARD) for k, v in batch.items()}
    grads, _, _ = _accumulate_grads(make_loss_fn(cfg, rt), model, batch, rt)
    lists = adamw_lists(model, grads, state.opt, opt)
    hyper = adamw_hyper(opt, int(state.opt.step) + 1)
    out = {}
    for name, fns in (("plain", PLAIN_UPDATE), ("kernels", kernel_update())):
        ms, n = device_ms(lambda: optimizer_step(lists, hyper, *fns), 2)
        out[name] = dict(device_ms=ms, kernels_a_call=n)
    numels = [p.numel() for p in lists[0]]
    out["bound_ms"] = adamw_bound(numels, [p.dtype for p in lists[0]],
                                  [g.dtype for g in lists[1]])[0]
    out["tensors"], out["elements"] = len(numels), sum(numels)
    print(f"train update {cfg.arch}: one optimizer step by itself on the "
          f"trained state ({out['tensors']} tensors, {out['elements']} "
          f"elements), device time: plain norm and loop "
          f"{out['plain']['device_ms']:.3f} ms in "
          f"{out['plain']['kernels_a_call']} kernels, the kernels "
          f"{out['kernels']['device_ms']:.3f} ms in "
          f"{out['kernels']['kernels_a_call']}; bound "
          f"{out['bound_ms']:.3f} ms (bytes)", flush=True)
    del grads, lists
    return out


def plain_update_run(cfg, main):
    """TRAIN_STEPS steps of ``cfg`` again from the same weights and batches
    with the plain update (``ref.adamw_update_ref``) at the kernels' norm,
    the plain norm taken beside it; the losses and norms held to
    ``main``'s bit for bit, the plain norms to the kernels' within
    ADAMW_NORM_RTOL."""
    model = build_model(cfg)
    opt = build_optimizer(cfg, TRAIN_LR, TRAIN_STEPS)
    state = init_state(model, opt)
    step_fn = make_train_step(cfg, opt, RuntimeConfig(
        microbatches=1, remat=TRAIN_REMAT, loss_chunks=1, aux_weight=0.01))
    dc = DataConfig(vocab=cfg.vocab, seq_len=train_seq(cfg),
                    global_batch=TRAIN_BATCH, seed=0)
    sumsq, _, update = kernel_update()
    plain_norms = []

    def both_sums(grads):
        plain_norms.append(float(torch.sqrt(ref.sum_in_order_ref(
            ref.grad_sumsq_ref(grads)))))
        return sumsq(grads)

    ops.grad_sumsq, ops.adamw_update = both_sums, ref.adamw_update_ref
    try:
        steps = []
        for i in range(TRAIN_STEPS):
            state, metrics = step_fn(state, {**batch_at(dc, i),
                                             **train_extras(cfg, TRAIN_BATCH)})
            steps.append({k: float(metrics[k]) for k in ("loss",
                                                         "grad_norm")})
    finally:
        ops.grad_sumsq, ops.adamw_update = sumsq, update
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    kern = [{k: s[k] for k in ("loss", "grad_norm")} for s in main["steps"]]
    expect(kern == steps, f"the kernels' steps and the plain update's at "
           f"the kernels' norm the same bits: {kern} {steps}")
    norm_rel = [abs(p - s["grad_norm"]) / s["grad_norm"]
                for p, s in zip(plain_norms, steps)]
    expect(max(norm_rel) <= ADAMW_NORM_RTOL,
           f"each step's plain norm within {ADAMW_NORM_RTOL} of the "
           f"kernels': {norm_rel}")
    print(f"train {cfg.arch} with the plain update at the kernels' norm: "
          f"losses {[s['loss'] for s in steps]} and gradient norms "
          f"{[s['grad_norm'] for s in steps]}, the same bits as the "
          f"kernels'; the plain norms relative to the kernels' {norm_rel}",
          flush=True)
    return dict(steps=steps, plain_norms=plain_norms, norm_rel=norm_rel)


def adamw_inputs(cfg, budget: int, seed: int = 0):
    """bf16 parameters and gradients, float32 moments warm from a step (m ~
    1e-3, v ~ 1e-6), of ``cfg``'s parameter shapes from ``seed``: the first
    tensors, in the model's order, whose kernel set and plain copies fit
    ``budget`` bytes; and their names."""
    named = list(LM(cfg, device="meta").named_parameters())
    largest = max(p.numel() for _, p in named)
    room = budget - 8 * 4 * largest         # the plain loop's temporaries
    names, used = [], 0
    for k, p in named:
        # p, g, m, v and the plain run's p, m, v: 22 bytes an element
        if used + 22 * p.numel() > room:
            break
        names.append(k)
        used += 22 * p.numel()
    gen = torch.Generator(device=CARD).manual_seed(seed)
    shapes = dict(named)
    ps, gs, ms, vs = [], [], [], []
    for k in names:
        shp = shapes[k].shape
        ps.append(torch.randn(shp, device=CARD, generator=gen).bfloat16())
        gs.append((torch.randn(shp, device=CARD, generator=gen) * 1e-2)
                  .bfloat16())
        ms.append(torch.randn(shp, device=CARD, generator=gen) * 1e-3)
        vs.append((torch.randn(shp, device=CARD, generator=gen) * 1e-3)
                  .square_())
    return names, len(named), (ps, gs, ms, vs)


def adamw_kernel_phase(cfg):
    """AdamW's kernels at ``cfg``'s parameter shapes (``adamw_inputs``):
    the norm's two runs the same bits and within ADAMW_NORM_RTOL of the
    plain sums; the update from the same inputs at the same scale
    bit-identical to the plain loop; a sum of squares past float32 (the
    norm inf, the scale 0, finite and equal parameters); then the kernels
    and the plain step timed in turns by CUDA events (kernels, plain,
    plain, kernels), the kernels' device time, their bound, and
    ``torch._fused_adamw_`` tried as the library call."""
    free = torch.cuda.mem_get_info()[0]
    names, n_all, (ps, gs, ms, vs) = adamw_inputs(cfg, free - 3 * 2 ** 30)
    opt = AdamW(AdamWConfig())
    decayed = [opt.decayed(k) for k in names]
    hyper = adamw_hyper(build_optimizer(cfg, TRAIN_LR, TRAIN_STEPS), 2)
    numels = [p.numel() for p in ps]
    which = ("all" if len(names) == n_all else
             f"the first {len(names)} of {n_all} (to {names[-1]})")
    sq = [ops.grad_sumsq(gs) for _ in range(2)]
    totals = [ops.sum_in_order(x) for x in sq]
    want = torch.sqrt(ref.sum_in_order_ref(ref.grad_sumsq_ref(gs)))
    norm = torch.sqrt(totals[0])
    expect(torch.equal(sq[0], sq[1]) and torch.equal(*totals),
           "the kernels' norm the same bits in two runs")
    norm_rel = float((norm - want).abs() / want)
    expect(norm_rel <= ADAMW_NORM_RTOL, f"the kernels' norm {float(norm)} "
           f"within {ADAMW_NORM_RTOL} of the plain {float(want)}")
    scale = torch.clamp(1.0 / torch.clamp(norm, min=1e-12), max=1.0)
    copies = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    ops.adamw_update(ps, gs, ms, vs, decayed, scale, **hyper)
    ref.adamw_update_ref(*copies[:1], gs, *copies[1:], decayed, scale,
                         **hyper)
    torch.cuda.synchronize()
    err, same = 0.0, True
    for got, plain in zip((ps, ms, vs), copies):
        for a, b in zip(got, plain):
            same &= torch.equal(a, b)
            if a.numel():
                err = max(err, float((a.float() - b.float()).abs().max()))
    expect(same, f"the kernels' p, m and v bit-identical to the plain loop "
           f"(max |err| {err})")
    del copies
    # the overflow: whisper's case at full depth (ROADMAP.md section 3)
    og = [torch.full((4096,), 1e19, device=CARD), torch.ones(10, device=CARD)]
    op = [torch.randn(t.shape, device=CARD).bfloat16() for t in og]
    om = [torch.zeros(t.shape, device=CARD) for t in og]
    sides = []
    for fns in (kernel_update(), PLAIN_UPDATE):
        lists = ([t.clone() for t in op], og, [t.clone() for t in om],
                 [t.clone() for t in om], [True, True])
        sides.append((optimizer_step(lists, hyper, *fns), lists[0]))
    expect(all(torch.isinf(n) for n, _ in sides)
           and all(torch.isfinite(t.float()).all() for _, ts in sides
                   for t in ts)
           and all(torch.equal(a, b) for a, b in zip(sides[0][1],
                                                     sides[1][1])),
           "a sum of squares past float32: the norm inf in both, the scale "
           "0, the parameters finite and equal")
    lists = (ps, gs, ms, vs, decayed)
    kernel = lambda: optimizer_step(lists, hyper, *kernel_update())
    plain = lambda: optimizer_step(lists, hyper, *PLAIN_UPDATE)
    turns = {"kernels": [], "plain": []}
    for side in ("kernels", "plain", "plain", "kernels"):
        turns[side].append(cuda_ms(kernel if side == "kernels" else plain,
                                   10 if side == "kernels" else 3))
    dev_ms, dev_kernels = device_ms(kernel, 3)
    try:
        torch._fused_adamw_(ps[:1], gs[:1], ms[:1], vs[:1], [],
                            [torch.tensor(2.0, device=CARD)], lr=hyper["lr"],
                            beta1=hyper["b1"], beta2=hyper["b2"],
                            weight_decay=hyper["wd"], eps=hyper["eps"],
                            amsgrad=False, maximize=False)
        library = "accepted"
    except RuntimeError as e:
        library = f"refused: {str(e).splitlines()[0]}"
    bound = adamw_bound(numels, [p.dtype for p in ps], [g.dtype for g in gs])
    out = dict(shape=f"{cfg.arch} parameters, {which}: {len(numels)} "
                     f"tensors, {sum(numels)} elements, bf16 p and g",
               tensors=len(numels), elements=sum(numels), all=which == "all",
               ms=min(turns["kernels"]), plain_ms=min(turns["plain"]),
               turns=turns, device_ms=dev_ms, device_kernels=dev_kernels,
               bound=bound, library_ms=None, library=library,
               max_abs_err=err, norm_rel=norm_rel)
    print(f"kernel adamw {out['shape']}: {out['ms']:.4f} ms (in turns "
          f"{turns['kernels']}; device {dev_ms:.4f} ms in {dev_kernels} "
          f"kernels), plain {out['plain_ms']:.4f} ms (in turns "
          f"{turns['plain']}), bound {bound[0]:.4f} ms ({bound[1]}); p, m, "
          f"v bit-identical, max err {err}; norm relative to the plain "
          f"{norm_rel:.3g}, two runs the same bits; overflow: norm inf, "
          f"scale 0; torch._fused_adamw_ on bf16 parameters with float32 "
          f"moments: {library}", flush=True)
    del ps, gs, ms, vs, lists
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grad_group(name: str) -> str:
    """A gradient's group in the gradient head checks."""
    if name in ("x", "pos_embed"):
        return name
    if name.startswith("embed."):
        return "embed"
    if name.startswith("encoder.layers."):     # whisper's encoder
        for part in ("attn", "ffn"):
            if f".{part}." in name:
                return "enc_" + part
    if ".xattn." in name:                  # whisper's cross-attention
        return "xattn"
    if ".ssm." in name:                   # zamba2's Mamba2 layers
        leaf = name.rsplit(".", 1)[1]
        if leaf in ("A_log", "D", "dt_bias"):
            return "ssm_scalars"
        if leaf.startswith("conv_"):
            return "conv"
        return "norms" if leaf == "norm" else "ssm_proj"
    if ".attn.attn." in name or ".attn.ffn." in name:  # zamba2's attention
        return "attn"
    if ".attn." in name:
        return "attn"
    if ".ffn." in name:                   # a dense block's MLP
        return "ffn"
    if name.endswith("moe.router"):
        return "router"
    if "moe." in name:
        return "experts"
    return "norms"


def head_grads(head, state, batch, dtype, dev):
    """The head's gradients (float32, CPU) for one batch (its extras, an
    encoder-decoder's frames, in ``dtype``), on ``dev`` in ``dtype``:
    kernels and their backward on the card, plain versions on the CPU."""
    m = head_model(head, state, dtype, dev)
    params = trainable(m)
    extras = {k: v.to(dev, dtype) for k, v in batch.items()
              if k not in ("tokens", "labels")}
    total, _ = make_loss_fn(head, RuntimeConfig(remat=None))(
        m, batch["tokens"].to(dev), batch["labels"].to(dev), extras)
    grads = torch.autograd.grad(total, list(params.values()))
    return {k: g.float().cpu() for k, g in zip(params, grads)}


def moe_grads(head, state, x_in, dy, dtype, dev):
    """The gradients of sum(moe_ffn(x_in) * dy) for the head's first MoE
    FFN (its parameters ``moe.*`` and its input ``x``), float32 on the CPU,
    computed on ``dev`` in ``dtype``."""
    m = head_model(head, state, dtype, dev)
    p = m.layers[0]["moe"]
    params = {f"moe.{k}": v for k, v in trainable(p).items()}
    x = x_in.to(dev, dtype).requires_grad_(True)
    y, _ = moe_mod.moe_ffn(x, p, head)
    total = (y.float() * dy.to(dev)).sum()
    grads = torch.autograd.grad(total, [*params.values(), x])
    return {k: g.float().cpu() for k, g in zip([*params, "x"], grads)}


def grad_rel(got, want, groups=GRAD_GROUPS):
    """Relative L2 by group: ||got - want|| / ||want|| over the group's
    gradients."""
    out = {}
    for grp in groups:
        keys = [k for k in want if grad_group(k) == grp]
        num = sum(((got[k] - want[k]) ** 2).sum() for k in keys)
        den = sum((want[k] ** 2).sum() for k in keys)
        out[grp] = math.sqrt(float(num) / float(den))
    return out


def grad_check_inputs(cfg, model, seed: int = 1):
    """The head, its parameters, the head's batch (``batch_at`` of data
    seed ``seed``), and for the MoE FFN alone its input from the CPU
    float32 run and an output gradient drawn from ``seed``."""
    head, state = model_head(cfg, model)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                global_batch=1, seed=seed), 0)
    x_in = moe_inputs(head, state, batch["tokens"], "cpu")[0][0]
    dy = torch.randn(x_in.shape, generator=torch.Generator().manual_seed(
        seed))
    return head, state, batch, x_in, dy


def train_head_check(cfg, model, dev="cuda"):
    """The gradients of the model's head on one batch, card float32 and
    bf16 against the CPU's float32 plain ones, and of its first MoE FFN
    alone in bf16 (see GRAD_F32_REL)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    head, state, batch, x_in, dy = grad_check_inputs(cfg, model)
    want = head_grads(head, state, batch, torch.float32, "cpu")
    want_moe = moe_grads(head, state, x_in, dy, torch.float32, "cpu")
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    f32 = grad_rel(head_grads(head, state, batch, torch.float32, dev), want)
    b16 = grad_rel(head_grads(head, state, batch, torch.bfloat16, dev),
                   want)
    moe16 = grad_rel(moe_grads(head, state, x_in, dy, torch.bfloat16, dev),
                     want_moe, MOE_GRAD_GROUPS)
    for grp in GRAD_GROUPS:
        expect(math.isfinite(f32[grp]) and f32[grp] <= GRAD_F32_REL,
               f"card f32 vs CPU f32 gradients of {grp}: relative L2 "
               f"{f32[grp]} <= {GRAD_F32_REL}")
        expect(math.isfinite(b16[grp]), f"finite bf16 gradients of {grp}")
    for grp in MOE_GRAD_GROUPS:
        expect(math.isfinite(moe16[grp]) and moe16[grp] <= GRAD_BF16_REL[grp],
               f"card bf16 vs CPU f32 MoE FFN gradients of {grp}: relative "
               f"L2 {moe16[grp]} <= {GRAD_BF16_REL[grp]}")
    print(f"train {MOE_CHECK_LAYERS} layers' gradients, relative L2 to CPU "
          f"f32: card f32 {f32}; card bf16 {b16}; first MoE FFN alone, card "
          f"bf16 {moe16} (CPU {cpu_s:.1f} s)", flush=True)
    return dict(f32_rel_l2=f32, bf16_rel_l2=b16, moe_bf16_rel_l2=moe16,
                cpu_seconds=cpu_s,
                tolerance=f"head f32: {GRAD_F32_REL}; head bf16: reported; "
                          f"MoE FFN bf16: {GRAD_BF16_REL}")


def train_phase():
    """Training of TRAIN_ARCH: its kernels' gradients, the main path, the
    gradient head check; the model is freed before returning."""
    cfg = get_config(TRAIN_ARCH)
    with part(f"train {cfg.arch} kernels"):
        kernels = train_kernel_phase(cfg)
    r = kernels["flash_attention_bwd"]
    print(f"kernel flash_attention_bwd {r['shape']} bfloat16: {r['ms']:.4f} "
          f"ms (in turns {r['turns']['kernel']}), plain {r['plain_ms']:.4f} "
          f"ms, SDPA backward {r['library_ms']:.4f} ms (in turns "
          f"{r['turns']['sdpa']}), device time alone (ms, kernels a call): "
          f"kernel {r['device_ms']['kernel']}, SDPA backward "
          f"{r['device_ms']['sdpa']}; bound {r['bound'][0]:.4f} ms "
          f"({r['bound'][1]}), max err {r['max_abs_err']:.3g}, worst share "
          f"of the bound {r['bf16_worst_share_of_bound']:.3f} (cancelling "
          f"head {r['cancelling_worst_share_of_bound']:.3f}); forward with "
          f"lse {r['forward_with_lse_ms']} ms", flush=True)
    for name, r in kernels["grouped_matmul_bwd"].items():
        if "ms" in r:
            print(f"kernel grouped_matmul backward {name} {r['shape']} "
                  f"bfloat16 (dx + dw): {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, torch.bmm backward "
                  f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
                  f"({r['bound'][1]})", flush=True)
        for prod in ("dx", "dw"):
            p = r[prod]
            print(f"kernel grouped_matmul_{prod} {name} {r['shape']} "
                  f"bfloat16: worst share of its bound "
                  f"{p['bf16_worst_share_of_bound']:.3f}"
                  + (f", {p['ms']:.4f} ms (device {p['device_ms']:.4f}), "
                     f"plain {p['plain_ms']:.4f} ms, torch.bmm "
                     f"{p['library_ms']:.4f} ms, bound {p['bound'][0]:.4f} "
                     f"ms ({p['bound'][1]})" if "ms" in p else ""),
                  flush=True)
    model = build_model(cfg)
    head = train_head_check(cfg, model)      # the parameters as built
    main = train_main_path(cfg, model, profile_update=True)
    with part(f"train {cfg.arch} microbatch accumulation"):
        kernels["grad_accum"] = grad_accum_phase(cfg, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with part(f"train {cfg.arch} plain update run and adamw kernels"):
        main["plain_update_run"] = plain_update_run(cfg, main)
        kernels["adamw"] = adamw_kernel_phase(get_config(ADAMW_ARCH))
    return kernels, main, head


def accumulate_once(cfg, model, batch, rt, plain_version: bool):
    """``_accumulate_grads`` on ``batch`` at ``rt``'s microbatches, with the
    kernel or with the plain version patched into ``ops``; the counters
    from 0 just before: (gradients, loss, aux, grad_accum launches, plain
    calls, peak bytes above what it found)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    found = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    saved = ops.grad_accumulate
    with PlainCalls() as plain:
        if plain_version:
            ops.grad_accumulate = ref.grad_accumulate_ref
        try:
            grads, loss, aux = _accumulate_grads(make_loss_fn(cfg, rt), model,
                                                 batch, rt)
            torch.cuda.synchronize()
        finally:
            ops.grad_accumulate = saved
    return (grads, float(loss), float(aux),
            ops.COUNTERS["grad_accum"].value, dict(plain.calls),
            torch.cuda.max_memory_allocated() - found)


def grad_accum_phase(cfg, model):
    """The microbatch accumulation on ``model`` at full width: one
    TRAIN_BATCH x TRAIN_SEQ batch at ACCUM_MICROBATCHES microbatches through
    ``_accumulate_grads``, with the kernel and with the plain version
    patched into ``ops``, no optimizer step: every accumulated gradient
    the same bits (compared as int32 patterns: ``torch.equal`` takes -0.0
    for +0.0), the same loss, the kernel launched once a microbatch and no
    plain version on its side, each side's peak.  Then the kernel alone at
    the model's parameter list with bf16 gradients, in turns by CUDA
    events: a middle call, a last call, the plain version's middle call,
    and the library's (``torch._foreach_add_``, then ``_foreach_mul_`` for
    the last call), the library's bits checked against the kernel's; the
    bytes bound of each call."""
    M = ACCUM_MICROBATCHES
    trainable(model)
    rt = RuntimeConfig(microbatches=M, remat=TRAIN_REMAT, loss_chunks=1,
                       aux_weight=0.01)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, seed=0)
    batch = {k: v.to(CARD) for k, v in batch_at(dc, 0).items()}
    kg, kloss, kaux, klaunch, kplain, kpeak = accumulate_once(
        cfg, model, batch, rt, False)
    pg, ploss, paux, plaunch, pplain, ppeak = accumulate_once(
        cfg, model, batch, rt, True)
    names = list(kg)
    same = [torch.equal(kg[k].view(torch.int32), pg[k].view(torch.int32))
            for k in names]
    expect(all(same), f"the kernel's accumulated gradients bit-identical to "
           f"the plain version's: {sum(same)} of {len(same)} tensors")
    expect((kloss, kaux) == (ploss, paux), f"the same loss and aux: "
           f"{(kloss, kaux)} {(ploss, paux)}")
    expect(klaunch == M and not any(kplain.values()),
           f"the kernel side launched grad_accum {klaunch} times (want {M}) "
           f"and no plain version: {kplain}")
    expect(plaunch == 0 and pplain["grad_accumulate_ref"] == M,
           f"the plain side launched nothing ({plaunch}) and called the "
           f"plain version {M} times: {pplain}")
    del pg
    accs = [kg[k] for k in names]
    del kg
    gen = torch.Generator(device=CARD).manual_seed(5)
    gs = [(torch.randn(a.shape, device=CARD, generator=gen) * 1e-3)
          .bfloat16() for a in accs]
    numels = [a.numel() for a in accs]
    # the library's bits, from a copy of the accumulators
    lib = [a.clone() for a in accs]
    ops.grad_accumulate(accs, gs, mode="middle")
    torch._foreach_add_(lib, gs)
    lib_same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(accs, lib))
    ops.grad_accumulate(accs, gs, mode="last", scale=1.0 / M)
    torch._foreach_add_(lib, gs)
    torch._foreach_mul_(lib, 1.0 / M)
    lib_same &= all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(accs, lib))
    expect(lib_same, "torch._foreach_add_ (and _foreach_mul_) give the "
           "kernel's bits")
    del lib
    calls = {
        "kernel": (lambda: ops.grad_accumulate(accs, gs, mode="middle"), 10),
        "kernel last": (lambda: ops.grad_accumulate(
            accs, gs, mode="last", scale=1.0 / M), 10),
        "plain": (lambda: ref.grad_accumulate_ref(accs, gs, mode="middle"),
                  3),
        "library": (lambda: torch._foreach_add_(accs, gs), 3),
        "library last": (lambda: (torch._foreach_add_(accs, gs),
                                  torch._foreach_mul_(accs, 1.0 / M)), 3)}
    turns = {k: [] for k in calls}
    for k in [*calls, *reversed(calls)]:
        fn, reps = calls[k]
        turns[k].append(cuda_ms(fn, reps))
    ms = {k: min(v) for k, v in turns.items()}
    g_dtypes = [g.dtype for g in gs]
    bound = grad_accum_bound(numels, g_dtypes, "middle")
    last_bound = grad_accum_bound(numels, g_dtypes, "last")
    del accs, gs
    gc.collect()
    torch.cuda.empty_cache()
    shape = (f"{cfg.arch} parameters: {len(numels)} tensors, {sum(numels)} "
             f"elements, bf16 gradients into float32")
    print(f"train {cfg.arch} microbatches {M} (one {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} batch, no update): the kernel's accumulated "
          f"gradients bit-identical to the plain version's over "
          f"{len(same)} tensors, loss {kloss} both; grad_accum launches "
          f"{klaunch}; peak above what each found: kernel {kpeak} bytes, "
          f"plain version {ppeak} bytes", flush=True)
    print(f"kernel grad_accum {shape}: middle call {ms['kernel']:.4f} ms "
          f"(in turns {turns['kernel']}), last call "
          f"{ms['kernel last']:.4f} ms ({turns['kernel last']}); plain "
          f"{ms['plain']:.4f} ms ({turns['plain']}); library "
          f"torch._foreach_add_ {ms['library']:.4f} ms "
          f"({turns['library']}), + _foreach_mul_ "
          f"{ms['library last']:.4f} ms ({turns['library last']}), its "
          f"bits the kernel's; bound middle {bound[0]:.4f} ms ({bound[1]}), "
          f"last {last_bound[0]:.4f} ms ({last_bound[1]})", flush=True)
    return dict(shape=shape, tensors=len(numels), elements=sum(numels),
                microbatches=M, ms=ms["kernel"], last_ms=ms["kernel last"],
                plain_ms=ms["plain"], library_ms=ms["library"],
                library_last_ms=ms["library last"], turns=turns,
                bound=bound, last_bound=last_bound, max_abs_err=0.0,
                bit_identical=True, library_bit_identical=lib_same,
                launches=klaunch, peak_bytes={"kernel": kpeak,
                                              "plain": ppeak},
                loss=kloss)


# ---------------------------------------------------------------------------
# zamba2 training: the SSD backward kernel, a gradient head check, four
# full-width steps
# ---------------------------------------------------------------------------

def ssd_grads(fn, inputs, h0, dy, dh, chunk):
    """fn's (y, h_final) and its gradients (dx, ddt, dB, dC, dA and, with an
    h0, dh0) for the output gradients dy and dh (None: h_final unused)."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    h0r = None if h0 is None else h0.detach().clone().requires_grad_(True)
    y, h = fn(*xs, chunk=chunk, h0=h0r)
    outs, gs = ([y, h], [dy, dh]) if dh is not None else ([y], [dy])
    return torch.autograd.grad(outs, xs + ([] if h0r is None else [h0r]),
                               gs)


def ssd_grads_err(got, want, what):
    """The largest |err| of the gradients; fails past SSD_BWD_TOL x the
    largest |plain| of any one of them."""
    err_max = 0.0
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"), got, want):
        err = (g - w).abs().max().item()
        scale = w.abs().max().item()
        expect(math.isfinite(err) and err <= SSD_BWD_TOL * scale,
               f"ssd backward {what} {name}: max err {err} <= {SSD_BWD_TOL} x "
               f"{scale}")
        err_max = max(err_max, err)
    return err_max


def ssd_train_kernel_phase(cfg, dev="cuda"):
    """The SSD scan's backward kernel against autograd through the plain
    recurrence at zamba2's training shape and on a chained ragged tail with
    h0 and dh_final; bit-identical repeats; timed in turns with the plain
    version's backward."""
    g = torch.Generator(device=dev).manual_seed(0)
    s = cfg.ssm
    nh, hd, ds, Q = s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.chunk
    B, S = TRAIN_BATCH, TRAIN_SEQ

    def inputs(Bsz, n):
        x = torch.randn((Bsz, n, nh * hd), generator=g, device=dev) * 0.5
        dt = F.softplus(torch.randn((Bsz, n, nh), generator=g, device=dev))
        Bm = torch.randn((Bsz, n, ds), generator=g, device=dev) * 0.5
        Cm = torch.randn((Bsz, n, ds), generator=g, device=dev) * 0.5
        return x, dt, Bm, Cm

    A = -torch.exp(torch.randn(nh, generator=g, device=dev) * 0.3)
    x, dt, Bm, Cm = inputs(B, S)
    main = (x, dt, Bm, Cm, A)
    dy = torch.randn(x.shape, generator=g, device=dev)
    got = ssd_grads(ops.ssd_scan, main, None, dy, None, Q)
    want = ssd_grads(ref.ssd_scan_ref, main, None, dy, None, Q)
    err = ssd_grads_err(got, want, f"{list(x.shape)}")
    again = ssd_grads(ops.ssd_scan, main, None, dy, None, Q)
    expect(all(torch.equal(a, b) for a, b in zip(got, again)),
           "ssd backward: a second call gives the same bits")
    # 512 positions in chunks of Q, then a ragged tail of its own through
    # h0, as ssd_prefill chains a prompt's tail; an h0 into the first call
    # and a gradient of the final state
    tail = 232
    xt, dtt, Bt, Ct = inputs(1, S + tail)
    h0 = torch.randn((1, nh, ds, hd), generator=g, device=dev)
    dyt = torch.randn(xt.shape, generator=g, device=dev)
    dh = torch.randn((1, nh, ds, hd), generator=g, device=dev)

    def chained(x, dt, Bm, Cm, A, chunk, h0):
        y1, h1 = ops.ssd_scan(x[:, :S], dt[:, :S], Bm[:, :S], Cm[:, :S], A,
                              chunk=Q, h0=h0)
        y2, h2 = ops.ssd_scan(x[:, S:], dt[:, S:], Bm[:, S:], Cm[:, S:], A,
                              chunk=tail, h0=h1)
        return torch.cat([y1, y2], 1), h2
    tail_in = (xt, dtt, Bt, Ct, A)
    err_tail = ssd_grads_err(
        ssd_grads(chained, tail_in, h0, dyt, dh, 1),
        ssd_grads(ref.ssd_scan_ref, tail_in, h0, dyt, dh, 1),
        f"chained {S} + {tail}, h0 and dh_final")
    # timed: the kernel alone (the forward's states and cum as autograd
    # keeps them) in turns with autograd through the plain version
    _, _, states, cum = ssd_mod.ssd_scan_with_states(*main, chunk=Q)
    kernel = lambda: ssd_mod.ssd_scan_backward(*main, None, states, cum, dy,
                                               None, chunk=Q)
    plain = backward_of(lambda *t, chunk: ref.ssd_scan_ref(*t, chunk=chunk
                                                           )[0],
                        main, dy, chunk=Q)
    turns = {"kernel": [], "plain": []}
    for _ in range(2):                 # in turns: kernel, plain, kernel, plain
        turns["kernel"].append(cuda_ms(kernel, 10))
        turns["plain"].append(cuda_ms(plain, 1))
    device = device_ms(kernel)
    expect(device[1] in (None, ssd_mod.BWD_KERNELS_PER_CALL),
           f"the profiler saw every SSD backward kernel: {device}")
    by_kernel = {name: ms for name, (ms, _) in
                 profiled_kernels(kernel).items()}
    torch.cuda.synchronize()
    return {"ssd_scan_bwd": dict(
        max_abs_err=max(err, err_tail), chained_max_abs_err=err_tail,
        ms=sum(turns["kernel"]) / 2, plain_ms=sum(turns["plain"]) / 2,
        library_ms=None, turns=turns, device_ms=device[0],
        device_ms_by_kernel=by_kernel, shape=[B, S, nh, hd, ds, Q],
        dtype="float32", kernels_per_call=ssd_mod.BWD_KERNELS_PER_CALL,
        tolerance=f"every gradient max |err| <= {SSD_BWD_TOL} x max |plain|",
        bound=ssd_bwd_bound(B, S, Q, nh, hd, ds),
        bound_split_tf32=ssd_bwd_split_bound(B, S, Q, nh, hd, ds))}


def grad_head_check(cfg, model, groups, limit, dev="cuda"):
    """The gradients of the model's head (``model_head``: zamba2's first
    hybrid group, gemma2's first local/global pair, any other model's first
    2 layers; the full-width embedding) on one 1 x TRAIN_SEQ batch, card
    float32 (kernels) against the CPU's float32 plain ones by parameter
    group under ``limit``; card bf16 reported (see HYBRID_GRAD_F32_REL,
    FAMILY_GRAD_F32_REL)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    head, state, batch = hybrid_grad_inputs(cfg, model)
    want = head_grads(head, state, batch, torch.float32, "cpu")
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    expect(set(map(grad_group, want)) == set(groups),
           f"every gradient in a group: {sorted(set(map(grad_group, want)))}")
    f32 = grad_rel(head_grads(head, state, batch, torch.float32, dev), want,
                   groups)
    b16 = grad_rel(head_grads(head, state, batch, torch.bfloat16, dev),
                   want, groups)
    for grp in groups:
        expect(math.isfinite(f32[grp]) and f32[grp] <= limit,
               f"{cfg.arch} card f32 vs CPU f32 gradients of {grp}: "
               f"relative L2 {f32[grp]} <= {limit}")
        expect(math.isfinite(b16[grp]), f"finite bf16 gradients of {grp}")
    print(f"train {cfg.arch} head's gradients, relative L2 to CPU f32: card "
          f"f32 {f32}; card bf16 {b16} (CPU {cpu_s:.1f} s)", flush=True)
    return dict(f32_rel_l2=f32, bf16_rel_l2=b16, cpu_seconds=cpu_s,
                tolerance=f"f32: {limit}; bf16: reported")


def hybrid_grad_inputs(cfg, model, seed: int = 1):
    """The head (``model_head``), its parameters and ``batch_at``'s batch of
    data seed ``seed``, 1 x TRAIN_SEQ (whisper: 1 x WHISPER_CAPACITY, with
    frames (1, enc_frames, d_model) drawn from a generator of that
    seed)."""
    head, state = model_head(cfg, model)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=train_seq(cfg),
                                global_batch=1, seed=seed), 0)
    if cfg.enc_dec:
        batch["frames"] = torch.randn(
            (1, cfg.enc_frames, cfg.d_model),
            generator=torch.Generator().manual_seed(seed))
    return head, state, batch


def hybrid_train_phase():
    """Training of HYBRID_TRAIN_ARCH: the SSD backward kernel, the gradient
    head check, the main path; the model is freed before returning."""
    cfg = get_config(HYBRID_TRAIN_ARCH)
    kernels = ssd_train_kernel_phase(cfg)
    r = kernels["ssd_scan_bwd"]
    print(f"kernel ssd_scan_bwd {r['shape']} float32: {r['ms']:.4f} ms (in "
          f"turns {r['turns']['kernel']}), autograd through the plain "
          f"version {r['plain_ms']:.4f} ms (in turns {r['turns']['plain']}),"
          f" device time alone {r['device_ms']:.4f} ms in "
          f"{r['kernels_per_call']} kernels {r['device_ms_by_kernel']}; "
          f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}; at the "
          f"split-TF32 tensor-core rate {r['bound_split_tf32'][0]:.4f} ms, "
          f"{r['bound_split_tf32'][1]}), max err "
          f"{r['max_abs_err']:.3g} (chained tail "
          f"{r['chained_max_abs_err']:.3g})", flush=True)
    model = build_model(cfg)
    head = grad_head_check(cfg, model, HYBRID_GRAD_GROUPS,
                           HYBRID_GRAD_F32_REL)   # the parameters as built
    main = train_main_path(cfg, model, HYBRID_TRAIN_REMAT,
                           profile_update=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return kernels, main, head


# ---------------------------------------------------------------------------
# the other families: mamba2, minicpm, gemma2, nemotron and internvl2 served
# at full width and depth; mixtral and command-r-plus at full width with
# their depth cut; mamba2, minicpm and gemma2 trained; the train_lm example
# ---------------------------------------------------------------------------

def build_model(cfg, dtype=torch.bfloat16):
    """``cfg``'s model on the card, random weights from seed 0."""
    t0 = time.perf_counter()
    model = LM(cfg, dtype=dtype, device=CARD,
               generator=torch.Generator(device=CARD).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"lm {cfg.arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.2f}e9 parameters in {str(dtype)[6:]}, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model


def flash_kw(cfg, window=None):
    """The flash call a layer of ``cfg`` makes."""
    return dict(causal=True, window=window, logit_cap=cfg.attn_softcap,
                scale=cfg.attn_scale)


def family_kernel_phase(cfg):
    """Each kernel of the arch's serving path against its plain version at
    the arch's own shapes, bf16 as the model calls it, each timed beside
    its plain version and the library's call: flash at the largest prompt
    (gemma2 also over WINDOW_PROMPT tokens with its window in force), the
    SSD scan at mamba2's (1536 tokens, float32 x as the model feeds it,
    then a chained tail), the grouped GEMM at mixtral's prefill."""
    dev = torch.device(CARD)
    g = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    results = {}

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    if cfg.n_heads:
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        shapes = [(LM_PROMPTS[1], cfg.sliding_window if
                   cfg.sliding_window and not cfg.local_global_pattern
                   else None)]
        if cfg.arch == WINDOW_ARCH:
            shapes.append((WINDOW_PROMPT, cfg.sliding_window))
        for S, window in shapes:
            kw = flash_kw(cfg, window)
            q, k, v = randn(1, H, S, hd), randn(1, KV, S, hd), randn(1, KV, S,
                                                                     hd)
            got, want = ops.flash_attention(q, k, v, **kw), \
                ref.attention_ref(q, k, v, **kw)
            ex = bf16_excess(got, want, FLASH_TOL)
            expect(ex <= 1.0, f"flash {cfg.arch} {[1, H, KV, S, hd]} {kw}: "
                   f"worst element at {ex:.3f} of its bound")
            sdpa_kw = dict(is_causal=True, enable_gqa=True, scale=cfg.attn_scale)
            lib = (None if window or cfg.attn_softcap else cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, **sdpa_kw),
                10))
            results[f"flash_attention {cfg.arch} S{S}"] = dict(
                max_abs_err=(got.float() - want.float()).abs().max().item(),
                ms=cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), 10),
                plain_ms=cuda_ms(lambda: ref.attention_ref(q, k, v, **kw), 2),
                library_ms=lib, shape=[1, H, KV, S, hd], dtype="bfloat16",
                kw={k_: v_ for k_, v_ in kw.items() if v_},
                bf16_worst_share_of_bound=ex,
                tolerance=f"bf16: |err| <= 2^-7 |plain| + {FLASH_TOL} "
                          "elementwise",
                bound=flash_bound(1, H, KV, S, S, hd, bf16, window=window))
    if cfg.ssm is not None:
        s = cfg.ssm
        nh, shd, ds, Q = s.n_heads(cfg.d_model), s.head_dim, s.d_state, \
            s.chunk
        S, tail = LM_PROMPTS[1], 232
        f32 = torch.float32
        x = randn(1, S + tail, nh * shd, dtype=f32) * 0.5
        dt = F.softplus(randn(1, S + tail, nh, dtype=f32))
        Bm = randn(1, S + tail, ds, dtype=f32) * 0.5
        Cm = randn(1, S + tail, ds, dtype=f32) * 0.5
        A = -torch.exp(randn(nh, dtype=f32) * 0.3)
        main = (x[:, :S], dt[:, :S], Bm[:, :S], Cm[:, :S], A)
        y1, h1 = ops.ssd_scan(*main, chunk=Q)
        y2, h2 = ops.ssd_scan(x[:, S:], dt[:, S:], Bm[:, S:], Cm[:, S:], A,
                              chunk=tail, h0=h1)
        wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=1)
        err_y = (torch.cat([y1, y2], 1) - wy).abs().max().item()
        err_h = (h2 - wh).abs().max().item()
        sy, sh = wy.abs().max().item(), wh.abs().max().item()
        expect(err_y <= SSD_TOL * max(1.0, sy)
               and err_h <= SSD_TOL * max(1.0, sh),
               f"ssd {cfg.arch} f32 + chained tail: y err {err_y} (max "
               f"{sy}), h err {err_h} (max {sh})")
        results[f"ssd_scan {cfg.arch}"] = dict(
            max_abs_err=max(err_y, err_h),
            ms=cuda_ms(lambda: ops.ssd_scan(*main, chunk=Q), 10),
            plain_ms=cuda_ms(lambda: ref.ssd_scan_ref(*main, chunk=Q), 2),
            library_ms=None, shape=[1, S, nh, shd, ds, Q], dtype="float32",
            tolerance=f"{SSD_TOL} x max(1, max |y|) and x max(1, max |h|)",
            bound=ssd_bound(1, S, Q, nh, shd, ds, f32),
            bound_split_tf32=ssd_split_bound(1, S, Q, nh, shd, ds, f32))
    if cfg.moe is not None:
        E, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff
        C = moe_mod.capacity(cfg, CUT_PROMPT)
        for name, (d_, f_) in (("w_in", (d, f)), ("w_out", (f, d))):
            x = randn(E, C, d_)
            w = (torch.randn((E, d_, f_), generator=g, device=dev)
                 * d_ ** -0.5).to(bf16)
            expect(bool(gmm_mod.tma_rows(x, w)),
                   f"{cfg.arch} grouped GEMM {name} takes the TMA kernel")
            got, want = ops.grouped_matmul(x, w), ref.grouped_matmul_ref(x, w)
            scale = want.float().abs().max().item()
            ex = bf16_excess(got, want, GMM_TOL * scale)
            expect(ex <= 1.0, f"grouped_matmul {cfg.arch} {name} "
                   f"{[E, C, d_, f_]}: worst element at {ex:.3f} of its "
                   "bound")
            results[f"grouped_matmul {cfg.arch} {name}"] = dict(
                max_abs_err=(got.float() - want.float()).abs().max().item(),
                ms=cuda_ms(lambda: ops.grouped_matmul(x, w), 10),
                plain_ms=cuda_ms(lambda: ref.grouped_matmul_ref(x, w), 3),
                library_ms=cuda_ms(lambda: torch.bmm(x, w), 10),
                shape=[E, C, d_, f_], dtype="bfloat16",
                bf16_worst_share_of_bound=ex,
                tolerance=f"bf16: |err| <= 2^-7 |plain| + {GMM_TOL} x max "
                          "|plain| elementwise",
                bound=gmm_bound(E, C, d_, f_, bf16))
    torch.cuda.synchronize()
    for name, r in results.items():
        print(f"kernel {name} {r['shape']} {r['dtype']}: {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, "
              f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), max err "
              f"{r['max_abs_err']:.3g}", flush=True)
    return results


def window_phase(cfg, model):
    """gemma2 past its window: one WINDOW_PROMPT-token request at capacity
    WINDOW_CAPACITY through ServeEngine.  Its local layers mask in flash
    (window 4096 < 5120), prefill rolls their cache into 4096 rows, and the
    decode steps run under the window."""
    expect(WINDOW_PROMPT > cfg.sliding_window, "the prompt passes the window")
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab, WINDOW_PROMPT).tolist()
    serve = lm_main_path(cfg, model, max_new=WINDOW_DECODE + 1,
                         prompts=[prompt], slots=1, capacity=WINDOW_CAPACITY)
    pairs = cfg.n_layers // 2
    expect(serve["cache_shapes"]["k_local"][2] == cfg.sliding_window
           and serve["cache_shapes"]["k_global"][2] == WINDOW_CAPACITY,
           f"a rolling local cache of the window's rows: "
           f"{serve['cache_shapes']}")
    expect(serve["decode"]["steps"] == WINDOW_DECODE
           and serve["launches"]["flash_attention"] == 2 * pairs,
           f"{WINDOW_DECODE} decode steps, flash once a layer: {serve}")
    print(f"lm {cfg.arch} past its window: {WINDOW_PROMPT} tokens at "
          f"capacity {WINDOW_CAPACITY}, local cache "
          f"{serve['cache_shapes']['k_local']}", flush=True)
    return serve


def frontend_phase(cfg, model):
    """internvl2's stub frontend: a direct prefill of a 1536-token prompt
    whose first frontend_positions positions are precomputed embeddings
    (1, 256, 6144), drawn from generator seed 7; finite logits that differ
    from the same prompt's without them, one flash call a layer."""
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (1, LM_PROMPTS[1]))).to(CARD)
    fe = torch.randn((1, cfg.frontend_positions, cfg.d_model),
                     generator=torch.Generator(device=CARD).manual_seed(7),
                     device=CARD).to(torch.bfloat16)
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(model, tokens, capacity=LM_CAPACITY,
                            frontend_embeds=fe)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {k: c.value for k, c in ops.COUNTERS.items()}
    plain, _ = prefill(model, tokens, capacity=LM_CAPACITY)
    moved = (logits.float() - plain.float()).abs().max().item()
    expect(bool(torch.isfinite(logits).all()) and moved > 0,
           f"finite logits that the frontend moves (by {moved})")
    expect(launches["flash_attention"] == cfg.n_layers,
           f"one flash call a layer: {launches}")
    print(f"lm {cfg.arch} frontend: {cfg.frontend_positions} embeddings of "
          f"{cfg.d_model} in a {LM_PROMPTS[1]}-token prefill, {sec:.4f} s; "
          f"logits moved by up to {moved:.3g}", flush=True)
    return dict(seconds=sec, launches=launches, max_logit_move=moved,
                frontend_shape=list(fe.shape))


def family_phase(arch):
    """One model of the other families: its kernels at its shapes, its main
    path, a profiled window, gemma2 past its window, internvl2's frontend,
    and the head check; the model is freed before returning."""
    cfg = get_config(arch)
    model = build_model(cfg)
    with part(f"{arch} kernels"):
        kernels = family_kernel_phase(cfg)
    with part(f"{arch} main path and profile"):
        serve = lm_main_path(cfg, model, FAMILY_REQUESTS, FAMILY_MAX_NEW)
        serve["profile"] = lm_profile(cfg, model)
    graph_parts(cfg, model, serve)
    if cfg.arch == WINDOW_ARCH:
        serve["window"] = window_phase(cfg, model)
    if cfg.arch == VLM_ARCH:
        serve["frontend"] = frontend_phase(cfg, model)
    with part(f"{arch} head check"):
        head = lm_head_check(cfg, model) if arch in HEAD_ARCHS else None
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return kernels, serve, head


@contextlib.contextmanager
def plain_on_card():
    """The model's kernel calls through their plain versions, whatever the
    device (the kernels' counters stay where they are)."""
    names = ("flash_attention_bshd", "grouped_matmul", "ssd_scan")
    saved = {n: getattr(ops, n) for n in names}
    ops.flash_attention_bshd = lambda q, k, v, **kw: ref.attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        **kw).transpose(1, 2)
    ops.grouped_matmul = ref.grouped_matmul_ref
    ops.ssd_scan = ref.ssd_scan_ref
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def cut_phase(arch):
    """A configuration too large for the card, at full width with its depth
    cut to CUT_LAYERS: the model in float32 through the kernels against
    the plain versions on the card (one LM_CHECK_TOKENS prompt: the last
    logits and the k/v cache), then cast to bf16 and held to the same
    plain float32 run by relative L2, then its kernels at its shapes and
    one CUT_PROMPT-token request of CUT_DECODE decode steps through
    ServeEngine."""
    cfg = get_config(arch).scaled(n_layers=CUT_LAYERS)
    model = build_model(cfg, torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, LM_CHECK_TOKENS))).to(CARD)

    def run():
        logits, cache = prefill(model, tokens)
        return {"logits": logits[:, :cfg.vocab].float(),
                "k": cache["k"].float(), "v": cache["v"].float()}

    t0 = time.perf_counter()
    with plain_on_card():
        want = run()
    plain_s = time.perf_counter() - t0
    got = run()
    model.to(torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    got16 = run()
    limits = GROUP_BF16_REL[cfg.arch]
    out = {}
    for name in ("logits", "k", "v"):
        w, g32 = want[name], got[name]
        scale = w.abs().max().item()
        e32 = (g32 - w).abs().max().item()
        ex32 = (bf16_excess(g32, w, GROUP_F32_TOL * scale) if name != "logits"
                else e32 / (GROUP_F32_TOL * scale))
        rel16 = rel_l2(got16[name], w)
        expect(math.isfinite(e32) and ex32 <= 1.0,
               f"{arch} {CUT_LAYERS} layers, kernels vs plain float32 "
               f"{name}: max err {e32} (max {scale}), worst element at "
               f"{ex32:.3f} of its bound")
        expect(math.isfinite(rel16) and rel16 <= limits[name],
               f"{arch} {CUT_LAYERS} layers, kernels bf16 vs plain float32 "
               f"{name}: relative L2 {rel16} <= {limits[name]}")
        out[name] = dict(max_abs=scale, f32_max_abs_err=e32,
                         f32_share_of_bound=ex32, bf16_rel_l2=rel16)
    print(f"lm {arch} cut to {CUT_LAYERS} layers, kernels vs plain versions "
          f"on the card: {out} (plain float32 {plain_s:.2f} s)", flush=True)
    check = dict(out, plain_seconds=plain_s, tolerance=(
        f"f32: logits {GROUP_F32_TOL} x max |plain|; k/v 2^-7 |plain| + "
        f"{GROUP_F32_TOL} x max |plain| elementwise; bf16: relative L2 <= "
        f"{limits}"))
    kernels = family_kernel_phase(cfg)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab,
                                               CUT_PROMPT).tolist()
    serve = lm_main_path(cfg, model, max_new=CUT_DECODE + 1, prompts=[prompt],
                         slots=1)
    expect(serve["decode"]["steps"] == CUT_DECODE,
           f"{CUT_DECODE} decode steps: {serve['decode']}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return kernels, serve, check


def flash_train_check(cfg):
    """Flash's forward (with its log-sum-exp) and backward at the arch's
    training shape (TRAIN_BATCH x TRAIN_SEQ, its heads, softcap and scale)
    against autograd through the plain version, the backward timed beside
    the SDPA backward where SDPA computes the same function."""
    g = torch.Generator(device=CARD).manual_seed(0)
    B, S, H, KV, hd = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim)
    q, do = (torch.randn((B, H, S, hd), generator=g, device=CARD)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, KV, S, hd), generator=g, device=CARD)
            .to(torch.bfloat16) for _ in range(2))
    kw = flash_kw(cfg)
    worst, err = flash_grads_excess(q, k, v, do, kw)
    expect(worst <= 1.0, f"flash backward {cfg.arch} {[B, H, KV, S, hd]} "
           f"{kw}: worst element at {worst:.3f} of its bound")
    o, lse = flash_mod.flash_attention_with_lse(q, k, v, **kw)
    kernel = lambda: flash_mod.flash_attention_backward(q, k, v, o, do, lse,
                                                        **kw)
    lib = None
    if not cfg.attn_softcap:
        lib = grad_ms(lambda *t: F.scaled_dot_product_attention(
            *t, is_causal=True, enable_gqa=True, scale=cfg.attn_scale),
            (q, k, v), do, 10)
    r = dict(max_abs_err=err, ms=cuda_ms(kernel, 10),
             plain_ms=grad_ms(ref.attention_ref, (q, k, v), do, 2, **kw),
             library_ms=lib, shape=[B, H, KV, S, hd], dtype="bfloat16",
             kw={k_: v_ for k_, v_ in kw.items() if v_},
             bf16_worst_share_of_bound=worst,
             bound=flash_bwd_bound(B, H, KV, S, hd, torch.bfloat16))
    print(f"kernel flash_attention_bwd {cfg.arch} {r['shape']} bfloat16 "
          f"{r['kw']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA "
          f"backward {lib}, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), "
          f"worst share of the bound {worst:.3f}", flush=True)
    return r


def family_train_phase(arch):
    """Training of one of FAMILY_TRAIN_ARCHS at full width and depth: its
    kernels' gradients at the training shape, the gradient head check, the
    main path; the model is freed before returning."""
    cfg = get_config(arch)
    if cfg.ssm is not None:
        kernels = ssd_train_kernel_phase(cfg)
        r = kernels["ssd_scan_bwd"]
        print(f"kernel ssd_scan_bwd {cfg.arch} {r['shape']} float32: "
              f"{r['ms']:.4f} ms, autograd through the plain version "
              f"{r['plain_ms']:.4f} ms, device time alone "
              f"{r['device_ms']:.4f} ms; bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}; split TF32 {r['bound_split_tf32'][0]:.4f}"
              f" ms), max err {r['max_abs_err']:.3g}", flush=True)
    else:
        kernels = {"flash_attention_bwd": flash_train_check(cfg)}
    model = build_model(cfg)
    head = grad_head_check(cfg, model, FAMILY_GRAD_GROUPS[cfg.arch],
                           FAMILY_GRAD_F32_REL)
    main = train_main_path(cfg, model, FAMILY_TRAIN_REMAT)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return kernels, main, head


def train_lm_phase():
    """``repro_torch.examples.train_lm`` on the card as a user runs it, with
    its checkpoints under build/: to TRAIN_LM_STEPS[0] steps, then again
    from the same directory to TRAIN_LM_STEPS[1], which resumes at the
    saved step; every logged loss finite.  Each step is 2 microbatches
    under remat "dots", so each layer's flash forward runs twice a
    microbatch (models/lm.py REMAT_SAVED) and its backward once, and the
    accumulation's kernel once a microbatch."""
    ckpt = ROOT / "build" / "train_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    runs, outs = [], []
    reset_counts()
    t0 = time.perf_counter()
    for steps in TRAIN_LM_STEPS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runs.append(train_lm.main(["--steps", str(steps),
                                       "--ckpt-dir", str(ckpt)]))
        outs.append(buf.getvalue())
        print("train_lm: " + " | ".join(outs[-1].strip().splitlines()),
              flush=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: c.value for k, c in ops.COUNTERS.items()}
    cfg = train_lm.config_100m()
    n_steps = TRAIN_LM_STEPS[1]
    want = {"flash_attention": 4 * cfg.n_layers * n_steps,
            "flash_attention_bwd": 2 * cfg.n_layers * n_steps,
            "adamw": 3 * n_steps, "grad_accum": 2 * n_steps}
    expect(runs[0]["start"] == 0 and runs[1]["start"] == TRAIN_LM_STEPS[0]
           and f"resumed from step {TRAIN_LM_STEPS[0]}" in outs[1],
           f"the second run resumed at the saved step: {runs}")
    expect(all(math.isfinite(r[k]) for r in runs
               for k in ("first_loss", "final_loss")),
           f"finite losses: {runs}")
    for k, n in want.items():
        expect(launches[k] == n, f"train_lm {k}: {launches[k]} launches == "
               f"{n}")
    return dict(runs=runs, seconds=seconds, launches=launches,
                want_launches=want, steps=list(TRAIN_LM_STEPS))


# ---------------------------------------------------------------------------
# whisper-large-v3: the encoder-decoder served and trained at full width and
# depth
# ---------------------------------------------------------------------------

def whisper_kernel_phase(cfg):
    """Flash at whisper's shapes, float32 and bf16, against its plain
    version on the card, each timed beside SDPA with its bound: the forward
    as serving calls it (the encoder's WHISPER_BATCH x 1500 frames without
    a mask; the cross-attention's 4- and 224-token queries against 1500
    keys), the backward at the training shapes (the encoder's TRAIN_BATCH
    x 1500 frames, the cross-attention's 448 queries against them, the
    decoder's causal 448 tokens) against autograd through the plain
    version, SDPA's backward through autograd too."""
    dev = torch.device(CARD)
    g = torch.Generator(device=dev).manual_seed(0)
    H, KV, hd, n = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.enc_frames
    results = {}

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for what, B, Sq, Sk in (
                ("encoder", WHISPER_BATCH, n, n),
                ("cross", WHISPER_BATCH, WHISPER_PROMPT, n),
                ("cross", WHISPER_BATCH, WHISPER_LONG_PROMPT, n)):
            q = randn(B, H, Sq, hd, dtype=dtype)
            k, v = randn(B, KV, Sk, hd, dtype=dtype), randn(B, KV, Sk, hd,
                                                            dtype=dtype)
            got = ops.flash_attention(q, k, v, causal=False)
            want = ref.attention_ref(q, k, v, causal=False)
            err = (got.float() - want.float()).abs().max().item()
            worst = (bf16_excess(got, want, FLASH_TOL)
                     if dtype == torch.bfloat16 else err / FLASH_TOL)
            shape = [B, H, KV, Sq, Sk, hd]
            expect(worst <= 1.0, f"flash {WHISPER_ARCH} {what} {shape} {dt}:"
                   f" worst element at {worst:.3f} of its bound")
            results[f"flash_attention {WHISPER_ARCH} {what} Sq{Sq} {dt}"] = \
                dict(max_abs_err=err, worst_share_of_bound=worst,
                     ms=cuda_ms(lambda: ops.flash_attention(
                         q, k, v, causal=False), 10),
                     plain_ms=cuda_ms(lambda: ref.attention_ref(
                         q, k, v, causal=False), 2),
                     library_ms=cuda_ms(
                         lambda: F.scaled_dot_product_attention(q, k, v),
                         10),
                     shape=shape, dtype=dt, kw={"causal": False},
                     bound=flash_bound(B, H, KV, Sq, Sk, hd, dtype,
                                       causal=False))
        for what, Sq, Sk, causal in (
                ("encoder", n, n, False),
                ("cross", WHISPER_CAPACITY, n, False),
                ("decoder", WHISPER_CAPACITY, WHISPER_CAPACITY, True)):
            B = TRAIN_BATCH
            q, do = randn(B, H, Sq, hd, dtype=dtype), randn(B, H, Sq, hd,
                                                            dtype=dtype)
            k, v = randn(B, KV, Sk, hd, dtype=dtype), randn(B, KV, Sk, hd,
                                                            dtype=dtype)
            kw = dict(causal=causal)
            worst, err = flash_grads_excess(q, k, v, do, kw)
            shape = [B, H, KV, Sq, Sk, hd]
            expect(worst <= 1.0, f"flash backward {WHISPER_ARCH} {what} "
                   f"{shape} {dt}: worst element at {worst:.3f} of its "
                   "bound")
            o, lse = flash_mod.flash_attention_with_lse(q, k, v, **kw)
            results[f"flash_attention_bwd {WHISPER_ARCH} {what} {dt}"] = \
                dict(max_abs_err=err, worst_share_of_bound=worst,
                     ms=cuda_ms(lambda: flash_mod.flash_attention_backward(
                         q, k, v, o, do, lse, **kw), 10),
                     plain_ms=grad_ms(ref.attention_ref, (q, k, v), do, 2,
                                      **kw),
                     library_ms=grad_ms(
                         lambda *t: F.scaled_dot_product_attention(
                             *t, is_causal=causal), (q, k, v), do, 10),
                     shape=shape, dtype=dt, kw=kw,
                     bound=flash_bwd_bound(B, H, KV, Sq, hd, dtype, causal,
                                           Sk=Sk))
    torch.cuda.synchronize()
    for name, r in results.items():
        print(f"kernel {name} {r['shape']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), max err "
              f"{r['max_abs_err']:.3g}, worst share of its tolerance "
              f"{r['worst_share_of_bound']:.3f}", flush=True)
    return results


def whisper_serve(cfg, model):
    """Whisper served as the JAX package's own tests drive it, through
    ``prefill`` and the decode step (its engine takes no frames), the step
    replayed by a ``DecodeGraph`` captured over the cache the prefill
    fills: a batch of WHISPER_BATCH requests, each with its own frames
    (generator seed 7) and a WHISPER_PROMPT-token prompt, prefilled at
    capacity WHISPER_CAPACITY and decoded WHISPER_DECODE greedy steps, each
    step's tokens read by the host as the engine reads them
    (``graphed_steps``); then one WHISPER_LONG_PROMPT-token request decoded
    WHISPER_LONG_DECODE steps, each shape's prefill warmed up and its graph
    captured first.  Each run's launch counts from 0 just before to just
    after: one flash call per encoder layer and two per decoder layer
    (attention, cross-attention) a prefill, none a decode step; the decode
    kernels' launches a step (``decode_launches``), none a prefill."""
    gen = torch.Generator(device=CARD).manual_seed(7)
    rng = np.random.default_rng(0)
    per_prefill = cfg.n_enc_layers + 2 * cfg.n_layers
    shapes = (("batch", WHISPER_BATCH, WHISPER_PROMPT, WHISPER_DECODE),
              ("long", 1, WHISPER_LONG_PROMPT, WHISPER_LONG_DECODE))
    for _, B, S, _ in shapes:      # warm-up at each shape, before the counts
        prefill(model, torch.zeros((B, S), dtype=torch.long, device=CARD),
                capacity=WHISPER_CAPACITY, frames=torch.zeros(
                    (B, cfg.enc_frames, cfg.d_model), dtype=torch.bfloat16,
                    device=CARD))
    runs = {}
    for name, B, S, steps in shapes:
        frames = torch.randn((B, cfg.enc_frames, cfg.d_model), generator=gen,
                             device=CARD).to(torch.bfloat16)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(CARD)
        cache = init_cache(cfg, B, WHISPER_CAPACITY, device=CARD)
        graph = DecodeGraph(model, cache, B)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        logits, _ = prefill(model, tokens, capacity=WHISPER_CAPACITY,
                            frames=frames, cache=cache)
        tok = torch.argmax(logits, -1)
        out = [tok.tolist()]
        prefill_s = time.perf_counter() - t0
        at_prefill = ops.COUNTERS["flash_attention"].value
        finite = [bool(torch.isfinite(logits).all())]
        t0 = time.perf_counter()
        out += graphed_steps(graph, S, steps, tok)
        decode_s = time.perf_counter() - t0
        finite.append(bool(torch.isfinite(graph.logits).all()))
        peak = torch.cuda.max_memory_allocated()
        launches = {k: c.value for k, c in ops.COUNTERS.items()}
        expect(all(finite), f"whisper {name}: finite logits")
        expect(all(0 <= t < cfg.vocab for row in out for t in row),
               f"whisper {name}: tokens in the vocab")
        want = {"flash_attention": per_prefill,
                **decode_launches(cfg, steps)}
        expect(at_prefill == per_prefill and all(
            n == want.get(k, 0) for k, n in launches.items()),
               f"whisper {name}: {per_prefill} flash calls a prefill, none a "
               f"decode step, the decode kernels' {want} in {steps} steps, "
               f"no other kernel: {launches}")
        tok_s = B * steps / decode_s
        print(f"lm prefill {B} x {S} tokens over {B} x {cfg.enc_frames} "
              f"frames: {prefill_s:.4f} s", flush=True)
        print(f"lm decode: {B * steps} tokens in {steps} steps, "
              f"{decode_s:.3f} s, {tok_s:.1f} tokens/s; peak memory "
              f"{peak / 2 ** 30:.2f} GiB", flush=True)
        runs[name] = dict(batch=B, prompt=S, decode_steps=steps,
                          prefill_seconds=prefill_s, decode_seconds=decode_s,
                          decode_tokens_per_s=tok_s, peak_memory_bytes=peak,
                          launches=launches, first_tokens=[
                              [row[j] for row in out[:8]] for j in range(B)])
    return dict(runs=runs,
                prefill_seconds=[(r["batch"] * r["prompt"],
                                  r["prefill_seconds"])
                                 for r in runs.values()],
                decode_tokens_per_s=runs["batch"]["decode_tokens_per_s"],
                peak_memory_bytes=max(r["peak_memory_bytes"]
                                      for r in runs.values()),
                launches={k: sum(r["launches"][k] for r in runs.values())
                          for k in ops.COUNTERS})


def whisper_profile(cfg, model):
    """``torch.profiler`` over one prefill of WHISPER_BATCH requests with
    their frames (generator seed 9) and PROFILE_DECODE_STEPS graphed decode
    steps after it (``graphed_steps``)."""
    frames = torch.randn((WHISPER_BATCH, cfg.enc_frames, cfg.d_model),
                         generator=torch.Generator(device=CARD).manual_seed(9),
                         device=CARD).to(torch.bfloat16)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (WHISPER_BATCH, WHISPER_PROMPT))).to(CARD)
    prefill(model, tokens, capacity=WHISPER_CAPACITY, frames=frames)  # warm
    graph = DecodeGraph(model, init_cache(cfg, WHISPER_BATCH,
                                          WHISPER_CAPACITY, device=CARD),
                        WHISPER_BATCH)

    def run_prefill():
        prefill(model, tokens, capacity=WHISPER_CAPACITY, frames=frames,
                cache=graph.cache)

    def decode():
        graphed_steps(graph, WHISPER_PROMPT, PROFILE_DECODE_STEPS,
                      tokens[:, 0])

    out = {"prefill": profile_steps("prefill", run_prefill)}
    out["decode"] = profile_steps("decode", decode)
    return out


def whisper_phase():
    """whisper-large-v3: flash at its shapes, the model served, a profiled
    window, the head check, the gradient head check, then the training
    main path; the model is freed before returning."""
    cfg = get_config(WHISPER_ARCH)
    with part(f"{cfg.arch} kernels"):
        kernels = whisper_kernel_phase(cfg)
    model = build_model(cfg)
    with part(f"{cfg.arch} main path and profile"):
        serve = whisper_serve(cfg, model)
        serve["profile"] = whisper_profile(cfg, model)
    graph_parts(cfg, model, serve)
    with part(f"{cfg.arch} head checks"):
        head = lm_head_check(cfg, model)
        # the parameters as built
        grads = grad_head_check(cfg, model, WHISPER_GRAD_GROUPS,
                                WHISPER_GRAD_F32_REL)
    with part(f"train {cfg.arch}"):
        train = train_main_path(cfg, model, WHISPER_TRAIN_REMAT)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return kernels, serve, head, grads, train


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the launch layer: the single-H100 dry-run, held to measured steps
# ---------------------------------------------------------------------------

def checked_cell(cfg, measured, kind: str):
    """The dry-run's record of the step ``measured`` timed on the card:
    the cell built at its shape (remat none, one microbatch, one loss
    chunk, as the card's steps run)."""
    if kind == "train":
        shape = ShapeSpec(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", "train",
                          TRAIN_SEQ, TRAIN_BATCH)
        cell = CellConfig(microbatches=1, remat=FAMILY_TRAIN_REMAT,
                          loss_chunks=1)
    else:
        shape = ShapeSpec(f"prefill_{measured['tokens']}", "prefill",
                          measured["tokens"], 1)
        cell = CellConfig(microbatches=1, remat=None, loss_chunks=1)
    return dryrun.trace_cell(cfg, shape, cell)


def launch_phase(measured):
    """The dry-run on this host: one cell of each shape (LAUNCH_CELLS),
    each traced on meta with no plain version called; then each measured
    step of ``measured`` ({name: (arch, kind, its record)}) against the
    dry-run's cell at its shape: (a) predicted kernel calls equal to the
    launches counted, exactly; (b) predicted peak memory within
    PEAK_MEMORY_TOL of ``max_memory_allocated``; (c) the model-FLOPs
    utilisation of the measured step beside the roofline's step time.
    Then ``repro_torch.examples.serve_llm`` on the card."""
    total = torch.cuda.get_device_properties(0).total_memory
    expect(total == HBM_PER_CARD,
           f"the card's total memory {total} == HBM_PER_CARD {HBM_PER_CARD}")
    out = {"total_memory_bytes": total, "cells": {}, "checked": {}}
    with PlainCalls() as plain:
        for arch, shape in LAUNCH_CELLS:
            rec = dryrun.run_cell(arch, shape)
            r, m = rec["roofline"], rec["memory"]
            print(f"dryrun {arch} {shape}: fits {m['fits_hbm']}, peak "
                  f"{m['peak_per_card_bytes'] / 2 ** 30:.2f} GiB, bottleneck "
                  f"{r['bottleneck']}, roofline fraction "
                  f"{r['roofline_fraction']:.4f}, trace {rec['trace_s']:.1f} "
                  f"s, kernel calls {rec['op_analysis']['kernel_calls']}",
                  flush=True)
            out["cells"][f"{arch} {shape}"] = rec
        for name, (arch, kind, got) in measured.items():
            cfg = get_config(arch)
            rec = checked_cell(cfg, got, kind)
            calls = rec["op_analysis"]["kernel_calls"]
            per_step = (got["launches_per_step"] if kind == "train"
                        else got["launches"])
            launched = {k: int(n) for k, n in per_step.items() if n}
            expect(calls == launched, f"{name}: predicted kernel calls "
                   f"{calls} == launches {launched}")
            pred = rec["memory"]["peak_per_card_bytes"]
            ratio = pred / got["peak_memory_bytes"]
            expect(abs(ratio - 1.0) <= PEAK_MEMORY_TOL,
                   f"{name}: predicted peak / measured {ratio:.4f} within "
                   f"{PEAK_MEMORY_TOL}")
            seconds = (float(np.median([s["seconds"]
                                        for s in got["steps"][1:]]))
                       if kind == "train" else got["seconds"])
            rf = rec["roofline"]
            util = mfu(rf["model_flops"], seconds)
            print(f"check {name}: kernel calls {calls} == launches; peak "
                  f"predicted {pred / 2 ** 30:.3f} GiB, measured "
                  f"{got['peak_memory_bytes'] / 2 ** 30:.3f} GiB (ratio "
                  f"{ratio:.4f}; given {rec['memory']['argument_bytes'] / 2 ** 30:.3f}"
                  f" GiB, allocated before "
                  f"{got['allocated_before_bytes'] / 2 ** 30:.3f} GiB); "
                  f"MFU {util:.4f} at {seconds:.4f} s measured "
                  f"(model FLOPs {rf['model_flops']:.4g}, peak "
                  f"{PEAK_FLOPS:.3g}/s spec sheet), roofline step "
                  f"{rf['step_time_s']:.4f} s ({rf['bottleneck']}, "
                  f"{rf['roofline_fraction']:.4f})", flush=True)
            out["checked"][name] = dict(
                predicted_calls=calls, launches=launched,
                predicted_peak_bytes=pred,
                measured_peak_bytes=got["peak_memory_bytes"],
                peak_ratio=ratio,
                predicted_argument_bytes=rec["memory"]["argument_bytes"],
                allocated_before_bytes=got["allocated_before_bytes"],
                measured_s=seconds, mfu=util, roofline=rf,
                op_analysis=rec["op_analysis"], trace_s=rec["trace_s"])
    expect(not any(plain.calls.values()),
           f"no plain version in the dry-run: {plain.calls}")
    torch.cuda.synchronize()
    reset_counts()
    with PlainCalls() as plain:
        engine = serve_llm.main([])
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in ops.COUNTERS.items()}
    expect(launches["flash_attention"] > 0 and launches["ssd_scan"] > 0,
           f"serve_llm ran flash and the SSD scan on the card: {launches}")
    expect(not any(plain.calls.values()),
           f"no plain version in serve_llm: {plain.calls}")
    out["serve_llm"] = dict(launches=launches, requests=len(engine.finished),
                            tokens=sum(len(r.out) for r in engine.finished))
    print(f"serve_llm: {out['serve_llm']['requests']} requests, "
          f"{out['serve_llm']['tokens']} tokens; launches {launches}",
          flush=True)
    return out


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value, any other tensor itself."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def mesh_world1(cfg):
    """``cfg`` on the card twice, each time a fresh model from seed 0:
    unsharded, then through ``dryrun.build_cell`` on a (1, 1) mesh of the
    world-1 NCCL group: a prefill and one training step each (launch
    counters from 0 before each).  The unsharded step's updated parameters
    and first moments are kept on the host; the sharded step's are held to
    them leaf by leaf (``world1_leaves``)."""
    shape_p = ShapeSpec(f"prefill_{MESH_PREFILL}", "prefill", MESH_PREFILL,
                        1)
    shape_t = ShapeSpec(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", "train",
                        TRAIN_SEQ, TRAIN_BATCH)
    cell_p = cell_runtime(cfg, shape_p)
    cell_t = CellConfig(microbatches=1, remat=TRAIN_REMAT, loss_chunks=1,
                        fsdp=True)
    rt = RuntimeConfig(microbatches=1, remat=TRAIN_REMAT, loss_chunks=1)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, MESH_PREFILL))).to(CARD)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, seed=0)
    batch = {k: v.to(CARD) for k, v in batch_at(dc, 0).items()}
    runs, kept = {}, None
    for sharded in (False, True):
        model = build_model(cfg)
        mesh = make_mesh_1x1() if sharded else None
        with PlainCalls() as plain, torch.no_grad():
            if sharded:
                fn, args = dryrun.build_cell(cfg, shape_p, cell_p, mesh,
                                             model=model,
                                             data={"tokens": tokens},
                                             capacity=MESH_CAPACITY)
            else:
                fn, args = (lambda m, t, kw: prefill(
                    m, t, capacity=MESH_CAPACITY, **kw),
                    (model, tokens, {}))
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            sec_p = time.perf_counter() - t0
            launch_p = {k: c.value for k, c in ops.COUNTERS.items()}
        logits = full(logits).float()
        del cache
        opt = AdamW(AdamWConfig())
        with PlainCalls() as plain_t:
            if sharded:
                step, (state, b) = dryrun.build_cell(cfg, shape_t, cell_t,
                                                     mesh, model=model,
                                                     data=dict(batch))
            else:
                step, state, b = (make_train_step(cfg, opt, rt),
                                  init_state(model, opt), batch)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            m = {k: float(v) for k, v in metrics.items()}
            torch.cuda.synchronize()
            sec_t = time.perf_counter() - t0
            launch_t = {k: c.value for k, c in ops.COUNTERS.items()}
        expect(not any(plain.calls.values())
               and not any(plain_t.calls.values()),
               f"no plain version in the mesh phase: {plain.calls} "
               f"{plain_t.calls}")
        name = "sharded" if sharded else "unsharded"
        runs[name] = dict(logits=logits.cpu(), prefill_s=sec_p,
                          prefill_launches=launch_p, train=m,
                          train_s=sec_t, train_launches=launch_t,
                          params_dtensor=sharded and all(
                              type(p).__name__ == "DTensor"
                              for p in model.parameters()))
        print(f"mesh {cfg.arch} {name}: prefill {MESH_PREFILL} tokens "
              f"{sec_p:.3f} s launches {launch_p}; train step "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} loss {m['loss']:.5f} grad_norm "
              f"{m['grad_norm']:.5f} {sec_t:.3f} s launches {launch_t}",
              flush=True)
        with torch.no_grad():
            if kept is None:
                runs["unsharded"]["leaves"] = grad_shares(
                    state.opt.m, m["grad_norm"])
                kept = {"param": {n: full(p).cpu() for n, p in
                                  model.named_parameters()},
                        "m": {n: full(t).cpu()
                              for n, t in state.opt.m.items()}}
            else:
                runs["sharded"]["leaves"] = world1_leaves(
                    kept, dict(model.named_parameters()), state.opt.m,
                    float(opt.config.lr_at(0)))
        del model, state, b, logits
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def grad_shares(moments, grad_norm: float, top: int = 4):
    """Each leaf's gradient norm from its first moment after one step (the
    clipped gradient times 1 - beta1: the same factor for every leaf, so
    the leaves' norms stand in the gradient's proportions), largest first:
    (name, norm, share of the squared norm) of the ``top`` largest."""
    sq = {n: float(full(t).double().square().sum())
          for n, t in moments.items()}
    total = sum(sq.values())
    rows = sorted(sq.items(), key=lambda kv: -kv[1])[:top]
    return [(n, grad_norm * math.sqrt(v / total), v / total)
            for n, v in rows]


def world1_leaves(kept, params, moments, lr: float):
    """The sharded step's updated parameters and first moments against the
    unsharded step's (``kept``, on the host), leaf by leaf on the card:
    the worst leaf's share of its bound (MESH_LOSS_RTOL; fails past 1) and
    how many leaves are bit-identical."""
    worst, same, n = (0.0, ""), 0, 0
    for key, got_tree in (("param", params), ("m", moments)):
        for name, want_h in kept[key].items():
            want = want_h.to(CARD)
            got = full(got_tree[name].detach())
            expect(got.shape == want.shape and got.dtype == want.dtype,
                   f"sharded {key} {name}: {tuple(got.shape)} {got.dtype}")
            err = (got.float() - want.float()).abs()
            if key == "param":
                bound = (BF16_STEP * want.float().abs()
                         + MESH_LOSS_RTOL * lr)
            else:
                bound = MESH_LOSS_RTOL * want.abs().max().clamp_min(
                    torch.finfo(torch.float32).tiny)
            share = float((err / bound).max())
            worst = max(worst, (share, f"{key} {name}"))
            same += bool(torch.equal(got, want))
            n += 1
    expect(worst[0] <= 1.0, f"sharded step leaf by leaf: worst {worst[1]} "
           f"at {worst[0]:.3g} of its bound")
    return dict(leaves=n, bit_identical=same, worst_share=worst[0],
                worst_leaf=worst[1])


def flash_offset_check():
    """A sequence shard's attention (``ops.flash_attention_offset_bshd``)
    at FLASH_OFFSET_ARCH's shapes, without and with a window: its output
    and gradients against autograd through the plain version with the
    query offset in float32, its forward and backward launches counted,
    timed (forward, and forward with backward) beside the plain version
    and SDPA with the same boolean mask."""
    cfg = get_config(FLASH_OFFSET_ARCH)
    B, Sq, off = FLASH_OFFSET_B, FLASH_OFFSET_SQ, FLASH_OFFSET_AT
    H, KV, hd, Sk = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, off + Sq
    bf16 = torch.bfloat16
    g = torch.Generator(device=CARD).manual_seed(0)
    q, do = (torch.randn((B, Sq, H, hd), generator=g, device=CARD).to(bf16)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, KV, hd), generator=g, device=CARD).to(bf16)
            for _ in range(2))

    def plain(q, k, v, q_offset, window):
        o = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, window=window,
                              q_offset=q_offset, logit_cap=cfg.attn_softcap,
                              scale=cfg.attn_scale)
        return o.transpose(1, 2)

    out = {}
    for window in FLASH_OFFSET_WINDOWS:
        kw = dict(q_offset=off, window=window)
        fn = lambda *t, **kw_: ops.flash_attention_offset_bshd(
            *t, logit_cap=cfg.attn_softcap, scale=cfg.attn_scale, **kw_)
        torch.cuda.synchronize()
        reset_counts()
        o, got = grads_of(fn, (q, k, v), do, **kw)
        torch.cuda.synchronize()
        launches = {n: ops.COUNTERS[n].value
                    for n in ("flash_attention", "flash_attention_bwd")}
        expect(launches == {"flash_attention": 2, "flash_attention_bwd": 2},
               f"flash offset {window}: two forward and two backward "
               f"launches: {launches}")
        o_want, want = grads_of(plain, (q.float(), k.float(), v.float()),
                                do.float(), **kw)
        worst, err = 0.0, 0.0
        for x, w in zip((o, *got), (o_want, *want)):
            e = (x.detach().float() - w.detach()).abs()
            m = w.abs().max()
            bound = (BWD_TOL + 3e-3) * m + 3 * BF16_STEP * w.abs()
            worst = max(worst, float((e / bound).max()))
            err = max(err, float(e.max()))
        expect(worst <= 1.0, f"flash offset {list(q.shape)} at {off} window "
               f"{window}: worst element at {worst:.3f} of its bound")
        qp = torch.arange(Sq, device=CARD)[:, None] + off
        kp = torch.arange(Sk, device=CARD)[None, :]
        mask = kp <= qp
        if window is not None:
            mask &= kp > qp - window
        sdpa = lambda *t: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in t), attn_mask=mask,
            enable_gqa=True, scale=cfg.attn_scale).transpose(1, 2)
        fwd = [cuda_ms(lambda: fn(q, k, v, **kw), 10) for _ in range(2)]
        both = [grad_ms(fn, (q, k, v), do, 10, **kw) for _ in range(2)]
        fb = flash_bound(B, H, KV, Sq, Sk, hd, bf16, window=window,
                         q_offset=off)
        bb = flash_bwd_bound(B, H, KV, Sq, hd, bf16, Sk=Sk, window=window,
                             q_offset=off)
        r = dict(shape=[B, Sq, H, KV, hd], q_offset=off, window=window,
                 max_abs_err=err, worst_share_of_bound=worst,
                 launches=launches, ms=sum(fwd) / 2,
                 plain_ms=cuda_ms(lambda: plain(q, k, v, **kw), 3),
                 library_ms=cuda_ms(lambda: sdpa(q, k, v), 10),
                 bound=fb, fwd_bwd_ms=sum(both) / 2,
                 fwd_bwd_plain_ms=grad_ms(plain, (q, k, v), do, 3, **kw),
                 fwd_bwd_library_ms=grad_ms(sdpa, (q, k, v), do, 10),
                 fwd_bwd_bound_ms=fb[0] + bb[0],
                 tolerance=f"max |err| <= ({BWD_TOL} + 3e-3) x max |plain|"
                           " + 3 bf16 steps of |plain|, elementwise")
        out["none" if window is None else str(window)] = r
        print(f"kernel flash_offset {FLASH_OFFSET_ARCH} {r['shape']} at "
              f"{off} window {window} bfloat16: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, SDPA with the mask "
              f"{r['library_ms']:.4f} ms, bound {fb[0]:.4f} ms ({fb[1]}); "
              f"forward and backward {r['fwd_bwd_ms']:.4f} ms, plain "
              f"{r['fwd_bwd_plain_ms']:.4f} ms, SDPA "
              f"{r['fwd_bwd_library_ms']:.4f} ms, bound "
              f"{r['fwd_bwd_bound_ms']:.4f} ms; launches {launches}; max err"
              f" {err:.3g}, worst share of the bound {worst:.3f}",
              flush=True)
    return out


def make_mesh_1x1():
    """The (data, model) = (1, 1) mesh of the world-1 NCCL group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))


#: the quad dry-run's processes while they run (stopped at exit)
QUAD_PROCS: list = []


def quad_paths():
    """Where each of QUAD_CELLS' processes writes its record."""
    return [ROOT / "build" / f"chip_smoke_quad_{i}.json"
            for i in range(len(QUAD_CELLS))]


def quad_start() -> None:
    """The quad_2x2 dry-run of QUAD_CELLS: each cell traced in a process
    of its own (meta tensors, a fake process group of 4: no card), all
    started together beside the kernels' build, before anything is
    measured; ``quad_join`` waits for them before the first measurement."""
    paths = quad_paths()
    paths[0].parent.mkdir(exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    for path, cell in zip(paths, QUAD_CELLS):
        if path.exists():
            path.unlink()
        QUAD_PROCS.append(subprocess.Popen(
            [sys.executable, "-c", QUAD_SCRIPT, str(path), json.dumps(cell)],
            cwd=str(ROOT), env=env))


def quad_join():
    """The quad dry-run's records, in QUAD_CELLS' order, once every
    process has ended."""
    rcs = [proc.wait(timeout=600) for proc in QUAD_PROCS]
    expect(not any(rcs), f"the quad dry-run processes exited {rcs}")
    return [json.loads(path.read_text()) for path in quad_paths()]


def stop_quad() -> None:
    for proc in QUAD_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def mesh_phase(quad_recs):
    """The multi-card layer on this card: a sequence shard's attention
    (``flash_offset_check``), MESH_ARCH's world-1 check (``mesh_world1``),
    the sharded run held to the unsharded one, then the quad_2x2 dry-run's
    records (``quad_join``)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    offset = flash_offset_check()
    group_file = ROOT / "build" / "chip_smoke_pg"
    if group_file.exists():
        group_file.unlink()
    try:
        dist.init_process_group("nccl", init_method=f"file://{group_file}",
                                rank=0, world_size=1)
        try:
            runs = mesh_world1(get_config(MESH_ARCH))
        finally:
            dist.destroy_process_group()
    finally:
        if group_file.exists():
            group_file.unlink()
    u, sh = runs["unsharded"], runs["sharded"]
    expect(sh["params_dtensor"], "the sharded run's parameters are DTensors")
    tok_u, tok_s = int(u["logits"].argmax()), int(sh["logits"].argmax())
    expect(tok_u == tok_s, f"greedy token {tok_s} == {tok_u}")
    rel = rel_l2(sh["logits"], u["logits"])
    expect(rel <= MESH_LOGITS_REL, f"sharded logits rel L2 {rel:.3g} <= "
           f"{MESH_LOGITS_REL}")
    for k in ("loss", "grad_norm"):
        x, y = sh["train"][k], u["train"][k]
        expect(abs(x - y) <= MESH_LOSS_RTOL * abs(y),
               f"sharded {k} {x:.6g} within {MESH_LOSS_RTOL} of {y:.6g}")
    a, b = sh["train"]["loss"], u["train"]["loss"]
    expect(sh["prefill_launches"] == u["prefill_launches"]
           and sh["prefill_launches"]["flash_attention"] == 32
           and sh["prefill_launches"]["grouped_matmul"] == 96,
           f"prefill launches {sh['prefill_launches']} == "
           f"{u['prefill_launches']} (flash 32, grouped GEMM 96)")
    expect(sh["train_launches"] == u["train_launches"]
           and u["train_launches"]["adamw"] == 3,
           f"train launches {sh['train_launches']} == "
           f"{u['train_launches']} (AdamW's kernels 3)")
    lv = sh["leaves"]
    print(f"mesh {MESH_ARCH} (1, 1) NCCL: greedy token {tok_s} both, logits "
          f"rel L2 {rel:.3g}, loss {a:.6f} / {b:.6f}, grad_norm "
          f"{sh['train']['grad_norm']:.6g} / {u['train']['grad_norm']:.6g};"
          f" updated parameters and first moments leaf by leaf: "
          f"{lv['bit_identical']} of {lv['leaves']} bit-identical, worst "
          f"{lv['worst_leaf']} at {lv['worst_share']:.3g} of its bound; "
          f"launches equal", flush=True)
    print(f"mesh {MESH_ARCH} gradient norm by leaf (unsharded, largest "
          f"first: norm, share of the squared norm): "
          f"{[(n, f'{x:.4g}', f'{s_:.4f}') for n, x, s_ in u['leaves']]}",
          flush=True)
    for rec in quad_recs:
        m, r, a = rec["memory"], rec["roofline"], rec["op_analysis"]
        expect(m["peak_per_card_bytes"] >= m["argument_bytes"] > 0
               and a["total_collective_bytes"] > 0,
               f"quad {rec['arch']}: a peak and collective bytes")
        print(f"dryrun quad_2x2 {rec['arch']} {rec['kind']}: "
              f"{rec['batch']} x {rec['seq']} tokens"
              f"{'' if rec['capacity'] is None else ', capacity ' + str(rec['capacity'])}"
              f", peak {m['peak_per_card_bytes'] / 2 ** 30:.2f} GiB a card "
              f"(given {m['argument_bytes'] / 2 ** 30:.2f}), fits "
              f"{m['fits_hbm']}, collective "
              f"{a['total_collective_bytes'] / 2 ** 30:.2f} GiB a card "
              f"{ {k: round(v / 2 ** 30, 3) for k, v in a['collective_bytes'].items()} }"
              f", roofline step {r['step_time_s']:.4f} s "
              f"({r['bottleneck']}, fraction {r['roofline_fraction']:.4f}),"
              f" microbatches {rec['cell']['microbatches']}, trace "
              f"{rec['trace_s']:.1f} s", flush=True)
    seconds = time.perf_counter() - t0
    print(f"mesh phase: {seconds:.1f} s (the quad dry-run's processes ran "
          "beside the kernels' build)", flush=True)
    return dict(world1={k: {kk: vv for kk, vv in v.items() if kk != "logits"}
                        for k, v in runs.items()},
                logits_rel_l2=rel, greedy_token=tok_s, flash_offset=offset,
                quad=quad_recs, seconds=seconds)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # float32 products in full float32 (the plain versions and the float32
    # checks): no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(card, flush=True)
    laps = {"at": time.perf_counter()}

    def lap(name: str) -> None:
        """Print the seconds since the last lap: where the run's time goes."""
        now = time.perf_counter()
        print(f"time {name}: {now - laps['at']:.1f} s", flush=True)
        laps["at"] = now
    t0 = time.perf_counter()
    quad_start()
    _build.library()
    build_s = time.perf_counter() - t0
    quad = quad_join()
    print(f"the quad dry-run's {len(quad)} processes, beside the build: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    regs = _build.ptxas_report(_build.build_log)
    print(f"built the kernels in {build_s:.1f}s; ptxas (registers, spill "
          f"stores, spill loads): "
          f"{ {k: tuple(v.values()) for k, v in regs.items()} }", flush=True)
    spilled = {k: v for k, v in regs.items()
               if any(n in k for n in NO_SPILL)
               and (v["spill_stores"] or v["spill_loads"])}
    expect(regs and not spilled,
           f"ptxas: the redesigned kernels spill no registers: {spilled}")

    sched = make_scheduler()
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // sched.host.topology[FISSION]))
    inputs = make_inputs()
    gpu_units = {}
    for name in ORDER:
        shapes = {k: tuple(v.shape) for k, v in inputs[name].items()
                  if isinstance(v, torch.Tensor)}
        partition = first_partitioning(sched, sct_for(name), shapes)
        gpu_units[name] = partition.units[0]
    results = kernel_phase(inputs, gpu_units, nbody_slot_targets(sched))
    for name, r in results.items():
        print(f"kernel {name} {r['shape']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
              f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), max err "
              f"{r['max_abs_err']:.3g}", flush=True)

    allocated = torch.cuda.memory_allocated()
    with part("decode kernels"):
        results.update(decode_kernel_phase())
    # the part's graph captures run cuBLAS on the capture stream, which
    # keeps a workspace there; cleared, so that the models' peaks after it
    # find what they found before the part
    gc.collect()
    residue = torch.cuda.memory_allocated() - allocated
    torch._C._cuda_clearCublasWorkspaces()
    print(f"decode kernels: {residue} bytes allocated after the part that "
          f"were not before it, "
          f"{torch.cuda.memory_allocated() - allocated} after clearing "
          f"cuBLAS's workspaces", flush=True)
    lap("build and kernels")
    requests, chain, launches = main_path(sched, inputs)
    del inputs
    lap("scheduler")
    gates = gates_phase()
    flash_pad = flash_padding_phase()
    lap("gates and flash padding")
    paper, paper_launches = paper_phase()
    lap("paper")
    by_path = {"scheduler": dict(launches), "paper": paper_launches}
    lm_serve, lm_head = {}, {}
    for arch in LM_ARCHS:
        lm_kernels, lm_serve[arch], lm_head[arch] = lm_phase(arch)
        results.update(lm_kernels)
        by_path[arch] = lm_serve[arch]["launches"]
        lap(f"serve {arch}")
    train_kernels, train, train_head = train_phase()
    lap("train " + TRAIN_ARCH)
    results.update(train_kernels)
    by_path["train " + TRAIN_ARCH] = train["launches"]
    hyb_kernels, hyb_train, hyb_head = hybrid_train_phase()
    results.update(hyb_kernels)
    by_path["train " + HYBRID_TRAIN_ARCH] = hyb_train["launches"]
    lap("train " + HYBRID_TRAIN_ARCH)
    families = {}
    for arch in FAMILY_ARCHS:
        fk, serve, head = family_phase(arch)
        results.update(fk)
        families[arch] = dict(serve=serve, head_check=head)
        by_path[arch] = serve["launches"]
        for extra in ("window", "frontend"):
            if extra in serve:
                by_path[f"{arch} {extra}"] = serve[extra]["launches"]
        lap(f"serve {arch}")
    for arch in CUT_ARCHS:
        fk, serve, check = cut_phase(arch)
        results.update(fk)
        families[arch] = dict(serve=serve, cut_check=check,
                              layers=CUT_LAYERS)
        by_path[f"{arch} {CUT_LAYERS} layers"] = serve["launches"]
        lap(f"serve {arch} {CUT_LAYERS} layers")
    for arch in FAMILY_TRAIN_ARCHS:
        fk, main_, head = family_train_phase(arch)
        results.update({f"{k} {arch} train": v for k, v in fk.items()})
        families[arch].update(train=main_, train_head_check=head)
        by_path["train " + arch] = main_["launches"]
        lap("train " + arch)
    wk, w_serve, w_head, w_grads, w_train = whisper_phase()
    results.update(wk)
    families[WHISPER_ARCH] = dict(serve=w_serve, head_check=w_head,
                                  train=w_train, train_head_check=w_grads)
    by_path[WHISPER_ARCH] = w_serve["launches"]
    by_path["train " + WHISPER_ARCH] = w_train["launches"]
    lap(WHISPER_ARCH)
    example = train_lm_phase()
    by_path["train_lm"] = example["launches"]
    lap("train_lm")
    checked = {f"train {arch}": (arch, "train", families[arch]["train"])
               for arch in CHECKED_TRAIN_ARCHS}
    checked[f"prefill {CHECKED_PREFILL_ARCH}"] = (
        CHECKED_PREFILL_ARCH, "prefill",
        lm_serve[CHECKED_PREFILL_ARCH]["checked_prefill"])
    launch = launch_phase(checked)
    by_path["serve_llm"] = launch["serve_llm"]["launches"]
    lap("launch")
    mesh = mesh_phase(quad)
    lap("mesh")
    by_path[f"mesh {MESH_ARCH} prefill"] = mesh["world1"]["sharded"][
        "prefill_launches"]
    by_path[f"mesh {MESH_ARCH} train"] = mesh["world1"]["sharded"][
        "train_launches"]
    summary = {}
    for arch, fam in families.items():
        sv = fam["serve"]
        row = {"prefill_s_per_request": [round(sec, 4) for _, sec in
                                         sv["prefill_seconds"]],
               "decode_tokens_per_s": round(sv["decode_tokens_per_s"], 1),
               "serve_peak_gib": round(sv["peak_memory_bytes"] / 2 ** 30, 2)}
        if "train" in fam:
            st = fam["train"]["steps"][1:]
            row.update(train_step_s=[round(x["seconds"], 3) for x in st],
                       train_tokens_per_s=[round(x["tokens_per_s"])
                                           for x in st],
                       train_peak_gib=round(fam["train"]["peak_memory_bytes"]
                                            / 2 ** 30, 2))
        summary[arch] = row
        print(f"family {arch}: {row}", flush=True)
    # each kernel's launches over the main paths, each counted from 0
    launches = {k: sum(p[k] for p in by_path.values()) for k in KERNELS}
    expect(all(n > 0 for n in launches.values()),
           f"every kernel launched on a main path: {launches}")

    kernels = []
    for name in ["saxpy", "filter_pipeline", "segmentation", "nbody",
                 "flash_attention", "flash_attention_bwd", "ssd_scan",
                 "ssd_scan_bwd", "grouped_matmul", "grouped_matmul_dx",
                 "grouped_matmul_dw", "adamw", "grad_accum", "rmsnorm",
                 "rope_cache_write", "decode_attention", "ssd_decode_step"]:
        r = results[name]
        source, replaces = KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    # the grouped GEMM's launches for gradients (dx and dw), all
    # training's; the backward kernels' device time alone (torch.profiler)
    # beside their CUDA-event times
    by_name = {k["name"]: k for k in kernels}
    # the accumulation's last call (the scale) beside its middle call
    acc = results["grad_accum"]
    by_name["grad_accum"].update(
        last_ms=acc["last_ms"], last_bound_ms=acc["last_bound"][0],
        library_last_ms=acc["library_last_ms"])
    by_name["grouped_matmul"]["backward_launches"] = train[
        "grouped_matmul_backward_launches"]
    for name in ("grouped_matmul_dx", "grouped_matmul_dw"):
        by_name[name]["device_ms"] = results[name]["device_ms"]
    # the flash backward's and SDPA's backward's device time alone
    # (torch.profiler), beside their CUDA-event times above
    device = results["flash_attention_bwd"]["device_ms"]
    bwd = next(k for k in kernels if k["name"] == "flash_attention_bwd")
    bwd["device_ms"], bwd["library_device_ms"] = (device["kernel"][0],
                                                  device["sdpa"][0])
    # the SSD backward's device time alone (torch.profiler)
    ssd_bwd = next(k for k in kernels if k["name"] == "ssd_scan_bwd")
    ssd_bwd["device_ms"] = results["ssd_scan_bwd"]["device_ms"]
    # both SSD kernels issue split-TF32 products: their bound at that rate,
    # beside the FP32 one in bound_ms
    for k in kernels:
        if k["name"] in ("ssd_scan", "ssd_scan_bwd"):
            k["bound_split_tf32_ms"] = results[k["name"]][
                "bound_split_tf32"][0]
    seconds = time.perf_counter() - t_start
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_seconds": build_s,
              "ptxas": regs, "seconds": seconds,
              "kernel_phase": results, "requests": requests,
              "chain": chain, "gates": gates, "paper": paper,
              "flash_padding": flash_pad, "launches": launches,
              "launches_by_path": by_path, "lm_serve": lm_serve,
              "lm_head_check": lm_head, "train": train,
              "train_head_check": train_head, "train_hybrid": hyb_train,
              "train_hybrid_head_check": hyb_head, "families": families,
              "family_summary": summary, "train_lm": example,
              "launch": launch, "mesh": mesh, "kernels": kernels}
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"chip_smoke: all phases passed in {seconds:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_quad()
    sys.exit(code)
