"""Training launcher — the end-to-end driver (``--arch <id>``).

The port's counterpart of the JAX package's ``launch/train.py``, with its
flags and its loop: deterministic stateless data, atomic asynchronous
checkpoints every ``--ckpt-every`` steps with keep-K, restore from the
latest on ``--resume``, the per-arch LR recipe (wsd or cosine), and the
optional int8 + error-feedback gradient sync (``--compress``, over the
``torch.distributed`` group: every process ``torchrun`` starts, one card
each, or a group of one process without it).  An encoder-decoder's batches
carry ``frames`` and a VLM's ``frontend_embeds``, drawn once from a seeded
generator, as the reference's do.  Runs on CUDA unless ``--device cpu`` is
given.

Usage:
    python -m repro_torch.launch.train --arch granite-moe-3b-a800m \\
        --smoke --device cpu --steps 4
    torchrun --nproc-per-node N -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --compress      # N cards, int8 sync
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import (CheckpointManager, state_from_tree,
                                    state_to_tree)
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.executor import resolve_device
from repro_torch.data import DataConfig, batch_at
from repro_torch.models import LM
from repro_torch.optim import (AdamW, AdamWConfig, cosine_schedule,
                               wsd_schedule)
from repro_torch.runtime import (RuntimeConfig, init_state,
                                 make_dp_train_step_int8, make_train_step)


def build_optimizer(cfg, lr: float, steps: int) -> AdamW:
    if cfg.lr_schedule == "wsd":
        sched = wsd_schedule(lr, warmup=max(steps // 20, 1),
                             stable=int(steps * 0.7),
                             decay=max(int(steps * 0.25), 1))
    else:
        sched = cosine_schedule(lr, warmup=max(steps // 20, 1), total=steps)
    return AdamW(AdamWConfig(lr=sched))


def _init_group(device: torch.device) -> Optional[str]:
    """The data-parallel group (gloo on the CPU, NCCL on the card): every
    process of a ``torchrun`` launch (``RANK``/``WORLD_SIZE`` and its
    rendezvous from the environment), or else one process through a file
    under the temporary directory, whose path is returned."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
        return None
    fd, path = tempfile.mkstemp(prefix="repro_torch_dist_")
    os.close(fd)
    os.unlink(path)
    dist.init_process_group(backend, init_method=f"file://{path}",
                            world_size=1, rank=0)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="int8 + error-feedback DP gradient sync")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    print(f"[train] arch={cfg.arch} params={cfg.param_count()/1e6:.1f}M "
          f"schedule={cfg.lr_schedule} device={device}")

    opt = build_optimizer(cfg, args.lr, args.steps)
    rt = RuntimeConfig(microbatches=args.microbatches, remat=args.remat,
                       loss_chunks=1, aux_weight=0.01)
    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(args.seed))
    state = init_state(model, opt, compress=args.compress)

    group_file: Optional[str] = None
    grouped = args.compress
    if grouped:
        group_file = _init_group(device)
        step_fn = make_dp_train_step_int8(cfg, opt, rt)
    else:
        step_fn = make_train_step(cfg, opt, rt)

    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                    global_batch=args.batch, seed=args.seed)

    # the stub frontends: the same bf16 embeddings every step, the
    # encoder-decoder's (batch, enc_frames, d) frames or a VLM's (batch, P,
    # d), from generator seed 7.  The reference draws them from
    # PRNGKey(7): another generator, so the two launchers' embeddings
    # differ (parity tests pass their own).
    extras = {}
    stub = (("frames", cfg.enc_frames) if cfg.enc_dec
            else ("frontend_embeds", cfg.frontend_positions)
            if cfg.frontend_positions else None)
    if stub is not None:
        gen = torch.Generator(device=device).manual_seed(7)
        extras[stub[0]] = torch.randn(
            (args.batch, stub[1], cfg.d_model),
            generator=gen, device=device).to(torch.bfloat16)

    start = 0
    mgr: Optional[CheckpointManager] = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=args.keep)
        if args.resume:
            got = mgr.restore_latest(state_to_tree(state))
            if got is not None:
                tree, meta = got
                state = state_from_tree(state, tree)
                start = meta.step
                print(f"[train] resumed from step {start}")

    # one writer: rank 0 of a multi-process group saves (every rank holds
    # the same parameters and moments; rank 0's error feedback is kept)
    saver = mgr if not grouped or dist.get_rank() == 0 else None
    try:
        t0 = time.time()
        tokens_per_step = args.batch * args.seq_len
        for step in range(start, args.steps):
            state, metrics = step_fn(state, {**batch_at(dc, step),
                                             **extras})
            if (step + 1) % args.log_every == 0 or step == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                tps = tokens_per_step * (step + 1 - start) / max(dt, 1e-9)
                print(f"step {step + 1:5d} loss={m['loss']:.4f} "
                      f"aux={m['aux_loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} "
                      f"lr={m['lr']:.2e} tok/s={tps:,.0f}")
            if saver and (step + 1) % args.ckpt_every == 0:
                saver.save(step + 1, state_to_tree(state),
                           payload={"data_step": step + 1})
        if saver:
            saver.save(args.steps, state_to_tree(state),
                       payload={"data_step": args.steps}, blocking=True)
        print(f"[train] done in {time.time() - t0:.1f}s")
    finally:
        if grouped:
            dist.destroy_process_group()
        if group_file is not None and os.path.exists(group_file):
            os.unlink(group_file)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
