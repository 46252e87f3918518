"""End-to-end training example: a ~100M-parameter dense LM for a few
hundred steps, with checkpoints, a cosine schedule and deterministic
restart-safe data.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \\
        [--device cpu]

The port's counterpart of the JAX package's ``examples/train_lm.py``, with
its configuration and recipe: 16 layers, d_model 672, 8 query and 4 kv
heads of 84 (flash attention runs them padded to 128 on the card), vocab
16384; cosine 3e-3 with 20 warm-up steps, 2 microbatches, remat "dots",
the loss in 4 sequence chunks, a checkpoint every 100 steps and at the
end (keep 2), and a restart from the latest checkpoint in ``--ckpt-dir``.
Runs on CUDA unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint import (CheckpointManager, state_from_tree,
                                    state_to_tree)
from repro_torch.core.executor import resolve_device
from repro_torch.data import DataConfig, batch_at
from repro_torch.models import LM, ModelConfig
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
from repro_torch.runtime import RuntimeConfig, init_state, make_train_step


def config_100m() -> ModelConfig:
    """~100M params: 16L, d=672, llama-style dense."""
    return ModelConfig(arch="demo-100m", family="dense", n_layers=16,
                       d_model=672, n_heads=8, n_kv_heads=4, d_ff=1920,
                       vocab=16384, head_dim=84, tie_embeddings=True)


def main(argv=None, *, cfg: Optional[ModelConfig] = None) -> dict:
    """Trains ``cfg`` (default :func:`config_100m`); returns the step it
    started from and the first and final logged losses."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="build/train_lm_100m")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = cfg or config_100m()
    device = resolve_device(args.device)
    print(f"[example] {cfg.arch}: {cfg.param_count() / 1e6:.1f}M params "
          f"on {device}")
    opt = AdamW(AdamWConfig(lr=cosine_schedule(3e-3, warmup=20,
                                               total=args.steps)))
    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(0))
    state = init_state(model, opt)
    step_fn = make_train_step(cfg, opt, RuntimeConfig(
        microbatches=2, remat="dots", loss_chunks=4))
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                    global_batch=args.batch)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    start = 0
    got = mgr.restore_latest(state_to_tree(state))
    if got is not None:
        state = state_from_tree(state, got[0])
        start = got[1].step
        print(f"[example] resumed from step {start}")

    t0 = time.time()
    first_loss = final = None
    for step in range(start, args.steps):
        state, metrics = step_fn(state, batch_at(dc, step))
        if step % 25 == 0 or step == args.steps - 1:
            final = float(metrics["loss"])
            first_loss = first_loss if first_loss is not None else final
            tps = (args.batch * args.seq_len * (step + 1 - start)
                   / max(time.time() - t0, 1e-9))
            print(f"step {step:4d} loss={final:.4f} "
                  f"lr={float(metrics['lr']):.2e} tok/s={tps:,.0f}")
        if (step + 1) % 100 == 0:
            mgr.save(step + 1, state_to_tree(state))
    mgr.save(args.steps, state_to_tree(state), blocking=True)
    if final is not None:
        print(f"[example] loss {first_loss:.3f} -> {final:.3f} "
              f"in {time.time() - t0:.0f}s")
    if args.steps - start >= 200:      # short smoke runs are noise-bound
        assert final < first_loss, "training must reduce the loss"
    return dict(start=start, first_loss=first_loss, final_loss=final)


if __name__ == "__main__":
    main()
