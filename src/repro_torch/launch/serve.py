"""Serving launcher — batched request serving (``--arch <id>``).

Continuous slot-based batching over a synthetic request stream: requests
join mid-flight as slots free up, and throughput is reported as decoded
tokens/s.  Runs on CUDA unless ``--device cpu`` is given.  An
encoder-decoder arch (whisper-large-v3) is refused, as the JAX launcher
refuses it: its requests need audio frames.

Usage:
    python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke \
        --device cpu --requests 12 --slots 4 --max-new 24
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.executor import resolve_device
from repro_torch.models import LM
from repro_torch.runtime import ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.enc_dec:
        raise SystemExit(f"{cfg.arch}: enc-dec serving needs audio frames; "
                         "use examples/serve_llm.py patterns instead")
    device = resolve_device(args.device)
    print(f"[serve] arch={cfg.arch} device={device} slots={args.slots} "
          f"capacity={args.capacity}")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = LM(cfg, device=device, generator=gen)
    engine = ServeEngine(cfg, model, slots=args.slots,
                         capacity=args.capacity,
                         temperature=args.temperature, seed=args.seed,
                         device=str(device))

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab, plen).tolist()
        engine.submit(prompt, max_new=args.max_new)

    t0 = time.time()
    steps = 0
    while engine.queue or any(s is not None for s in engine.active):
        engine.step()
        steps += 1
        if steps > 10_000:
            raise RuntimeError("serve loop did not converge")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    done = engine.finished
    toks = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s, {steps} engine steps)")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4]} "
              f"out[:8]={r.out[:8]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
