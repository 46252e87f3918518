"""Batched serving example: continuous slot-based batching with mixed
request lengths over a smoke-scale hybrid (Mamba2+attention) model.

The port's counterpart of the JAX package's ``examples/serve_llm.py``:
smoke zamba2-2.7b, 4 slots, capacity 96, temperature 0.8, seed 0; six
requests, then three more that join at step 5.  On the card (the default)
its prefills run flash attention and the SSD scan through their kernels;
``--device cpu`` runs their plain versions on the host.

    PYTHONPATH=src python -m repro_torch.examples.serve_llm [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.executor import resolve_device
from repro_torch.models import LM
from repro_torch.runtime import ServeEngine

ARCH = "zamba2-2.7b"
SLOTS, CAPACITY, TEMPERATURE, SEED = 4, 96, 0.8, 0
#: the step at which the second wave joins, and its size
JOIN_STEP, LATE = 5, 3


def serve(cfg, model, device, temperature: float = TEMPERATURE,
          seed: int = SEED):
    """The example's traffic through a ``ServeEngine``: returns the engine
    (its ``finished`` requests), the steps it took and the step at which
    the late requests joined."""
    engine = ServeEngine(cfg, model, slots=SLOTS, capacity=CAPACITY,
                         temperature=temperature, seed=seed,
                         device=str(device))
    rng = np.random.default_rng(seed)
    # a first wave of requests...
    for _ in range(6):
        plen = int(rng.integers(4, 24))
        engine.submit(rng.integers(0, cfg.vocab, plen).tolist(),
                      max_new=int(rng.integers(6, 20)))
    steps, joined_at = 0, None
    while engine.queue or any(s is not None for s in engine.active):
        engine.step()
        steps += 1
        # ...and a second wave arriving mid-flight (continuous batching)
        if steps == JOIN_STEP and joined_at is None:
            for _ in range(LATE):
                engine.submit(rng.integers(0, cfg.vocab, 8).tolist(),
                              max_new=8)
            joined_at = steps
            print(f"[serve] {LATE} more requests joined at step {steps}")
        if steps > 5000:
            raise RuntimeError("did not converge")
    return engine, steps, joined_at


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke(ARCH)
    print(f"[serve] {cfg.arch} ({cfg.param_count() / 1e6:.2f}M params) on "
          f"{device}")
    model = LM(cfg, device=device,
               generator=torch.Generator(device=device).manual_seed(SEED))
    t0 = time.time()
    engine, steps, joined_at = serve(cfg, model, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in engine.finished)
    print(f"[serve] {len(engine.finished)} requests -> {toks} tokens "
          f"in {dt:.1f}s ({toks / dt:.1f} tok/s, {steps} steps)")
    assert len(engine.finished) == 9
    assert all(len(r.out) == r.max_new for r in engine.finished)
    assert joined_at == JOIN_STEP
    print("serve example OK")
    return engine


if __name__ == "__main__":
    main()
