"""Quickstart: the paper's programming model in five minutes.

Builds a compound multi-kernel computation (a Marrow skeleton
computational tree), hands it to the scheduler, and lets the runtime
decompose it locality-aware across the available execution resources,
derive a workload distribution from the knowledge base, and refine it
online — the Fig. 4 decision workflow.  The accelerator slots are CUDA
streams on ``cuda:0`` unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (AcceleratorPlatform, DeviceInfo, HostPlatform,
                              JobGraph, KnowledgeBase, Pipeline, Scheduler,
                              Session, ThreadedExecutor, kernel, scalar,
                              vector)


def assert_host_close(got, want: np.ndarray) -> None:
    """A run output, as a host tensor, against the numpy expectation."""
    torch.testing.assert_close(torch.as_tensor(got).cpu(),
                               torch.from_numpy(want), rtol=1e-7, atol=0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the accelerator slots run")
    args = ap.parse_args(argv)

    # 1. Wrap kernels with their interfaces (paper Table 1): scale and
    #    shift share the vector edge "mid" -> the locality-aware
    #    decomposition partitions both identically, so "mid" never moves.
    scale = kernel(lambda a, x: a * x, name="scale",
                   inputs=[scalar("a"), vector("x")],
                   outputs=[vector("mid")])
    shift = kernel(lambda m, b: m + b, name="shift",
                   inputs=[vector("mid"), scalar("b")],
                   outputs=[vector("y")])
    sct = Pipeline(scale, shift)
    print("SCT:", sct.unique_id())

    # 2. Describe the execution resources (host CPU + accelerator class).
    host = HostPlatform(DeviceInfo("cpu0", "cpu", compute_units=8),
                        topology={"L1": 8, "L2": 4, "L3": 2,
                                  "NO_FISSION": 1})
    accel = AcceleratorPlatform([DeviceInfo("acc0", "gpu")], max_overlap=4)

    # 3. Scheduler = KB-derived distribution + lbt monitor + adaptive
    #    rebalancing; Session = the async FCFS request queue.
    sched = Scheduler(host=host, accel=accel,
                      executor=ThreadedExecutor(device=args.device),
                      kb=KnowledgeBase())
    session = Session(sched)

    x = np.arange(1 << 16, dtype=np.float32)
    fut = session.run(sct, a=np.float32(2.0), b=np.float32(1.0), x=x)
    run = fut.get()
    assert_host_close(run.outputs["y"], 2 * x + 1)
    print(f"run 1: action={run.action} share_a={run.profile.share_a:.2f} "
          f"partitions={len(run.stats.times)}")

    # 4. Recurrent executions reuse (and refine) the stored profile.
    for i in range(3):
        run = session.run(sct, a=np.float32(2.0), b=np.float32(1.0),
                          x=x).get()
        print(f"run {i + 2}: action={run.action} "
              f"deviation={run.stats.deviation:.2f}")

    # 5. A new workload size triggers KB derivation (Sec. 3.2.3).
    x2 = np.arange(1 << 18, dtype=np.float32)
    run = session.run(sct, a=np.float32(3.0), b=np.float32(0.5),
                      x=x2).get()
    assert_host_close(run.outputs["y"], 3 * x2 + 0.5)
    print(f"new workload: action={run.action} (KB size={len(sched.kb)})")

    # 6. Fan-out: independent computations as one JobGraph — nodes with
    #    no mutual dependencies overlap on the per-device work queues.
    square = kernel(lambda x: x * x, name="square",
                    inputs=[vector("x")], outputs=[vector("sq")])
    negate = kernel(lambda x: -x, name="negate",
                    inputs=[vector("x")], outputs=[vector("neg")])
    g = JobGraph()
    g.add(square)
    g.add(negate)
    g.add(sct)                       # the pipeline rides along too
    handle = session.submit(g, a=np.float32(2.0), b=np.float32(1.0), x=x)
    result = handle.result(timeout=60)
    assert_host_close(result.outputs["sq"], x * x)
    assert_host_close(result.outputs["neg"], -x)
    assert_host_close(result.outputs["y"], 2 * x + 1)
    print(f"graph fan-out: {len(result.order)} nodes, "
          f"states={set(handle.status().values())}")
    session.shutdown()
    print("quickstart OK")


if __name__ == "__main__":
    main()
