"""The paper's experiments: one module per table or figure.

    PYTHONPATH=src python -m repro_torch.bench.run [--full] [--only NAME]
        [--testbed {host,sim}] [--device {cuda,cpu}] [--smoke]

``--testbed host`` (the default) runs each experiment on this machine:
its cores as the fission slots, ``cuda:0`` streams as the overlap slots,
the main path's kernels as the bodies; without a card it raises unless
``--device cpu`` puts the accelerator slots on host threads (with
``--smoke``: the tests' sizes).  ``--testbed sim`` runs the JAX package's
protocol on the calibrated 2013 testbeds, and its CSV lines equal
``python -m benchmarks.run``'s (``fission_real``, wall clock, aside).
``--full`` runs the complete parameterisation classes; the default
exercises every experiment at reduced size.  Prints a ``name,...`` CSV
block at the end and writes every cell's numbers, with the host's
topology and the card's name, to ``--out``.  Last, as in the reference,
``roofline`` prints the table of the single-H100 dry-run's artifacts
(``python -m repro_torch.launch.dryrun`` writes them); without artifacts
it says so and adds no lines.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

#: the modules, in the reference's order
MODULES = ("fission", "profile_construction", "hybrid", "maxdev",
           "kb_derivation", "load_fluctuation", "roofline")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None, choices=MODULES,
                    help="run a single module (e.g. 'hybrid')")
    ap.add_argument("--testbed", choices=("host", "sim"), default="host")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the host testbed's accelerator slots run")
    ap.add_argument("--smoke", action="store_true",
                    help="the host testbed at the tests' sizes (sim "
                         "ignores it)")
    ap.add_argument("--out", default="build/BENCH_paper_torch.json")
    args = ap.parse_args(argv)

    import importlib

    import torch

    from repro_torch.bench.report import write
    record = {"testbed": args.testbed, "full": args.full,
              "smoke": args.smoke, "device": args.device,
              "torch": torch.__version__, "modules": {}}
    if args.testbed == "host":
        from repro_torch.bench.hybrid import host_scheduler, host_topology
        sched = host_scheduler(args.device)         # raises without a card
        record["host"] = host_topology(sched)
        sched.close()
        record["card"] = (torch.cuda.get_device_name(0)
                          if args.device == "cuda" else None)
        print(f"host: {record['host']}, card: {record['card']}")
    names = [args.only] if args.only else list(MODULES)
    all_lines = []
    for name in names:
        mod = importlib.import_module(f"repro_torch.bench.{name}")
        kw = {}
        if name == "load_fluctuation" and args.testbed == "host":
            # start from the FFT-128 profile hybrid tuned, where it ran
            cells = record["modules"].get("hybrid", {}).get("cells", [])
            tuned = [c for c in cells
                     if c["benchmark"] == "fft" and c["size"] == 128]
            if tuned:
                kw["start"] = {k: tuned[0][k]
                               for k in ("gpu_share", "fission", "overlap")}
        t0 = time.time()
        try:
            res = mod.collect(args.full, args.testbed, args.device,
                              args.smoke and args.testbed == "host", **kw)
        except Exception as e:           # keep the harness's report
            print(f"-- {name} FAILED: {e!r} --\n")
            traceback.print_exc()
            return 1
        res["seconds"] = time.time() - t0
        record["modules"][name] = res
        all_lines.extend(res["lines"])
        print(f"-- {name} done in {res['seconds']:.1f}s --\n")

    print("==== CSV summary ====")
    for line in all_lines:
        print(line)
    write(record, args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
