"""Benchmarks of the port, each runnable as
``python -m repro_torch.bench.<name>``.

The JAX package's CI gates over the main path: :mod:`.locality` (plan
cache, pools, in-place merge, resident chains), :mod:`.pipeline` (graph
submission, the whole-graph plan cache, cross-request fusion) and
:mod:`.telemetry_smoke` (a fault-injected chain's Chrome trace).  Each
runs its accelerator slots on CUDA streams unless ``--device cpu`` is
given, and writes ``BENCH_<name>_torch.json``.

The paper's experiments, one module per table or figure, all run by
:mod:`.run` (``build/BENCH_paper_torch.json``):

  fission.py              Table 2 / Fig 6     CPU-only device fission
  profile_construction.py Fig 5               Algorithm 1's search trace
  hybrid.py               Table 3 / Figs 7-8  CPU+GPU vs GPU-only
  maxdev.py               Table 4             maxDev calibration
  kb_derivation.py        Table 5 / Figs 9-10 KB-derived vs built profiles
  load_fluctuation.py     Fig 11              adaptation to CPU load

over :mod:`.paper_suite` (the SCTs, the 2013 testbeds, the host's
inputs and checks).  ``--testbed sim`` runs the JAX package's protocol on
the calibrated simulator; ``--testbed host`` (the default) the same on
this machine's cores and ``cuda:0`` streams.  :mod:`.roofline` renders
the single-H100 dry-run's table (:mod:`repro_torch.launch.dryrun`'s
artifacts), as the reference's ``roofline`` renders its TPU one.
"""
