"""The JAX package's CI gates over the port's main path, each runnable as
``python -m repro_torch.bench.<name>``: :mod:`.locality` (plan cache,
pools, in-place merge, resident chains), :mod:`.pipeline` (graph
submission, the whole-graph plan cache, cross-request fusion) and
:mod:`.telemetry_smoke` (a fault-injected chain's Chrome trace).  Each
runs its accelerator slots on CUDA streams unless ``--device cpu`` is
given, and writes ``BENCH_<name>_torch.json``."""
