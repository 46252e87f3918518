"""PyTorch + CUDA port of the Marrow runtime (the JAX package ``repro``
is its reference).

  core/     the runtime: SCTs, decomposition, knowledge base, Algorithm 1,
            load balancer, scheduler, executor with CUDA-stream slots
  kernels/  hand-written sm_90a CUDA kernels (the paper's benchmark suite,
            flash attention, the Mamba2 SSD scan), their plain PyTorch
            versions, and the dispatch between them by device
  models/   the LM substrate: config, layers, attention, Mamba2 (SSD), the
            hybrid model (zamba2) with its decode cache, and
            ``from_jax_params``
  configs/  the architectures the port runs (zamba2-2.7b)
  runtime/  serving: prefill/decode step builders and ``ServeEngine``
  launch/   ``python -m repro_torch.launch.serve``
  suite.py  the paper's benchmark SCTs over those kernels
"""
