"""PyTorch + CUDA port of the Marrow runtime (the JAX package ``repro``
is its reference).

  core/     the runtime: SCTs, decomposition, knowledge base, Algorithm 1,
            load balancer, scheduler, executor with CUDA-stream slots
  kernels/  hand-written sm_90a CUDA kernels of the paper's benchmark
            suite, their plain PyTorch versions, and the dispatch between
  suite.py  the paper's benchmark SCTs over those kernels
"""
