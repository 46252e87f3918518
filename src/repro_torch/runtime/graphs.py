"""The decode step as one CUDA graph: the port's counterpart of the JAX
engine's one jitted program a step (``jax.jit(..., donate_argnums=(1,))``
over a traced int32 position).

:class:`DecodeGraph` owns, for one model and one decode cache, the static
token (B,) and position () buffers, the static logits and, on CUDA, the
graph captured over them with its own memory pool.  A call copies the
token and the position into the buffers and replays the graph, which
reads the position from device memory and updates the cache in place.

What the graph holds is only valid while everything it reads stays where
it was at capture: the parameters (the grouped GEMM's TMA maps encode
their addresses on the host, and the capture bakes them in), the cache's
tensors and the buffers.  A replay after a parameter or a cache tensor
was rebound raises; a new capacity or slot count is a new cache and so a
new graph.  Capture and replay errors raise: there is no eager fallback.

On the CPU there is no graph: a call runs the same ``decode_step``
eagerly with the same tensor position, so the CPU's parity tests run the
code that the card captures.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.models.lm import LM, Cache, decode_step


class DecodeGraph:
    """``decode_step(model, cache, token, pos)`` at batch ``batch``,
    captured once on CUDA and replayed by each call.

    ``token`` and ``pos`` are the static inputs (a caller may write the
    token buffer in place); ``logits`` is the static output of a replay,
    overwritten by the next one.  On CUDA the launch counters of the
    hand-written kernels count each replay's launches as the eager step
    would (:class:`~repro_torch.kernels._build.LaunchCounter`)."""

    def __init__(self, model: LM, cache: Cache, batch: int):
        self.model, self.cache = model, cache
        device = next(iter(cache.values())).device
        self.token = torch.zeros(batch, dtype=torch.long, device=device)
        self.pos = torch.zeros((), dtype=torch.long, device=device)
        self.logits: Optional[torch.Tensor] = None
        self.cuda_graph: Optional[torch.cuda.CUDAGraph] = None
        self._launches = {}
        self._addresses: List[int] = []
        if device.type == "cuda":
            self._capture(device)

    def _where(self) -> List[int]:
        """The addresses the graph reads: every parameter and buffer of the
        model, every cache tensor."""
        return [t.data_ptr() for t in (*self.model.parameters(),
                                       *self.model.buffers(),
                                       *self.cache.values())]

    @torch.no_grad()
    def _capture(self, device: torch.device) -> None:
        """Warm up over a copy of the cache (the kernels build and every
        lazy handle is made, and the cache is left as it was), then capture
        one step over the cache itself; a capture records the kernels
        without running them.  The warm-up runs on the current stream: a
        new stream would get a cuBLAS workspace of its own that the process
        keeps for good, one a graph."""
        scratch = {k: v.clone() for k, v in self.cache.items()}
        decode_step(self.model, scratch, self.token, self.pos)
        del scratch
        self.cuda_graph = torch.cuda.CUDAGraph()
        before = _build.launch_counts()
        with torch.cuda.graph(self.cuda_graph):
            self.logits, _ = decode_step(self.model, self.cache, self.token,
                                         self.pos)
        self._launches = _build.counted_since(before)
        _build.add_counts(self._launches, sign=-1)
        self._addresses = self._where()

    def __call__(self, pos: int, token: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """One decode step at ``pos`` of ``token`` (default: what the token
        buffer holds): the logits (B, V)."""
        if token is not None and token is not self.token:
            self.token.copy_(token)
        self.pos.fill_(pos)
        if self.cuda_graph is None:
            with torch.no_grad():
                self.logits, _ = decode_step(self.model, self.cache,
                                             self.token, self.pos)
            return self.logits
        if self._where() != self._addresses:
            raise RuntimeError(
                "the decode graph reads parameters or cache tensors that "
                "have moved since its capture; capture a new DecodeGraph")
        self.cuda_graph.replay()
        _build.add_counts(self._launches)
        return self.logits
