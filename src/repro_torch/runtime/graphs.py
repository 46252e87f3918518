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

The prefill as one CUDA graph per repeated prompt length:
:class:`PrefillGraphs` is the counterpart of the ``jax.jit`` cache over
the JAX engine's ``_prefill1``, which compiles one program for each prompt
shape.  A length's first prefill runs eagerly (it is the capture's
warm-up), its second is captured and replayed, every later one replayed:
traffic whose lengths never repeat pays no capture.  The graphs' outputs
(one batch-1 cache at the engine's capacity, one logits buffer) live
outside them, so all lengths' graphs share one memory pool and replay in
any order; they are invalidated in the same way, and run eagerly on the
CPU in the same way.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.models.lm import LM, Cache, decode_step, init_cache, prefill


def _addresses(model: LM, tensors) -> List[int]:
    """Where a graph's inputs lie: every parameter and buffer of the model,
    then ``tensors``."""
    return [t.data_ptr() for t in (*model.parameters(), *model.buffers(),
                                   *tensors)]


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
        return _addresses(self.model, self.cache.values())

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


@dataclasses.dataclass
class PrefillLength:
    """One prompt length of :class:`PrefillGraphs`: its calls so far, its
    static (1, S) token buffer and graph from its second call on (the
    graph None on the CPU), the launches a replay counts, the addresses it
    was captured over, the seconds of its capture (the recording, which
    runs nothing) and the calls served from the static outputs (replays
    on CUDA)."""

    calls: int = 0
    tokens: Optional[torch.Tensor] = None
    graph: Optional[torch.cuda.CUDAGraph] = None
    launches: Dict[_build.LaunchCounter, int] = dataclasses.field(
        default_factory=dict)
    addresses: List[int] = dataclasses.field(default_factory=list)
    capture_s: Optional[float] = None
    replays: int = 0


class PrefillGraphs:
    """``prefill(model, tokens, capacity=capacity)`` at batch 1: a prompt
    length's first call runs it eagerly into a fresh cache, its second
    captures it on CUDA and replays the capture, every later call replays.

    The first call of a length is the capture's warm-up (the kernels are
    built and every lazy handle is made on the current stream), so a
    length seen once costs what the eager prefill costs and a length seen
    again pays one capture.  From the second call on the outputs are
    static: ``cache`` (:func:`~repro_torch.models.lm.init_cache` at batch 1
    and ``capacity``, made when a length first repeats) and ``logits``
    (1, V), both allocated outside every graph's memory and overwritten
    by each such call.  ``prefill`` rewrites every row of every cache entry (k/v
    padded to the capacity or packed into their rolling window, the SSM
    state and conv tails whole), so a call leaves nothing of an earlier,
    longer one, as the JAX ``_prefill1`` starts from a fresh zero cache.
    Since no output lives in a graph's memory, the graphs share one pool
    (``pool``), which holds about one prefill's intermediates whatever the
    number of lengths.

    Each length's graph is valid while what it reads stays where it was at
    capture: the parameters and buffers (the grouped GEMM's TMA maps bake
    their addresses in), the cache, the logits and its token buffer.  A
    replay after any of them moved raises; capture and replay errors raise
    (a failed capture is tried again at the length's next call): there is
    no eager fallback.  On CUDA the launch counters count each
    call as one eager prefill: the capture's launches are taken back and
    each replay adds them.  On the CPU there is no graph: a length's later
    calls run the same prefill eagerly into the same static outputs.
    """

    def __init__(self, model: LM, capacity: int):
        self.model, self.capacity = model, capacity
        self.device = next(model.parameters()).device
        self.cache: Optional[Cache] = None
        self.logits: Optional[torch.Tensor] = None
        self.lengths: Dict[int, PrefillLength] = {}
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)

    def _run(self, tokens: torch.Tensor) -> None:
        """The captured function: one prefill into the static cache, its
        logits copied into the static buffer."""
        out, _ = prefill(self.model, tokens, capacity=self.capacity,
                         cache=self.cache)
        self.logits.copy_(out)

    def _where(self, length: PrefillLength) -> List[int]:
        return _addresses(self.model, (*self.cache.values(), self.logits,
                                       length.tokens))

    @torch.no_grad()
    def _capture(self, length: PrefillLength) -> None:
        """Record the prefill of ``length.tokens`` into the static outputs
        in the shared pool (a capture runs nothing) and take its launches
        back: each replay adds them."""
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = _build.launch_counts()
        with torch.cuda.graph(graph, pool=self.pool):
            self._run(length.tokens)
        length.launches = _build.counted_since(before)
        _build.add_counts(length.launches, sign=-1)
        length.graph, length.addresses = graph, self._where(length)
        length.capture_s = time.perf_counter() - t0

    def __call__(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
        """tokens (1, S) -> (logits (1, V), cache): a fresh prefill's at a
        length's first call, the static outputs at later ones."""
        if tokens.ndim != 2 or tokens.shape[0] != 1:
            raise ValueError(f"a batch-1 prompt (1, S), got shape "
                             f"{tuple(tokens.shape)}")
        S = tokens.shape[1]
        length = self.lengths.setdefault(S, PrefillLength())
        length.calls += 1
        if length.calls == 1:
            with torch.no_grad():
                logits, cache = prefill(self.model, tokens,
                                        capacity=self.capacity)
            if self.logits is None:
                self.logits = torch.empty_like(logits)
            return logits, cache
        if length.tokens is None:
            length.tokens = tokens.to(self.device, torch.long, copy=True)
        else:
            length.tokens.copy_(tokens)
        if self.cache is None:
            self.cache = init_cache(self.model.cfg, 1, self.capacity,
                                    device=self.device)
        if self.device.type == "cuda" and length.graph is None:
            self._capture(length)
        if length.graph is None:
            with torch.no_grad():
                self._run(length.tokens)
        else:
            if self._where(length) != length.addresses:
                raise RuntimeError(
                    f"the {S}-token prefill graph reads parameters or "
                    "static tensors that have moved since its capture; "
                    "make a new PrefillGraphs")
            length.graph.replay()
            _build.add_counts(length.launches)
        length.replays += 1
        return self.logits, self.cache

    def pool_bytes(self) -> int:
        """Bytes the graphs' shared pool holds on the card (0 on the CPU)."""
        if self.pool is None:
            return 0
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == tuple(self.pool))

    def static_bytes(self) -> int:
        """Bytes of the static outputs (the cache and the logits; 0 before
        the first capture or second call of a length)."""
        if self.cache is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in (*self.cache.values(), self.logits))
