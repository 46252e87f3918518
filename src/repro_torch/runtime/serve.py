"""Serving runtime: prefill + decode step builders and a batched engine.

``ServeEngine`` runs the serving path from the host: continuous
batched decode over a slot-based request pool (join/leave between steps,
greedy or temperature sampling), as in the JAX package.  It runs on CUDA
unless ``device="cpu"`` is passed, and raises without a card otherwise.
On CUDA each decode step is one replay of a CUDA graph captured when the
engine is made (:class:`~repro_torch.runtime.graphs.DecodeGraph`), as the
JAX engine runs one jitted program a step, and each batch-1 prefill of a
prompt length seen before is one replay of a graph captured at that
length's second prefill
(:class:`~repro_torch.runtime.graphs.PrefillGraphs`; a length's first
prefill runs eagerly and is the capture's warm-up), as the JAX engine
jits ``_prefill1`` once a prompt shape; on the CPU the same steps run
eagerly.  The splice into the slot and sampling stay outside the graphs,
as the JAX engine keeps them outside its jits.  Like the JAX engine it
keeps one decode position for all slots (the longest prompt admitted so
far); see ROADMAP.md, faults of the reference.  An optional ``on_step``
callback sees each prefill and decode step with its host-clock seconds
and its logits, for measurement and checks.  As the JAX engine has no
way to pass audio frames, this one refuses an encoder-decoder model:
serve it through ``prefill(..., frames=...)`` and ``decode_step`` (or a
``DecodeGraph``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.executor import resolve_device
from repro_torch.core.faults import ExecutionError
from repro_torch.models.config import ModelConfig
from repro_torch.models.attention import Position
from repro_torch.models.lm import (LM, Cache, cache_defs, decode_step,
                                   init_cache, prefill)
from repro_torch.runtime.graphs import DecodeGraph, PrefillGraphs


def make_prefill_step(cfg: ModelConfig, capacity: Optional[int] = None):
    """(model, tokens, **extras) -> (last-token logits (B,V), cache)."""

    def prefill_step(model: LM, tokens: torch.Tensor, **extras):
        return prefill(model, tokens, capacity=capacity, **extras)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """(model, cache, token (B,), pos) -> (logits (B,V), cache); ``pos`` an
    int or a 0-d tensor (:func:`repro_torch.models.lm.decode_step`)."""

    def step(model: LM, cache: Cache, token: torch.Tensor, pos: Position):
        return decode_step(model, cache, token, pos)

    return step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float = 1.0) -> torch.Tensor:
    if temperature <= 0:
        return greedy(logits)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


#: ``on_step(kind, n, seconds, logits)``: kind "prefill" with n the prompt's
#: tokens, or "decode" with n the active slots
StepHook = Callable[[str, int, float, torch.Tensor], None]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


class ServeEngine:
    """Slot-based continuous batching (host-side orchestration).

    A fixed decode batch of ``slots`` sequences advances one token per
    ``step()``; finished sequences free their slot, queued requests are
    prefilled (batch 1) into free slots and spliced into the shared cache.

    ``on_step``, when given, is called after every prefill and decode step
    with the seconds from the step's start to the host's read of the tokens
    it sampled (a read that waits for the device), and the step's logits.
    A step's logits may be a graph's static output (a repeated length's
    prefill's also on the CPU): the next step of its kind overwrites them,
    so a hook that keeps them copies them.

    The decode graph (``graph``) is captured over the model's parameters
    and the engine's cache, each prefill graph (``prefill_graphs``, one a
    repeated prompt length) over the parameters and its static batch-1
    cache, logits and tokens: rebinding a parameter invalidates them (the next
    step or prefill raises), and a new capacity or slot count needs a new
    engine.
    """

    def __init__(self, cfg: ModelConfig, model: LM, *, slots: int,
                 capacity: int, temperature: float = 0.0, seed: int = 0,
                 device: Optional[str] = None,
                 on_step: Optional[StepHook] = None):
        if cfg.enc_dec:
            raise ValueError(
                f"{cfg.arch}: the engine has no way to pass an "
                "encoder-decoder's audio frames; serve it through "
                "prefill(..., frames=...) and decode_step")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device)
        self.slots = slots
        self.capacity = capacity
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.on_step = on_step

        self.prefill_graphs = PrefillGraphs(self.model, capacity)

        self.cache: Cache = init_cache(cfg, slots, capacity,
                                       device=self.device)
        self._batch_dims = batch_dims(cfg, capacity)
        self.graph = DecodeGraph(self.model, self.cache, slots)
        #: the graph's static token buffer, written in place
        self.cur_token = self.graph.token
        #: the decode position on the host; each step copies it into the
        #: graph's position buffer
        self.pos = 0
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self._next_rid = 0

    # -- public API -------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid=rid, prompt=list(prompt),
                                  max_new=max_new))
        return rid

    def step(self) -> int:
        """Admit queued work, decode one token for every active slot.
        Returns the number of active sequences."""
        self._admit()
        n_decode = sum(r is not None for r in self.active)
        if not n_decode:
            return 0
        t0 = time.perf_counter()
        try:
            logits = self.graph(self.pos)
        except Exception as e:
            # surface the failure with the affected request identities
            # (same terminal taxonomy as the executor, repro_torch.core.faults)
            rids = [r.rid for r in self.active if r is not None]
            raise ExecutionError(
                f"decode step failed for requests {rids}: "
                f"{type(e).__name__}: {e}") from e
        nxt = sample(logits, self.generator, self.temperature)
        self.cur_token.copy_(nxt)
        self.pos += 1
        toks = nxt.tolist()
        if self.on_step is not None:
            self.on_step("decode", n_decode, time.perf_counter() - t0, logits)
        n_active = 0
        for i, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(toks[i]))
            if req.done:
                self.finished.append(req)
                self.active[i] = None
            else:
                n_active += 1
        return n_active

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
        return self.finished

    # -- internals --------------------------------------------------------------
    def _admit(self) -> None:
        """Prefill queued requests into free slots (batch=1 prefill, then
        splice the slot's cache rows into the shared decode cache)."""
        for i in range(self.slots):
            if self.active[i] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            t0 = time.perf_counter()
            prompt = torch.tensor(req.prompt, dtype=torch.long,
                                  device=self.device)[None]
            logits, c1 = self.prefill_graphs(prompt)
            _splice(self.cache, c1, i, self._batch_dims)
            first = greedy(logits)[0]
            token = int(first)
            if self.on_step is not None:
                self.on_step("prefill", len(req.prompt),
                             time.perf_counter() - t0, logits)
            self.cur_token[i] = first
            self.pos = max(self.pos, len(req.prompt))
            req.out.append(token)
            if req.done:
                self.finished.append(req)
            else:
                self.active[i] = req


def batch_dims(cfg: ModelConfig, capacity: int) -> Dict[str, int]:
    """Each cache key's batch dim: where its shapes at batch 1 and at batch
    2 differ.  (The reference looks for a dim where the prefill tensor is 1
    and the pool's is not, which a pool of one slot does not have.)"""
    one, two = cache_defs(cfg, 1, capacity), cache_defs(cfg, 2, capacity)
    return {k: next(d for d, (a, b) in enumerate(zip(one[k], two[k]))
                    if a != b) for k in one}


def _splice(cache: Cache, one: Cache, slot: int,
            bdims: Dict[str, int]) -> Cache:
    """Insert a batch-1 prefill cache into slot ``slot`` of the pool cache,
    in place.

    Pool and prefill caches share keys and rank; ``bdims`` gives each
    key's batch dim (:func:`batch_dims`).  Shorter seq dims (prefill
    capacity < pool capacity) are zero-padded at the tail.
    """
    for k, v in cache.items():
        src = one[k].to(v.dtype)
        bdim = bdims[k]
        pads = []
        for d in reversed(range(src.ndim)):
            pads += [0, 0 if d == bdim else v.shape[d] - src.shape[d]]
        if any(pads):
            src = F.pad(src, pads)
        v.narrow(bdim, slot, 1).copy_(src)
    return cache
