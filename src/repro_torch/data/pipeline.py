"""Synthetic LM token pipeline — deterministic, stateless, shard-resumable.

The port's counterpart of the JAX package's ``data/pipeline.py``, bit for
bit: the batch for step ``s`` is a pure function of ``(seed, s)``, drawn
with the JAX package's random numbers.  Those are JAX's threefry2x32
counter-based generator, which this module carries in numpy (uint32
words), so the port needs no JAX: ``PRNGKey``, ``fold_in``, ``uniform``
(the top 23 bits as a float32 mantissa in [1, 2), minus 1) and
``randint``'s two-word construction, with the bit layout of JAX's
``jax_threefry_partitionable=True`` (the default since JAX 0.5): element
``i`` of a draw hashes the 64-bit counter ``i`` split into two words, and
a ``split`` is the same hash of the counters 0..n-1.

Token distribution: Zipfian over the vocabulary with a per-sequence
"document id" successor rule, labels = tokens shifted by one, the last
position masked with -1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

_U32 = np.uint32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1     # 0 = uniform
    # markov structure: next token correlates with the previous one
    markov_strength: float = 0.7


# ---------------------------------------------------------------------------
# threefry2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
# 3"), 20 rounds, as JAX computes it
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 hash of the counter words (x0, x1) under ``key``."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x0, dtype=_U32) + ks[0], np.asarray(x1, dtype=_U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` in JAX's default 32-bit mode: a zero
    high word and the seed's low 32 bits."""
    return 0, int(seed) & 0xFFFFFFFF


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in``: the hash of the counter (0, data)."""
    a, b = threefry2x32(key, np.zeros(1, _U32),
                        np.array([int(data) & 0xFFFFFFFF], _U32))
    return int(a[0]), int(b[0])


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(_U32), i.astype(_U32)


def split(key: Tuple[int, int], n: int = 2):
    """``jax.random.split`` (partitionable): key i hashes the counter i."""
    a, b = threefry2x32(key, *_counters(n))
    return [(int(a[i]), int(b[i])) for i in range(n)]


def random_bits(key: Tuple[int, int], shape) -> np.ndarray:
    """32 random bits a element (partitionable): the two words of the hash
    of each element's flat index, xor-ed."""
    a, b = threefry2x32(key, *_counters(int(np.prod(shape))))
    return (a ^ b).reshape(shape)


def uniform(key: Tuple[int, int], shape) -> np.ndarray:
    """``jax.random.uniform`` in [0, 1), float32."""
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def randint(key: Tuple[int, int], shape, minval: int, maxval: int
            ) -> np.ndarray:
    """``jax.random.randint`` for int32 in [minval, maxval): two words of
    bits from the key's split, combined modulo the span in uint32."""
    k1, k2 = split(key, 2)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = max(maxval - minval, 1)
    m = 2 ** 16 % span
    mult = _U32((m * m & 0xFFFFFFFF) % span)      # the square wraps in uint32
    span = _U32(span)
    with np.errstate(over="ignore"):
        off = ((hi % span) * mult + lo % span) % span
    return (minval + off.astype(np.int64)).astype(np.int32)


# ---------------------------------------------------------------------------
# the batches
# ---------------------------------------------------------------------------

def _zipf_cdf(vocab: int, alpha: float) -> np.ndarray:
    if alpha <= 0:
        return np.linspace(1.0 / vocab, 1.0, vocab)
    w = 1.0 / np.arange(1, vocab + 1, dtype=np.float64) ** alpha
    return np.cumsum(w / w.sum())


def batch_at(cfg: DataConfig, step: int) -> Dict[str, torch.Tensor]:
    """Global batch for one step: {'tokens': (B,S) int32, 'labels': (B,S)
    int32}, CPU tensors.  labels[i, t] = tokens[i, t+1]; the final position
    is -1 (ignored by the loss)."""
    key = fold_in(prng_key(cfg.seed), step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    cdf = _zipf_cdf(V, cfg.zipf_alpha).astype(np.float32)
    u = uniform(key, (B, S + 1))
    base = np.searchsorted(cdf, u, side="left").astype(np.int32)
    if cfg.markov_strength > 0:
        keep = uniform(fold_in(key, 1), (B, S + 1)) \
            < np.float32(cfg.markov_strength)
        doc = randint(fold_in(key, 2), (B, 1), 0, 97)
        prev = np.roll(base, 1, axis=1)
        succ = (prev * 31 + doc).astype(np.int32) % np.int32(V)
        toks = np.where(keep, succ, base)
    else:
        toks = base
    tokens = toks[:, :S]
    labels = np.where(np.arange(S)[None] == S - 1, -1, toks[:, 1:S + 1])
    return {"tokens": torch.from_numpy(np.ascontiguousarray(tokens)),
            "labels": torch.from_numpy(labels.astype(np.int32))}


def host_shard_batch(cfg: DataConfig, step: int, *, host_index: int,
                     host_count: int) -> Dict[str, torch.Tensor]:
    """This host's slice of the step's global batch (batch-dim
    contiguous)."""
    if cfg.global_batch % host_count:
        raise ValueError(f"global_batch {cfg.global_batch} not divisible by "
                         f"host_count {host_count}")
    per = cfg.global_batch // host_count
    full = batch_at(cfg, step)
    lo = host_index * per
    return {k: v[lo:lo + per] for k, v in full.items()}


class SyntheticLM:
    """Iterator facade with a checkpointable cursor (just the step index)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = batch_at(self.cfg, self.step)
        self.step += 1
        return b

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        self.step = int(d["step"])
