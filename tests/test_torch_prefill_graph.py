"""The prefill as one CUDA graph per prompt length, on the CPU.

``PrefillGraphs`` (``repro_torch.runtime.graphs``) is the counterpart of
the JAX engine's ``jax.jit`` over ``_prefill1``: one program for each
prompt shape.  A length's first prefill runs eagerly into a fresh cache;
on the card its second is captured, into one static batch-1 cache and
logits buffer that every length's graph shares, and replayed, as is
every later one.  On the CPU a length's later calls run the same prefill
eagerly into the same static outputs, so these tests run the code the
card captures.

Held here, for each family at its smoke size (bf16 parameters from
generator seed 0, as served): hybrid, moe, ssm and dense stacks, gemma2's
local/global pairs and mixtral's windowed MoE with the long prompt past
their 16-row window, internvl2 without frontend embeddings.  Prompts of
long, short, long, short and long lengths through one holder (each
length's first call eager, the later ones into the static outputs) give,
call by call, logits and every cache entry bit-identical to a fresh
eager ``prefill``: nothing of a longer prompt is left in the static
cache.  A prompt past the capacity does what the eager prefill does.  The engine's greedy
tokens through the holder equal the JAX engine's (float32 parameters
carried across by ``from_jax_params``), each prefill's logits within
``F32`` = 2e-4 of the JAX ``_prefill1``'s (the same function summed in
another order, as ``tests/test_torch_lm.py`` sets it), with the JAX run's
top-2 logit gap above ``DECODE`` = 1e-3 at every step, so no token rests
on a near tie.  The graphs themselves, on the card, are held by
``tests/test_torch_cuda.py`` (``-k prefill_graph``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_smoke as jget_smoke
from repro.models import init_tree, model_defs
from repro.runtime import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.models import LM, from_jax_params, prefill
from repro_torch.runtime import PrefillGraphs, ServeEngine

torch.set_num_threads(1)

F32 = 2e-4
DECODE = 1e-3
CAPACITY = 32

_MODELS = {}


def served(arch):
    """The arch's smoke model in bf16, random weights from seed 0."""
    if arch not in _MODELS:
        cfg = configs.get_smoke(arch)
        _MODELS[arch] = LM(cfg, generator=torch.Generator().manual_seed(0))
    return _MODELS[arch]


def prompt(n, vocab, seed=None):
    return torch.from_numpy(np.random.default_rng(
        n if seed is None else seed).integers(0, vocab, (1, n)))


def assert_same_cache(got, want, what):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        assert torch.equal(got[k], want[k]), (what, k)


# (arch, prompt lengths (long, short, long)): through one holder they run
# long, short (each a first call), long, short, long.  The long
# prompts run past the 16-row window of gemma2's local layers and of
# mixtral; the SSM stacks' (chunk 16) prompts have ragged tails, and their
# second case a whole number of chunks around a prompt shorter than the
# conv kernel
CASES = [("zamba2-2.7b", (28, 9, 28)), ("zamba2-2.7b", (32, 2, 32)),
         ("granite-moe-3b-a800m", (28, 9, 28)),
         ("mamba2-1.3b", (28, 9, 28)), ("mamba2-1.3b", (32, 2, 32)),
         ("minicpm-2b", (28, 9, 28)), ("gemma2-2b", (28, 9, 28)),
         ("mixtral-8x22b", (28, 9, 28)), ("internvl2-26b", (28, 9, 28))]


@pytest.mark.parametrize("arch,lengths", CASES)
def test_long_short_long_bit_identical_to_a_fresh_prefill(arch, lengths):
    model = served(arch)
    graphs = PrefillGraphs(model, CAPACITY)
    assert graphs.pool is None
    for i, n in enumerate((*lengths, lengths[1], lengths[0])):
        toks = prompt(n, model.cfg.vocab, seed=i)
        logits, cache = graphs(toks)
        want_logits, want_cache = prefill(model, toks, capacity=CAPACITY)
        static = logits is graphs.logits and cache is graphs.cache
        assert static == (i >= 2), (arch, i, n)
        assert torch.equal(logits, want_logits), (arch, i, n)
        assert_same_cache(cache, want_cache, (arch, i, n))
    seen = graphs.lengths
    assert sorted(seen) == sorted(set(lengths))
    assert all(s.graph is None and s.capture_s is None
               for s in seen.values())
    assert seen[lengths[0]].calls == 3 and seen[lengths[0]].replays == 2
    assert seen[lengths[1]].calls == 2 and seen[lengths[1]].replays == 1
    assert tuple(seen[lengths[0]].tokens.shape) == (1, lengths[0])
    assert graphs.static_bytes() > 0


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "mamba2-1.3b", "gemma2-2b",
                                  "mixtral-8x22b"])
def test_a_prompt_past_the_capacity_as_the_eager_prefill(arch):
    """40 tokens at capacity 32: the eager prefill keeps the first 32 rows
    of a full-attention layer's k/v (the window's last 16 in a rolling
    cache), and the holder the same, eagerly and into its static cache,
    before and after a shorter prompt."""
    model = served(arch)
    graphs = PrefillGraphs(model, CAPACITY)
    for i, n in enumerate((40, 12, 40, 12, 40)):
        toks = prompt(n, model.cfg.vocab, seed=i)
        want_logits, want_cache = prefill(model, toks, capacity=CAPACITY)
        logits, cache = graphs(toks)
        assert torch.equal(logits, want_logits), (arch, n)
        assert_same_cache(cache, want_cache, (arch, n))
    assert all(v.shape[2] <= CAPACITY for k, v in graphs.cache.items()
               if k.startswith(("k", "v")))


def test_the_holder_takes_one_prompt_at_a_time():
    model = served("minicpm-2b")
    graphs = PrefillGraphs(model, CAPACITY)
    with pytest.raises(ValueError, match="batch-1"):
        graphs(torch.zeros((2, 8), dtype=torch.long))
    with pytest.raises(ValueError, match="batch-1"):
        graphs(torch.zeros(8, dtype=torch.long))
    assert not graphs.lengths


@pytest.fixture(scope="module")
def jax_pair():
    """(JAX config, JAX float32 parameters, the port's model of them) by
    arch, made on first use."""
    made = {}

    def get(arch):
        if arch not in made:
            cfg = jget_smoke(arch)
            params = init_tree(jax.random.PRNGKey(0), model_defs(cfg),
                               dtype=jnp.float32)
            made[arch] = (cfg, params, from_jax_params(
                configs.get_smoke(arch), jax.device_get(params)))
        return made[arch]
    return get


def _jax_engine_run(cfg, params, prompts):
    """The JAX engine's greedy tokens by request, each prefill's logits,
    and whether every logit vector it sampled from has a top-2 gap above
    DECODE."""
    eng = JServeEngine(cfg, params, slots=2, capacity=CAPACITY,
                       temperature=0.0)
    prefills, seen = [], []

    def record(fn, store):
        def wrapped(*args):
            logits, cache = fn(*args)
            store.append(np.asarray(logits, dtype=np.float32))
            return logits, cache
        return wrapped

    eng._prefill1 = record(eng._prefill1, prefills)
    eng._decode = record(eng._decode, seen)
    for p in prompts:
        eng.submit(p, max_new=4)
    out = {r.rid: r.out for r in eng.run_to_completion()}
    top2 = [np.sort(lg, axis=-1)[..., -2:] for lg in prefills + seen]
    return out, prefills, all((t[..., 1] - t[..., 0] > DECODE).all()
                              for t in top2)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-moe-3b-a800m",
                                  "mamba2-1.3b", "gemma2-2b"])
def test_engine_through_the_holder_matches_the_jax_engine(jax_pair, arch):
    """Four requests of two prompt lengths through two slots: the first
    two are each a length's first prefill (eager), the last two repeat
    those lengths (a capture and its replay on the card).  The same greedy tokens as the JAX
    engine, each prefill's logits within F32 of the JAX ``_prefill1``'s.
    The prompts are the first draw (seeds 5, 6, ...) on which the JAX run
    meets no near tie; the port's run has no say in that choice."""
    cfg, params, model = jax_pair(arch)
    for seed in range(5, 10):
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab, n).tolist()
                   for n in (24, 9, 24, 9)]
        want, want_prefills, clear = _jax_engine_run(cfg, params, prompts)
        if clear:
            break
    assert clear, "every draw met a near tie"
    got_prefills = []
    teng = ServeEngine(model.cfg, model, slots=2, capacity=CAPACITY,
                       temperature=0.0, device="cpu",
                       on_step=lambda kind, n, s, logits: got_prefills.append(
                           logits.numpy().copy()) if kind == "prefill"
                       else None)
    for p in prompts:
        teng.submit(p, max_new=4)
    got = {r.rid: r.out for r in teng.run_to_completion()}
    assert len(want) == 4 and all(len(o) == 4 for o in want.values())
    assert got == want
    assert len(got_prefills) == len(want_prefills) == 4
    for g, w in zip(got_prefills, want_prefills):
        assert_allclose(g, w, rtol=F32, atol=F32)
    seen = teng.prefill_graphs.lengths
    assert sorted(seen) == [9, 24]
    assert [seen[n].replays for n in (24, 9)] == [1, 1]
    assert all(s.graph is None for s in seen.values())
