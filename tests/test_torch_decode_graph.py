"""The decode step with its position on the device, on the CPU.

``decode_step`` takes its position as a Python int or as a 0-d integer
tensor, as the JAX step takes a traced scalar; the tensor path is the one
a CUDA graph captures (``repro_torch.runtime.graphs.DecodeGraph``, which
on the CPU runs it eagerly).  Here the two paths are held to each other
bit for bit, logits and every cache entry after every step, for each
family at its smoke size (bf16 parameters from generator seed 0, as
served): hybrid, moe, ssm and dense stacks, gemma2's local/global pairs
before, across and past their 16-row rolling window, mixtral's windowed
MoE, internvl2 after frontend embeddings, whisper with its learned
positions.  Positions past the cache's rows and past the learned table's
end clamp on the device as the int path clamps on the host, and both as
the JAX package clamps (float32 parameters carried across from
``repro.models.init_tree``; decode logits to ``DECODE`` = 1e-3, as
``tests/test_torch_families.py`` sets it).  The sharded step refuses a
tensor position.  The engine's greedy tokens through this path are held
to the JAX engine's by the existing engine tests (``test_torch_lm.py``,
``test_torch_moe.py``, ``test_torch_families.py``); the graph itself, on
the card, by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_smoke as jget_smoke
from repro.models import decode_step as jdecode_step
from repro.models import init_tree, model_defs
from repro.models import prefill as jprefill
from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.models import LM, decode_step, from_jax_params, prefill
from repro_torch.models import spmd
from repro_torch.models.attention import decode_sharded, update_cache
from repro_torch.models.lm import _learned_positions
from repro_torch.runtime import DecodeGraph, ServeEngine

torch.set_num_threads(1)

DECODE = 1e-3
CAPACITY, BATCH, STEPS = 32, 2, 4


def tokens(n, vocab, seed=0, batch=BATCH):
    return np.random.default_rng(seed).integers(0, vocab, (batch, n))


def extras_for(cfg, batch, dtype=torch.bfloat16):
    """internvl2's frontend embeddings, whisper's frames (seed 7)."""
    g = torch.Generator().manual_seed(7)
    if cfg.enc_dec:
        return {"frames": torch.randn((batch, cfg.enc_frames, cfg.d_model),
                                      generator=g).to(dtype)}
    if cfg.frontend_positions:
        return {"frontend_embeds": torch.randn(
            (batch, cfg.frontend_positions, cfg.d_model),
            generator=g).to(dtype)}
    return {}


_MODELS = {}


def served(arch):
    """The arch's smoke model in bf16, random weights from seed 0."""
    if arch not in _MODELS:
        cfg = configs.get_smoke(arch)
        _MODELS[arch] = LM(cfg, generator=torch.Generator().manual_seed(0))
    return _MODELS[arch]


def prefilled(arch, prompt):
    model = served(arch)
    cfg = model.cfg
    toks = torch.from_numpy(tokens(prompt, cfg.vocab, seed=prompt))
    logits, cache = prefill(model, toks, capacity=CAPACITY,
                            **extras_for(cfg, BATCH))
    return model, logits, cache


def assert_same_cache(got, want, what):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (what, k)
        assert torch.equal(got[k], want[k]), (what, k)


# (arch, prompt length): the decode positions are prompt .. prompt + 3
CASES = [("zamba2-2.7b", 20), ("granite-moe-3b-a800m", 20),
         ("mamba2-1.3b", 20), ("minicpm-2b", 20), ("nemotron-4-15b", 20),
         ("command-r-plus-104b", 20), ("internvl2-26b", 20),
         ("whisper-large-v3", 20),
         # gemma2's local cache rolls over 16 rows: before the window,
         # across its end (positions 14-17) and past it; mixtral's window
         # of 16 at capacity 32 rolls the same way
         ("gemma2-2b", 8), ("gemma2-2b", 14), ("gemma2-2b", 24),
         ("mixtral-8x22b", 14), ("mixtral-8x22b", 24)]


@pytest.mark.parametrize("arch,prompt", CASES)
def test_tensor_position_matches_int_bit_for_bit(arch, prompt):
    model, logits, cache = prefilled(arch, prompt)
    at_int = {k: v.clone() for k, v in cache.items()}
    at_tensor = {k: v.clone() for k, v in cache.items()}
    tok = torch.argmax(logits, -1)
    for i in range(STEPS):
        pos = prompt + i
        want, _ = decode_step(model, at_int, tok, pos)
        got, _ = decode_step(model, at_tensor, tok, torch.tensor(
            pos, dtype=torch.int32 if i % 2 else torch.int64))
        assert torch.equal(got, want), (arch, pos)
        assert_same_cache(at_tensor, at_int, (arch, pos))
        tok = torch.argmax(want, -1)
    if model.cfg.local_global_pattern and prompt + STEPS > 16:
        # the rolling local cache was written where the window wraps
        assert not torch.equal(at_int["k_local"], cache["k_local"])


def test_decode_graph_on_the_cpu_is_the_eager_tensor_step():
    """No graph on the CPU: a call copies the token and position into the
    static buffers and runs the tensor-position step over the graph's
    cache, so it gives the int path's logits and cache; the engine writes
    its tokens into the same buffer."""
    arch, prompt = "zamba2-2.7b", 20
    model, logits, cache = prefilled(arch, prompt)
    want_cache = {k: v.clone() for k, v in cache.items()}
    graph = DecodeGraph(model, cache, BATCH)
    assert graph.cuda_graph is None and graph.token.shape == (BATCH,)
    tok = torch.argmax(logits, -1)
    for i in range(STEPS):
        want, _ = decode_step(model, want_cache, tok, prompt + i)
        got = graph(prompt + i, tok)
        assert torch.equal(got, want)
        assert torch.equal(graph.token, tok) and int(graph.pos) == prompt + i
        assert_same_cache(cache, want_cache, i)
        tok = torch.argmax(want, -1)
    engine = ServeEngine(model.cfg, model, slots=2, capacity=CAPACITY,
                         device="cpu")
    assert engine.cur_token is engine.graph.token
    assert engine.graph.cache is engine.cache


def test_launch_counts_taken_back_and_added_per_replay():
    """The capture's launches are taken back and each replay adds them
    again, so a counter reads the launches that ran."""
    a, b = _build.LaunchCounter("test/a"), _build.LaunchCounter("test/b")
    b.add(5)
    before = _build.launch_counts()
    a.add()
    a.add()
    b.add()
    captured = _build.counted_since(before)
    assert captured == {a: 2, b: 1}
    _build.add_counts(captured, sign=-1)
    assert (a.value, b.value) == (0, 5)
    for _ in range(3):
        _build.add_counts(captured)
    assert (a.value, b.value) == (6, 8)


@pytest.mark.parametrize("window,pos,row", [
    (None, 7, 7), (None, 40, 15), (None, -3, 0),
    (16, 17, 1), (16, 47, 15), (16, -1, 15)])
def test_cache_write_reduces_and_clamps_on_the_device(window, pos, row):
    """A rolling cache (its rows the window) writes at pos mod rows, any
    other at pos clamped into its rows; the tensor position writes the row
    the int position writes."""
    g = torch.Generator().manual_seed(1)
    k = torch.randn((2, 1, 2, 4), generator=g).to(torch.bfloat16)
    v = torch.randn((2, 1, 2, 4), generator=g).to(torch.bfloat16)
    caches = []
    for p in (pos, torch.tensor(pos)):
        kc = torch.zeros((2, 16, 2, 4), dtype=torch.bfloat16)
        vc = torch.zeros_like(kc)
        update_cache(kc, vc, k, v, p, window=window)
        caches.append((kc, vc))
    (ki, vi), (kt, vt) = caches
    assert torch.equal(kt, ki) and torch.equal(vt, vi)
    assert torch.equal(ki[:, row], k[:, 0]) and torch.equal(vi[:, row],
                                                            v[:, 0])
    assert int((ki != 0).any(-1).any(-1).any(0).sum()) == 1


@pytest.mark.parametrize("pos", [0, 5, 127, 128, 200])
def test_learned_positions_clamp_on_the_device(pos):
    model = served("whisper-large-v3")
    want = _learned_positions(model, pos, 1)
    got = _learned_positions(model, torch.tensor(pos), 1)
    assert torch.equal(got, want)
    assert torch.equal(_learned_positions(model, torch.tensor(pos), 3),
                       _learned_positions(model, pos, 3))


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


def as_port_cache(jc):
    return {k: torch.from_numpy(np.array(np.asarray(v, dtype=np.float32)))
            .to(torch.float32 if k == "h" else torch.bfloat16)
            for k, v in jc.items()}


@pytest.mark.parametrize("arch,pos", [
    ("minicpm-2b", 31), ("minicpm-2b", 40),      # the last row, past it
    ("zamba2-2.7b", 45), ("gemma2-2b", 45),
    ("whisper-large-v3", 127), ("whisper-large-v3", 200)])
def test_clamps_past_the_end_as_jax(jax_pair, arch, pos):
    """A step at a position past the cache's rows writes its last row
    (``dynamic_update_slice`` clamps the start), and whisper's past its
    128-row table reads the table's last row: the tensor position's step
    from the JAX prefill's cache bits matches the JAX step there."""
    cfg, params, model = jax_pair(arch)
    toks = tokens(24, cfg.vocab, seed=3, batch=1)
    fr = extras_for(cfg, 1, torch.float32).get("frames")
    jx = {} if fr is None else {"frames": jnp.asarray(fr.numpy())}
    _, jc = jprefill(params, cfg, jnp.asarray(toks), capacity=CAPACITY, **jx)
    tok = np.array([3])
    jl, jc2 = jdecode_step(params, cfg, jc, jnp.asarray(tok),
                           jnp.asarray(pos))
    at_int = as_port_cache(jc)
    at_tensor = as_port_cache(jc)
    want, _ = decode_step(model, at_int, torch.from_numpy(tok), pos)
    got, _ = decode_step(model, at_tensor, torch.from_numpy(tok),
                         torch.tensor(pos))
    assert torch.equal(got, want)
    assert_same_cache(at_tensor, at_int, pos)
    assert_allclose(got.numpy(), np.asarray(jl), rtol=DECODE, atol=DECODE)
    key = "k_global" if "k_global" in jc else "k"
    # the JAX step and the port's wrote the same row: the last one
    for after in (np.asarray(jc2[key], np.float32),
                  at_int[key].float().numpy()):
        assert written_rows(np.asarray(jc[key], np.float32), after) == \
            [min(pos, CAPACITY - 1)]


def written_rows(before, after):
    """The rows (dim 2 of a (layers, B, rows, KV, hd) cache) that differ."""
    diff = np.abs(after - before).reshape(*before.shape[:3], -1)
    return np.flatnonzero(diff.max(-1).max(0).max(0)).tolist()


def test_the_sharded_step_refuses_a_tensor_position(monkeypatch):
    """The sharded decode step takes an int: a tensor is refused before
    anything reads it, in ``decode_step``'s sharded branch and in
    ``decode_sharded`` itself."""
    model = served("minicpm-2b")
    p = model.layers[0]["attn"]
    h = torch.zeros((1, 1, model.cfg.d_model), dtype=torch.bfloat16)
    kc = torch.zeros((1, 8, model.cfg.n_kv_heads, model.cfg.head_dim),
                     dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="Python int"):
        decode_sharded(None, h, p, model.cfg, k_cache=kc, v_cache=kc,
                       cache_kind="all", n_rows=8, pos=torch.tensor(3),
                       window=None)
    monkeypatch.setattr(spmd, "is_sharded", lambda t: True)
    with pytest.raises(TypeError, match="Python int"):
        decode_step(model, {}, torch.zeros(1, dtype=torch.long),
                    torch.tensor(3))
