"""The port's ssm, dense, local/global, VLM and mixtral configurations
against the JAX package on the CPU: each smoke configuration (mamba2,
minicpm, gemma2, nemotron, internvl2, command-r-plus, mixtral) with float32
parameters made by ``repro.models.init_tree`` (seed 0) and carried across
by ``from_jax_params``, on the same numpy tokens.  The step-1 gradients,
three AdamW steps, microbatches, remat, the int8 step and the launcher of
these configurations are held to the JAX package in
``tests/test_torch_train.py`` (its ``ARCHS``), their checkpoints in
``tests/test_torch_checkpoint.py``.

Every prompt of 24 tokens runs past the 16-token window of gemma2's local
layers and of mixtral at capacity 32: prefill masks in attention and packs
a rolling cache, decode reads it under the window.  mamba2's 24 tokens are
a chunk of 16 and a ragged tail.  internvl2 takes (1, 8, 64) frontend
embeddings through prefill and through the loss.

Tolerances, as ``tests/test_torch_lm.py`` and ``tests/test_torch_train.py``
set them, each with its reason:
- float32 activations (forward and prefill logits, the SSM state):
  ``F32`` = 2e-4, the same function summed in another order;
- tensors the cache stores in bf16 (k, v, conv buffers): ``BF16`` = 2e-2
  with rtol 1e-2 (float32 values a few 1e-6 apart may round to
  neighbouring bf16 numbers);
- decode logits, which read those bf16 rows: ``DECODE`` = 1e-3;
- greedy tokens: identical, with the JAX run's top-2 logit gap above
  ``DECODE`` at every step, so no comparison rests on a near tie;
- gradients through the frontend: max |port - JAX| <= 1e-4 max |JAX|
  + 1e-7 per leaf, the loss at rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import arch_names as jarch_names
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import decode_step as jdecode_step
from repro.models import forward_train as jforward_train
from repro.models import init_tree, model_defs
from repro.models import prefill as jprefill
from repro.models.layers import ParamDef as JParamDef
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import ServeEngine as JServeEngine
from repro.runtime import make_loss_fn as jmake_loss_fn
from repro_torch import configs
from repro_torch.checkpoint import named_to_tree
from repro_torch.models import (LM, cache_defs, decode_step, from_jax_params,
                                prefill)
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig
from repro_torch.models.lm import _check_family, forward_train
from repro_torch.optim import param_path
from repro_torch.runtime import (RuntimeConfig, ServeEngine, make_loss_fn,
                                 make_prefill_step)
from repro_torch.runtime.train import trainable

torch.set_num_threads(1)

F32 = 2e-4
BF16 = 2e-2
DECODE = 1e-3
ARCHS = ("mamba2-1.3b", "minicpm-2b", "gemma2-2b", "nemotron-4-15b",
         "internvl2-26b", "command-r-plus-104b", "mixtral-8x22b")
PROMPT, CAPACITY, DECODE_STEPS = 24, 32, 3


def np32(a):
    return np.asarray(a, dtype=np.float32)


def tokens(n, vocab, seed=0, batch=1):
    return np.random.default_rng(seed).integers(0, vocab, (batch, n))


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """An arch's smoke config, its JAX parameters and the port's model
    holding them."""
    cfg = jget_smoke(request.param)
    params = init_tree(jax.random.PRNGKey(0), model_defs(cfg),
                       dtype=jnp.float32)
    tcfg = configs.get_smoke(request.param)
    model = from_jax_params(tcfg, jax.device_get(params))
    return dict(name=request.param, cfg=cfg, params=params, tcfg=tcfg,
                model=model)


def close_cache(got, want):
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        tol = (dict(rtol=F32, atol=F32) if k == "h"
               else dict(rtol=1e-2, atol=BF16))
        assert_allclose(got[k].float().numpy(), np32(want[k]), err_msg=k,
                        **tol)


def _port_config(jcfg) -> ModelConfig:
    """The JAX package's config as the port's dataclass, field for field."""
    kw = {f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__}
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**vars(jcfg.moe))
    if jcfg.ssm is not None:
        kw["ssm"] = SSMConfig(**vars(jcfg.ssm))
    return ModelConfig(**kw)


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_configs_are_the_jax_packages_field_for_field(name):
    for get, jget in ((configs.get_config, jget_config),
                      (configs.get_smoke, jget_smoke)):
        got, want = get(name), jget(name)
        for f in ModelConfig.__dataclass_fields__:
            g, w = getattr(got, f), getattr(want, f)
            if dataclasses.is_dataclass(w):
                assert dataclasses.asdict(g) == dataclasses.asdict(w), f
            else:
                assert g == w, f
        assert got.param_count() == want.param_count()


def test_registry_holds_every_arch_but_the_encoder_decoder():
    """Since the encoder-decoder slice the registry holds every arch of the
    JAX package, whisper-large-v3 too, and each builds at full size on the
    meta device, the family check passing, with as many parameters as the
    JAX package's definitions hold."""
    assert configs.arch_names() and \
        set(configs.arch_names()) == set(jarch_names())
    for name in jarch_names():
        cfg = _port_config(jget_config(name))
        _check_family(cfg)
        model = LM(cfg, device="meta")
        defs = jax.tree.leaves(model_defs(jget_config(name)),
                               is_leaf=lambda d: isinstance(d, JParamDef))
        assert sum(p.numel() for p in model.parameters()) == \
            sum(int(np.prod(d.shape)) for d in defs), name


def test_local_global_pairs_keep_the_jax_paths():
    """gemma2's pair holds its blocks as ``local`` and ``global`` with
    nothing between, so each parameter's JAX path is layers/local/... or
    layers/global/..., stacked over the pairs."""
    cfg = configs.get_smoke("gemma2-2b")
    model = LM(cfg, dtype=torch.float32,
               generator=torch.Generator().manual_seed(0))
    names = [n for n, _ in model.named_parameters()
             if n.startswith("layers.")]
    assert {n.split(".")[2] for n in names} == {"local", "global"}
    assert param_path("layers.1.global.attn.wq") == "layers/global/attn/wq"
    assert model.layers[0].global_ is model.layers[0]._modules["global"]
    tree = named_to_tree(dict(model.named_parameters()))
    jdefs = model_defs(jget_smoke("gemma2-2b"))["layers"]
    for side in ("local", "global"):
        assert tuple(tree["layers"][side]["attn"]["wq"].shape) == \
            jdefs[side]["attn"]["wq"].shape


# ---------------------------------------------------------------------------
# forward, prefill, decode, the engine
# ---------------------------------------------------------------------------

def test_forward_matches_jax(fam):
    toks = tokens(40, fam["cfg"].vocab, seed=1, batch=2)
    want, _ = jforward_train(fam["params"], fam["cfg"], jnp.asarray(toks))
    got = fam["model"](torch.from_numpy(toks))
    assert_allclose(got.detach().numpy(), np.asarray(want), rtol=F32,
                    atol=F32)


def _as_port_cache(jc, like):
    """The JAX cache's values in the port's tensors' dtypes (the same
    bf16 bits)."""
    return {k: torch.from_numpy(np.array(np32(v))).to(like[k].dtype)
            for k, v in jc.items()}


def test_prefill_and_decode_match_jax(fam):
    """A 24-token prompt at capacity 32, then three decode steps, the
    cache compared key by key after each.  The first step reads the port's
    own prefill cache; the later ones read the JAX run's cache, carried
    across bit for bit: a row that the two prefills round to neighbouring
    bf16 numbers (0.1% of internvl2's, one step of 2^-6) moves a later
    step's logits by up to 1.8e-3 on its own, while from the same bits the
    two decode steps agree within 1e-5."""
    cfg, params, tcfg, model = (fam[k] for k in ("cfg", "params", "tcfg",
                                                 "model"))
    toks = tokens(PROMPT, cfg.vocab, seed=2)
    jl, jc = jprefill(params, cfg, jnp.asarray(toks), capacity=CAPACITY)
    tl, tc = prefill(model, torch.from_numpy(toks), capacity=CAPACITY)
    assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32, atol=F32)
    assert {k: tuple(v) for k, v in cache_defs(tcfg, 1, CAPACITY).items()} \
        == {k: v.shape for k, v in jc.items()}
    close_cache(tc, jc)
    tok = np.array(jnp.argmax(jl, -1))
    for i in range(DECODE_STEPS):
        if i:
            tc = _as_port_cache(jc, tc)
        jl, jc = jdecode_step(params, cfg, jc, jnp.asarray(tok),
                              jnp.asarray(PROMPT + i))
        tl, tc = decode_step(model, tc, torch.from_numpy(tok).long(),
                             PROMPT + i)
        assert_allclose(tl.numpy(), np.asarray(jl), rtol=DECODE,
                        atol=DECODE)
        close_cache(tc, jc)
        tok = np.array(jnp.argmax(jl, -1))


@pytest.mark.parametrize("name", ("gemma2-2b", "mixtral-8x22b"))
def test_windowed_caches_roll(name):
    """The prompt runs past the window, and the window-sized cache holds
    the last positions, rolled: position p in row p mod W."""
    tcfg = configs.get_smoke(name)
    W = tcfg.sliding_window
    assert PROMPT > W and CAPACITY > W
    model = LM(tcfg, dtype=torch.float32,
               generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(tokens(PROMPT, tcfg.vocab, seed=2))
    _, cache = prefill(model, toks, capacity=CAPACITY)
    key = "k_local" if tcfg.local_global_pattern else "k"
    assert cache[key].shape[2] == W
    _, full = prefill(model, toks, capacity=CAPACITY)
    # the first layer's keys depend only on the tokens: recompute them
    blk = model.layers[0].local if tcfg.local_global_pattern \
        else model.layers[0]
    from repro_torch.models.attention import qkv
    from repro_torch.models.layers import embed, rmsnorm
    h = rmsnorm(embed(toks, model.embed, tcfg), blk["ln1"]["scale"],
                tcfg.norm_eps)
    _, k, _ = qkv(h, blk["attn"], tcfg,
                  positions=torch.arange(PROMPT)[None])
    for p in range(PROMPT - W, PROMPT):
        torch.testing.assert_close(cache[key][0, 0, p % W],
                                   k[0, p].to(torch.bfloat16))


def _record(fn, store):
    def wrapped(*args, **kw):
        logits, cache = fn(*args, **kw)
        store.append(np32(logits))
        return logits, cache
    return wrapped


def _jax_engine_run(cfg, params, prompts):
    """The JAX engine's greedy tokens by request, and whether every logit
    vector it sampled from has a top-2 gap above DECODE."""
    eng = JServeEngine(cfg, params, slots=2, capacity=CAPACITY,
                       temperature=0.0)
    seen = []
    eng._prefill1 = _record(eng._prefill1, seen)
    eng._decode = _record(eng._decode, seen)
    for p in prompts:
        eng.submit(p, max_new=6)
    out = {r.rid: r.out for r in eng.run_to_completion()}
    top2 = [np.sort(lg, axis=-1)[..., -2:] for lg in seen]
    return out, all((t[..., 1] - t[..., 0] > DECODE).all() for t in top2)


def test_serve_engine_greedy_tokens_match_jax(fam):
    """Three requests through two slots (the third joins mid-flight), the
    longest past the window where there is one: the same greedy tokens
    from both engines.  The prompts are the first draw (seeds 5, 6, ...)
    on which the JAX run meets no near tie; the port's run has no say in
    that choice."""
    cfg, params, tcfg, model = (fam[k] for k in ("cfg", "params", "tcfg",
                                                 "model"))
    for seed in range(5, 10):
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab, n).tolist()
                   for n in (20, PROMPT, 9)]
        want, clear = _jax_engine_run(cfg, params, prompts)
        if clear:
            break
    assert clear, "every draw met a near tie"
    teng = ServeEngine(tcfg, model, slots=2, capacity=CAPACITY,
                       temperature=0.0, device="cpu")
    for p in prompts:
        teng.submit(p, max_new=6)
    got = {r.rid: r.out for r in teng.run_to_completion()}
    assert len(want) == 3 and all(len(o) == 6 for o in want.values())
    assert got == want


@pytest.mark.parametrize("name", ("gemma2-2b", "mamba2-1.3b"))
def test_serve_engine_takes_one_slot(name):
    """A pool of one slot (the reference's splice finds no batch dim
    there): each request in turn gives the tokens it gives in a pool of
    two."""
    cfg = configs.get_smoke(name)
    model = LM(cfg, dtype=torch.float32,
               generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (PROMPT, 9)]
    outs = []
    for slots in (1, 2):
        eng = ServeEngine(cfg, model, slots=slots, capacity=CAPACITY,
                          temperature=0.0, device="cpu")
        got = {}
        for p in prompts:              # one at a time: no shared position
            eng.submit(p, max_new=5)
            got.update({r.rid: r.out for r in eng.run_to_completion()})
        outs.append(got)
    assert outs[0] == outs[1] and len(outs[0]) == 2


# ---------------------------------------------------------------------------
# the VLM frontend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm():
    name = "internvl2-26b"
    cfg = jget_smoke(name)
    params = init_tree(jax.random.PRNGKey(0), model_defs(cfg),
                       dtype=jnp.float32)
    model = from_jax_params(configs.get_smoke(name), jax.device_get(params))
    fe = np.random.default_rng(7).standard_normal(
        (1, cfg.frontend_positions, cfg.d_model)).astype(np.float32)
    assert fe.shape == (1, 8, 64)
    return cfg, params, model, fe


def test_vlm_frontend_embeds_through_prefill(vlm):
    """``frontend_embeds`` replace the first 8 positions in prefill, through
    ``make_prefill_step`` as in the reference; without them the logits
    differ."""
    cfg, params, model, fe = vlm
    toks = tokens(PROMPT, cfg.vocab, seed=3)
    jl, jc = jprefill(params, cfg, jnp.asarray(toks), capacity=CAPACITY,
                      frontend_embeds=jnp.asarray(fe))
    step = make_prefill_step(model.cfg, CAPACITY)
    tl, tc = step(model, torch.from_numpy(toks),
                  frontend_embeds=torch.from_numpy(fe))
    assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32, atol=F32)
    close_cache(tc, jc)
    plain, _ = prefill(model, torch.from_numpy(toks), capacity=CAPACITY)
    assert np.abs(plain.numpy() - tl.numpy()).max() > 100 * F32
    logits, _ = forward_train(model, torch.from_numpy(toks),
                              frontend_embeds=torch.from_numpy(fe))
    assert_allclose(logits[:, -1].detach().numpy(), np.asarray(jl),
                    rtol=F32, atol=F32)


def test_vlm_frontend_embeds_through_the_loss(vlm):
    """The loss and its gradients with ``frontend_embeds`` as an extra of
    the batch, against the reference's ``loss_fn(params, tokens, labels,
    extras)``."""
    cfg, params, model, fe = vlm
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, (1, 33)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1
    toks = toks[:, :32]
    extras = {"frontend_embeds": fe}
    (_, (jloss, _)), jgrads = jax.jit(jax.value_and_grad(
        jmake_loss_fn(cfg, JRuntimeConfig(remat=None)), has_aux=True))(
        params, jnp.asarray(toks), jnp.asarray(labels),
        {k: jnp.asarray(v) for k, v in extras.items()})
    named = trainable(model)
    total, (loss, _) = make_loss_fn(model.cfg, RuntimeConfig(remat=None))(
        model, torch.from_numpy(toks), torch.from_numpy(labels),
        {k: torch.from_numpy(v) for k, v in extras.items()})
    gs = torch.autograd.grad(total, list(named.values()))
    for p in named.values():
        p.requires_grad_(False)
    assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = named_to_tree(dict(zip(named, gs)))

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np32(tree[k])

    want = dict(leaves(jax.device_get(jgrads)))
    mine = dict(leaves(got))
    assert mine.keys() == want.keys()
    for k, w in want.items():
        assert np.abs(mine[k] - w).max() <= 1e-4 * np.abs(w).max() + 1e-7, k
