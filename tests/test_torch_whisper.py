"""The port's encoder-decoder (whisper-large-v3) against the JAX package on
the CPU, at the smoke config (2 encoder + 2 decoder layers, d_model 64, 4
heads of 16, 8 frames, max_pos 128): float32 parameters made by
``repro.models.init_tree`` (seed 0) and carried across by
``from_jax_params``, tokens and frames made with numpy from a seed, the
JAX functions run as the JAX package's own tests run them (its attention
is the jnp oracle of the Pallas kernel; the port's is the kernel's plain
version on the CPU).

Tolerances, each with its reason:
- float32 activations (forward and prefill logits): ``F32`` = 2e-4, the
  same function summed in another order;
- tensors the cache stores in bf16 (k, v, xk, xv): 2e-2 absolute with
  rtol 1e-2 (float32 values a few 1e-6 apart may round to neighbouring
  bf16 numbers);
- float32 decode logits: the first step from the port's own prefill
  cache within ``DECODE`` = 1e-3 (a row rounded to the neighbouring bf16
  number moves them, as ``tests/test_torch_families.py`` measures); every
  step again from the JAX run's cache bits within ``SAME_BITS`` = 2e-5.
  That bound is what shows the two numerics traps of the JAX package
  (``test_float32_decode_shows_both_numerics_traps``): a decode step adds
  its learned position rounded to bf16 (left unrounded, the decode logits
  move by more than 3 x SAME_BITS), and the prefill's own cross-attention
  reads its keys and values in the model's dtype while the cache keeps
  them in bf16 (read in bf16, the prefill logits move by more than 3 x
  F32);
- bf16 runs: both packages round every op's output to bf16, in other
  orders, and at these random weights the attention is near argmax, where
  one rounding can flip which key wins; so the port's bf16 run is held to
  the JAX float32 run by relative L2, at most twice as far from it as the
  JAX bf16 run is (measured at the test's prompt, seed 2: at most 1.02
  times);
- the encoder's sinusoids: the angle's exponent, -ln(10^4) i / (half-1),
  bit for bit; the sines and cosines within 2^-22 (1 + |angle|).  They
  cannot be bit-exact: XLA's and PyTorch's CPU exp, sin and cos each round
  some values to the other neighbour of the exact result, and one unit in
  the last place of the exponential moves an angle by |angle| x 2^-24
  (~9e-5 near the encoder's last frame, 1499);
- gradients: per leaf max |port - JAX| <= 1e-4 max |JAX| + 1e-7 + e_JAX,
  where e_JAX is the JAX package's own float32 error against the port's
  float64 gradient, as ``tests/test_torch_train.py`` holds the other
  archs; the loss at rtol 1e-5;
- three train steps (microbatches 2, remat "dots"): losses at rtol 1e-4,
  AdamW eps 1e-3 as in ``tests/test_torch_train.py`` (there, why);
- checkpoints and the parameter round trip: equality.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import decode_step as jdecode_step
from repro.models import forward_train as jforward_train
from repro.models import init_tree, model_defs
from repro.models import lm as jlm
from repro.models import prefill as jprefill
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import init_state as jinit_state
from repro.runtime import make_loss_fn as jmake_loss_fn
from repro.runtime import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, named_to_tree,
                                    state_from_tree, state_to_tree,
                                    tree_to_named)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import (LM, cache_defs, decode_step, from_jax_params,
                                prefill)
from repro_torch.models import lm as tlm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamW, AdamWConfig, param_path, split_name
from repro_torch.runtime import (RuntimeConfig, ServeEngine, init_state,
                                 make_loss_fn, make_train_step)
from repro_torch.runtime.train import trainable
from test_torch_checkpoint import assert_same

torch.set_num_threads(1)

ARCH = "whisper-large-v3"
F32 = 2e-4
BF16 = 2e-2
DECODE = 1e-3
SAME_BITS = 2e-5
PROMPT, CAPACITY, DECODE_STEPS = 24, 32, 3
B, S = 4, 32
ADAM_EPS = 1e-3


def np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) \
        if not isinstance(a, torch.Tensor) else a.detach().float().numpy()


def frames(batch, seed=7, cfg=None):
    cfg = cfg or jget_smoke(ARCH)
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def tokens(n, vocab, seed=0, batch=1):
    return np.random.default_rng(seed).integers(0, vocab, (batch, n))


def train_batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1
    return toks[:, :S], labels


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k], dtype=np.float64)


def rel_l2(got, want):
    g, w = np32(got), np32(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.fixture(scope="module")
def whisper():
    cfg = jget_smoke(ARCH)
    params = init_tree(jax.random.PRNGKey(0), model_defs(cfg),
                       dtype=jnp.float32)
    tcfg = configs.get_smoke(ARCH)
    return cfg, params, tcfg, from_jax_params(tcfg, jax.device_get(params))


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def test_config_is_the_jax_packages_field_for_field():
    for get, jget in ((configs.get_config, jget_config),
                      (configs.get_smoke, jget_smoke)):
        got, want = get(ARCH), jget(ARCH)
        for f in ModelConfig.__dataclass_fields__:
            assert getattr(got, f) == getattr(want, f), f
        assert got.param_count() == want.param_count()
    full = configs.get_config(ARCH)
    assert (full.family, full.enc_dec, full.use_rope, full.max_pos) == \
        ("audio", True, False, 32768)
    model = LM(full, device="meta")
    assert tuple(model.pos_embed.shape) == (32768, 1280)
    assert len(model.encoder.layers) == len(model.layers) == 32


def test_parameters_round_trip_in_the_jax_layout(whisper):
    """Every parameter carried across lands where the JAX path says, and
    ``named_to_tree`` gives back the JAX tree bit for bit: the encoder's
    blocks under ``encoder/layers``, the decoder's cross-attention under
    ``layers/xattn`` and ``layers/ln_x``, ``pos_embed`` at the top."""
    cfg, params, tcfg, model = whisper
    named = dict(model.named_parameters())
    assert split_name("encoder.layers.1.attn.wq") == (
        ("encoder", "layers", "attn", "wq"), (1,))
    paths = {param_path(k) for k in named}
    assert {"pos_embed", "encoder/layers/attn/wq", "encoder/final_norm/scale",
            "layers/xattn/bq", "layers/ln_x/scale"} <= paths
    jtree = jax.device_get(params)
    assert_same(named_to_tree(named), jtree)
    back = tree_to_named(jtree, named)
    assert all(torch.equal(back[k], v) for k, v in named.items())
    assert sum(p.numel() for p in model.parameters()) == \
        sum(a.size for a in jax.tree.leaves(params))
    # a leaf missing or left over raises
    short = dict(jtree, encoder={"layers": jtree["encoder"]["layers"]})
    with pytest.raises(KeyError):
        from_jax_params(tcfg, short)
    with pytest.raises(KeyError, match="cross"):
        from_jax_params(tcfg, dict(jtree, cross=jtree["pos_embed"]))


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

def test_forward_matches_jax(whisper):
    cfg, params, tcfg, model = whisper
    toks, fr = tokens(40, cfg.vocab, seed=1, batch=2), frames(2)
    want, jaux = jforward_train(params, cfg, jnp.asarray(toks),
                                frames=jnp.asarray(fr))
    got, aux = tlm.forward_train(model, torch.from_numpy(toks),
                                 frames=torch.from_numpy(fr))
    assert_allclose(np32(got), np.asarray(want), rtol=F32, atol=F32)
    assert float(aux) == float(jaux) == 0.0


def test_the_encoder_needs_its_frames(whisper):
    model = whisper[3]
    toks = torch.from_numpy(tokens(8, 512))
    for call in (lambda: model(toks), lambda: prefill(model, toks)):
        with pytest.raises(ValueError, match="frames"):
            call()


def close_cache(got, want):
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.bfloat16, k
        assert_allclose(np32(got[k]), np32(want[k]), rtol=1e-2, atol=BF16,
                        err_msg=k)


def as_port_cache(jc):
    """The JAX cache's values as the port's bf16 tensors (the same bits)."""
    return {k: torch.from_numpy(np.array(np32(v))).to(torch.bfloat16)
            for k, v in jc.items()}


def run_both(whisper, dtype, prompt_seed=2):
    """Prefill and DECODE_STEPS decode steps of both packages at ``dtype``;
    the port's steps from its own cache (``own``) and from the JAX run's
    cache bits (``same``)."""
    cfg, params, tcfg, _ = whisper
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jp = jax.tree.map(lambda a: a.astype(jdt), params)
    model = from_jax_params(tcfg, jax.device_get(params), dtype=dtype)
    toks, fr = tokens(PROMPT, cfg.vocab, seed=prompt_seed), frames(1)
    jl, jc = jprefill(jp, cfg, jnp.asarray(toks), capacity=CAPACITY,
                      frames=jnp.asarray(fr).astype(jdt))
    tl, tc = prefill(model, torch.from_numpy(toks), capacity=CAPACITY,
                     frames=torch.from_numpy(fr).to(dtype))
    # the decode steps write the port's cache in place: keep the prefill's
    out = dict(prefill=(tl, jl), cache=({k: v.clone() for k, v in tc.items()},
                                        jc), own=[], same=[])
    tok = np.array(jnp.argmax(jl, -1))
    for i in range(DECODE_STEPS):
        pos = PROMPT + i
        same = as_port_cache(jc)
        jl, jc = jdecode_step(jp, cfg, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl_same, _ = decode_step(model, same, torch.from_numpy(tok).long(),
                                 pos)
        out["same"].append((tl_same, jl))
        if i == 0:
            tl_own, tc = decode_step(model, tc, torch.from_numpy(tok).long(),
                                     pos)
            out["own"].append((tl_own, jl))
            out["cache_after_one"] = (tc, jc)
        tok = np.array(jnp.argmax(jl, -1))
    return out


def test_prefill_and_decode_match_jax_in_float32(whisper):
    """A 24-token prompt over 8 frames at capacity 32, every cache key
    (k, v padded to the capacity; xk, xv over the frames), then three
    decode steps."""
    r = run_both(whisper, torch.float32)
    tl, jl = r["prefill"]
    assert_allclose(np32(tl), np.asarray(jl), rtol=F32, atol=F32)
    tc, jc = r["cache"]
    assert {k: tuple(v) for k, v in cache_defs(whisper[2], 1,
                                               CAPACITY).items()} == \
        {k: v.shape for k, v in jc.items()}
    close_cache(tc, jc)
    for got, want in r["own"]:
        assert_allclose(np32(got), np.asarray(want), rtol=DECODE,
                        atol=DECODE)
    for got, want in r["same"]:
        assert_allclose(np32(got), np.asarray(want), rtol=SAME_BITS,
                        atol=SAME_BITS)
    tc, jc = r["cache_after_one"]
    close_cache(tc, jc)
    # decode leaves the cross-attention's keys and values as they were
    assert torch.equal(tc["xk"], r["cache"][0]["xk"])


def test_prefill_and_decode_match_jax_in_bf16(whisper):
    """bf16 parameters, frames and activations in both packages: every
    output of the port's bf16 run at most twice as far from the JAX float32
    run as the JAX bf16 run is (see above)."""
    r = run_both(whisper, torch.bfloat16)
    f32 = run_both(whisper, torch.float32)
    pairs = [("prefill", r["prefill"], f32["prefill"][1])]
    pairs += [(k, (r["cache"][0][k], r["cache"][1][k]), f32["cache"][1][k])
              for k in ("k", "v", "xk", "xv")]
    pairs += [(f"decode {i}", r["same"][i], f32["same"][i][1])
              for i in range(DECODE_STEPS)]
    for name, (got, want), want32 in pairs:
        noise = rel_l2(want, want32)
        assert 0 < noise < 0.2, name
        assert rel_l2(got, want32) <= 2 * noise, (name, rel_l2(got, want32),
                                                  noise)


def test_float32_decode_shows_both_numerics_traps(whisper, monkeypatch):
    """The SAME_BITS comparison fails with either trap undone: the decode
    position added unrounded, or the prefill's cross-attention reading its
    keys and values rounded to bf16 as the cache keeps them."""
    def worst(r, key):
        return max(np.abs(np32(g) - np.asarray(w)).max() for g, w in r[key])

    assert worst(run_both(whisper, torch.float32), "same") <= SAME_BITS
    with monkeypatch.context() as mp:
        mp.setattr(tlm, "_decode_position", lambda model, pos:
                   tlm._learned_positions(model, pos, 1)[None])
        assert worst(run_both(whisper, torch.float32), "same") > 3 * SAME_BITS

    good = tlm._cross_part

    def bf16_cross(p, y, cfg, enc):
        h = tlm.rmsnorm(y, p["ln_x"]["scale"], cfg.norm_eps)
        q, k, v = tlm.qkv(h, p["xattn"], cfg, kv_x=enc, rope=False)
        o = tlm.prefill_attention(q, k.bfloat16().float(),
                                  v.bfloat16().float(), cfg, causal=False)
        return y + tlm.out_proj(o, p["xattn"]), (k, v)

    with monkeypatch.context() as mp:
        mp.setattr(tlm, "_cross_part", bf16_cross)
        r = run_both(whisper, torch.float32)
    assert tlm._cross_part is good
    tl, jl = r["prefill"]
    assert np.abs(np32(tl) - np.asarray(jl)).max() > 3 * F32


@pytest.mark.parametrize("pos", [127, 128, 200])
def test_positions_past_max_pos_clamp_as_jax(whisper, pos):
    """A decode step at or past the 128-row table reads its last row, as
    ``dynamic_slice_in_dim`` clamps (the self-attention cache write clamps
    to its last row too)."""
    cfg, params, tcfg, model = whisper
    assert tlm._learned_positions(model, pos, 1).data_ptr() == \
        model.pos_embed[cfg.max_pos - 1:].data_ptr()
    toks, fr = tokens(PROMPT, cfg.vocab, seed=5), frames(1, seed=8)
    _, jc = jprefill(params, cfg, jnp.asarray(toks), capacity=CAPACITY,
                     frames=jnp.asarray(fr))
    tok = np.array([3])
    jl, jc2 = jdecode_step(params, cfg, jc, jnp.asarray(tok),
                           jnp.asarray(pos))
    tl, tc = decode_step(model, as_port_cache(jc),
                         torch.from_numpy(tok).long(), pos)
    assert_allclose(np32(tl), np.asarray(jl), rtol=SAME_BITS, atol=SAME_BITS)
    close_cache(tc, jc2)


@pytest.mark.parametrize("length,channels", [(8, 64), (1500, 1280), (7, 2),
                                             (5, 3)])
def test_sinusoids_match_jax(length, channels):
    """The exponent bit for bit (channels 2 and 3 take the max(half - 1, 1)
    denominator); the values within 2^-22 (1 + |angle|) (see above)."""
    half = channels // 2
    i = np.arange(half, dtype=np.float32)
    jarg = np.asarray(-math.log(10_000.0) * jnp.asarray(i) / max(half - 1, 1))
    targ = (-math.log(10_000.0) * torch.from_numpy(i) / max(half - 1, 1))
    assert np.array_equal(jarg, targ.numpy())
    want = np.asarray(jlm._sinusoids(length, channels, jnp.float32))
    got = tlm._sinusoids(length, channels, torch.float32).numpy()
    assert got.shape == want.shape == (length, 2 * half)
    ang = np.arange(length, dtype=np.float64)[:, None] * np.exp(
        jarg.astype(np.float64))[None]
    bound = 2.0 ** -22 * (1 + np.abs(np.concatenate([ang, ang], -1)))
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()
    assert tlm._sinusoids(length, channels, torch.bfloat16).dtype == \
        torch.bfloat16


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_training(whisper):
    """The JAX package's step-1 loss and gradients, and three steps with
    microbatches 2 and remat "dots"."""
    cfg, params, _, _ = whisper
    toks, labels = train_batch(cfg.vocab)
    fr = frames(B)
    (_, (loss, aux)), grads = jax.jit(jax.value_and_grad(
        jmake_loss_fn(cfg, JRuntimeConfig(remat=None)), has_aux=True))(
        params, jnp.asarray(toks), jnp.asarray(labels),
        {"frames": jnp.asarray(fr)})
    opt = JAdamW(JAdamWConfig(lr=1e-3, eps=ADAM_EPS))
    step = jax.jit(jmake_train_step(cfg, opt, JRuntimeConfig(
        remat="dots", microbatches=2)))
    state = jinit_state(params, opt)
    losses = []
    for i in range(3):
        t, lab = train_batch(cfg.vocab, seed=i)
        state, m = step(state, {"tokens": jnp.asarray(t),
                                "labels": jnp.asarray(lab),
                                "frames": jnp.asarray(frames(B, seed=10 + i))})
        losses.append(float(m["loss"]))
    return dict(tokens=toks, labels=labels, frames=fr, loss=float(loss),
                aux=float(aux), grads=jax.device_get(grads), losses=losses)


def port_grads(whisper, jt, dtype):
    model = from_jax_params(whisper[2], jax.device_get(whisper[1]),
                            dtype=dtype)
    named = trainable(model)
    total, (loss, aux) = make_loss_fn(model.cfg, RuntimeConfig(remat=None))(
        model, torch.from_numpy(jt["tokens"]), torch.from_numpy(jt["labels"]),
        {"frames": torch.from_numpy(jt["frames"]).to(dtype)})
    gs = torch.autograd.grad(total, list(named.values()))
    tree = named_to_tree({k: g.double() for k, g in zip(named, gs)})
    return float(loss.detach()), float(aux), dict(leaves(tree))


def test_step1_gradients_match_jax(whisper, jax_training):
    jt = jax_training
    loss, aux, got = port_grads(whisper, jt, torch.float32)
    _, _, exact = port_grads(whisper, jt, torch.float64)
    assert_allclose(loss, jt["loss"], rtol=1e-5)
    assert aux == jt["aux"] == 0.0
    want = dict(leaves(jt["grads"]))
    assert got.keys() == want.keys()
    assert {"pos_embed", "encoder/layers/ffn/w_in", "layers/xattn/wk"} <= \
        want.keys()
    for k, w in want.items():
        e_jax = np.abs(w - exact[k]).max()
        err = np.abs(got[k] - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-7 + e_jax, (k, err, e_jax)


def test_three_train_steps_match_jax(whisper, jax_training):
    """Microbatches 2 (``frames`` split with the tokens) and remat "dots"
    (the encoder's blocks checkpointed one by one)."""
    model = from_jax_params(whisper[2], jax.device_get(whisper[1]))
    opt = AdamW(AdamWConfig(lr=1e-3, eps=ADAM_EPS))
    state = init_state(model, opt)
    step = make_train_step(model.cfg, opt,
                           RuntimeConfig(remat="dots", microbatches=2))
    losses = []
    for i in range(3):
        t, lab = train_batch(model.cfg.vocab, seed=i)
        state, m = step(state, {"tokens": torch.from_numpy(t),
                                "labels": torch.from_numpy(lab),
                                "frames": torch.from_numpy(
                                    frames(B, seed=10 + i))})
        losses.append(float(m["loss"]))
    assert int(state.opt.step) == 3
    assert_allclose(losses, jax_training["losses"], rtol=1e-4)


def test_remat_groups_the_decoder_only_as_jax():
    """remat_group 2 over 3 encoder and 2 decoder layers: the JAX package
    groups the decoder's scan only, so the ragged encoder runs, and the
    grouped step's loss and gradient norm are those of no remat."""
    cfg = dataclasses.replace(jget_smoke(ARCH), n_enc_layers=3)
    tcfg = configs.get_smoke(ARCH).scaled(n_enc_layers=3)
    params = init_tree(jax.random.PRNGKey(1), model_defs(cfg),
                       dtype=jnp.float32)
    t, lab = train_batch(cfg.vocab, seed=4)
    fr = frames(B, seed=4)
    jrt = JRuntimeConfig(remat="full", remat_group=2)
    opt = JAdamW(JAdamWConfig(lr=1e-3))
    _, jm = jax.jit(jmake_train_step(cfg, opt, jrt))(
        jinit_state(params, opt), {"tokens": jnp.asarray(t),
                                   "labels": jnp.asarray(lab),
                                   "frames": jnp.asarray(fr)})
    runs = []
    for rt in (RuntimeConfig(remat="full", remat_group=2),
               RuntimeConfig(remat=None)):
        model = from_jax_params(tcfg, jax.device_get(params))
        topt = AdamW(AdamWConfig(lr=1e-3))
        _, m = make_train_step(tcfg, topt, rt)(
            init_state(model, topt), {"tokens": torch.from_numpy(t),
                                      "labels": torch.from_numpy(lab),
                                      "frames": torch.from_numpy(fr)})
        runs.append((float(m["loss"]), float(m["grad_norm"])))
    assert_allclose(runs[0], runs[1], rtol=1e-5)
    assert_allclose(runs[0], (float(jm["loss"]), float(jm["grad_norm"])),
                    rtol=1e-4)


def test_adamw_decay_mask_matches_jax(whisper):
    """The substring rule decays ``pos_embed`` and the q/o biases (no
    "bias" in ``bq``/``bo``) and spares every norm, ``ln_x`` and the
    encoder's final norm among them, in both packages."""
    cfg, params, _, model = whisper
    jopt, topt = JAdamW(JAdamWConfig()), AdamW(AdamWConfig())
    named = dict(model.named_parameters())
    want = dict(leaves(jax.device_get(jopt._decay_mask(params))))
    got = dict(leaves(named_to_tree(
        {k: torch.full(p.shape, float(topt.decayed(k)))
         for k, p in named.items()})))
    assert got.keys() == want.keys()
    for k in want:
        assert np.all(got[k] == want[k]), k
    decayed = {param_path(k) for k in named if topt.decayed(k)}
    assert {"pos_embed", "layers/attn/bq", "layers/xattn/bo",
            "encoder/layers/attn/bq"} <= decayed
    assert not decayed & {"layers/ln_x/scale", "final_norm/scale",
                          "encoder/final_norm/scale"}


# ---------------------------------------------------------------------------
# checkpoints, launchers, the engine
# ---------------------------------------------------------------------------

def whisper_state(seed, steps=0):
    cfg = configs.get_smoke(ARCH)
    model = LM(cfg, generator=torch.Generator().manual_seed(seed))
    opt = AdamW(AdamWConfig(lr=1e-3))
    state = init_state(model, opt, compress=True)
    step = make_train_step(cfg, opt, RuntimeConfig(remat=None))
    for i in range(steps):
        t, lab = train_batch(cfg.vocab, seed=i)
        state, _ = step(state, {"tokens": torch.from_numpy(t),
                                "labels": torch.from_numpy(lab),
                                "frames": torch.from_numpy(frames(B)).to(
                                    torch.bfloat16)})
    return state


def test_checkpoints_cross_both_ways(tmp_path):
    """A port checkpoint of a trained whisper state restores in the JAX
    package, and a JAX one (its moments and error feedback not zero) in
    the port, bit for bit."""
    cfg = jget_smoke(ARCH)
    state = whisper_state(0, steps=1)
    CheckpointManager(str(tmp_path / "port")).save(
        1, state_to_tree(state), blocking=True)
    jparams = init_tree(jax.random.PRNGKey(4), model_defs(cfg),
                        dtype=jnp.bfloat16)
    like = jax.device_get(jinit_state(jparams, JAdamW(JAdamWConfig()),
                                      compress=True))
    tree, meta = JCheckpointManager(str(tmp_path / "port")).restore_latest(
        like)
    assert meta.step == 1
    assert_same(tree, state_to_tree(state))

    rng = np.random.default_rng(0)
    noisy = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape),
                                               a.dtype), like)
    noisy = noisy._replace(opt=noisy.opt._replace(
        step=jnp.asarray(5, jnp.int32)))
    JCheckpointManager(str(tmp_path / "jax")).save(5, noisy, blocking=True)
    other = whisper_state(9)
    tree, meta = CheckpointManager(str(tmp_path / "jax")).restore_latest(
        state_to_tree(other))
    restored = state_from_tree(other, tree)
    assert meta.step == 5 and int(restored.opt.step) == 5
    assert_same(state_to_tree(restored), jax.device_get(noisy))


def test_serve_launcher_refuses_as_jax(capsys):
    with pytest.raises(SystemExit, match="whisper-large-v3-smoke: enc-dec "
                       "serving needs audio frames; use "
                       "examples/serve_llm.py patterns instead"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_engine_refuses_an_encoder_decoder(whisper):
    with pytest.raises(ValueError, match="frames"):
        ServeEngine(whisper[2], whisper[3], slots=1, capacity=CAPACITY,
                    device="cpu")


def test_train_launcher_trains_on_cpu(capsys):
    assert ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--steps", "2", "--seq-len", "16", "--batch", "2",
                        "--log-every", "1"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 2
    for ln in lines:
        fields = dict(f.split("=") for f in ln.split()[2:])
        assert np.isfinite(float(fields["loss"]))
