"""The port's training path against the JAX package on the CPU: the loss,
the step-1 gradients of both ported archs, AdamW with its decay mask, the
schedules, the int8 compression, three train steps, microbatching and
remat, and the int8 data-parallel step at world size 1.  Smoke configs,
float32 parameters from ``repro.models.init_tree`` carried across by
``from_jax_params``, batches made with numpy from a seed.

Tolerances, each with its reason:
- the loss: rtol 1e-5, the same float32 function (logsumexp and gather)
  summed in another order;
- step-1 gradients: per leaf max |port - JAX| <= 1e-4 max |JAX| + 1e-7
  + e_JAX, where e_JAX = max |JAX - exact| is the reference's own float32
  error against the exact gradient (the port's, in float64): float32
  backward passes through functions summed in another order (the port's SSD
  is the token-by-token recurrence, JAX's the chunked scan; the MoE combine
  adds a token's k outputs at once).  e_JAX matters for zamba2, whose
  near-argmax attention and SSM amplify float32 rounding: its reference
  gradients are up to 1.35e-4 max |g| from exact (the port's 5.1e-5), so the
  port is also held to the exact gradient itself at 1e-4 max |g| wherever
  float32 resolves it, that is where the reference is within 2e-4 max |g|
  of exact on every leaf.  gemma2's smoke model is not resolved: its
  softcapped near-argmax attention leaves the reference up to 1.21e-3
  max |g| from the port's float64 gradient (the port 3.9e-4), so it is
  held to the reference with e_JAX alone;
- AdamW and the schedules: rtol 1e-6, the same float32 arithmetic;
- compression: exact (the same float32 divisions and roundings);
- three train steps: losses at rtol 1e-4.  Parameters are not compared
  after Adam steps: g / (|g| + eps) flips sign on near-zero gradients, and
  so the steps run with eps = 1e-3, above the gradients' float32 noise
  (~1e-4 max |g| ~ 1e-5), where the update is continuous in g.  With eps
  1e-8 a few thousand elements near zero take opposite +-lr steps in the
  two packages and zamba2's third loss moves by 6e-4;
- microbatching and remat within the port: rtol 1e-5 (the reference's own
  test, ``tests/test_runtime.py``, allows 1e-4 for XLA's reordering).  A
  microbatch's MoE capacity and load-balance loss (a product of per-batch
  means) are its own, as in the reference, so granite's microbatches equal
  its full batch only where nothing drops and the aux loss is left out:
  that check runs at capacity factor E / k and aux weight 0; with the
  model's own settings the port's two microbatches are held to the
  reference's (loss rtol 1e-5, gradient norm rtol 1e-4: the reference's
  float32 gradients are ~1e-4 max |g| from exact, see above);
- the int8 step (one step): loss rtol 1e-5, gradient norm rtol 1e-4; the
  error feedback elementwise within 5% of a quantisation step of the
  reference's, or one step apart (a gradient within float32 noise of a
  rounding boundary rounds the other way), on at most 1% of the elements.
  The int8 path is the same for every arch (gradients in, an int8 sum
  out), so it runs on the first two archs only: the others' float32
  gradients do not resolve those bounds (gemma2's gradient norm moves by
  1.0e-4, one of nemotron's 64 final-norm elements rounds the other way).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from numpy.testing import assert_allclose

from repro.configs import get_smoke as jget_smoke
from repro.launch.mesh import make_host_mesh
from repro.models import init_tree, model_defs
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import compress as jcompress
from repro.optim import schedules as jsched
from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime import chunked_xent as jchunked_xent
from repro.runtime import init_state as jinit_state
from repro.runtime import make_dp_train_step_int8 as jmake_dp_step
from repro.runtime import make_loss_fn as jmake_loss_fn
from repro.runtime import make_train_step as jmake_train_step
from repro.runtime import xent_from_logits as jxent
from repro_torch import configs
from repro_torch.checkpoint import named_to_tree, tree_to_named
from repro_torch.launch import train as tlaunch
from repro_torch.models import from_jax_params
from repro_torch.models.lm import REMAT_POLICIES
from repro_torch.optim import AdamW, AdamWConfig, param_path
from repro_torch.optim import compress as tcompress
from repro_torch.optim import schedules as tsched
from repro_torch.runtime import (RuntimeConfig, chunked_xent, init_state,
                                 make_dp_train_step_int8, make_loss_fn,
                                 make_train_step, xent_from_logits)
from repro_torch.runtime.train import trainable

torch.set_num_threads(1)

ARCHS = ("zamba2-2.7b", "granite-moe-3b-a800m", "mamba2-1.3b", "minicpm-2b",
         "gemma2-2b", "nemotron-4-15b", "internvl2-26b",
         "command-r-plus-104b", "mixtral-8x22b")
INT8_ARCHS = ARCHS[:2]      # the int8 step's archs (see above)
B, S = 4, 32
ADAM_EPS = 1e-3          # the three-step comparison's (see above)


def batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[:, -1] = -1
    return toks[:, :S], labels


def port_batch(tokens, labels):
    return {"tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}


def jax_batch(tokens, labels):
    return {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}


def leaves(tree, prefix=""):
    """(path, array) of a nested dict, as numpy."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v, dtype=np.float32)


def port_model(arch, params):
    return from_jax_params(configs.get_smoke(arch), jax.device_get(params))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """Each arch's smoke config, JAX parameters, and its JAX step-1
    gradients and three-step losses (one compile of each per arch)."""
    name = request.param
    cfg = jget_smoke(name)
    params = init_tree(jax.random.PRNGKey(0), model_defs(cfg),
                       dtype=jnp.float32)
    tokens, labels = batch(cfg.vocab)
    jrt = JRuntimeConfig(remat=None)
    loss_fn = jmake_loss_fn(cfg, jrt)
    (_, (loss, aux)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jnp.asarray(tokens),
                                jnp.asarray(labels), {})
    opt = JAdamW(JAdamWConfig(lr=1e-3, eps=ADAM_EPS))
    step = jax.jit(jmake_train_step(cfg, opt, jrt))
    state = jinit_state(params, opt)
    losses = []
    for i in range(3):
        state, m = step(state, jax_batch(*batch(cfg.vocab, seed=i)))
        losses.append(float(m["loss"]))
    mb = jax.jit(jmake_train_step(
        cfg, opt, JRuntimeConfig(remat=None, microbatches=2)))
    _, m2 = mb(jinit_state(params, opt), jax_batch(*batch(cfg.vocab, 3)))
    return dict(name=name, cfg=cfg, params=params, tokens=tokens,
                labels=labels, loss=float(loss), aux=float(aux),
                grads=jax.device_get(grads), losses=losses,
                microbatched=(float(m2["loss"]), float(m2["grad_norm"])))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_xent_from_logits_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 7, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    labels[0, 2] = labels[1, 5] = -1
    tot, n = xent_from_logits(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    jtot, jn = jxent(jnp.asarray(logits), jnp.asarray(labels))
    assert float(n) == float(jn) == 12.0
    assert_allclose(float(tot), float(jtot), rtol=1e-5)


@pytest.mark.parametrize("chunks", [1, 4])
def test_chunked_xent_matches_jax(chunks):
    """Tied embeddings, a padded vocabulary and a final softcap (the
    granite smoke config with the cap set in both packages)."""
    name = "granite-moe-3b-a800m"
    cfg = dataclasses.replace(jget_smoke(name), final_softcap=30.0)
    tcfg = dataclasses.replace(configs.get_smoke(name), final_softcap=30.0)
    assert cfg.padded_vocab > cfg.vocab
    params = init_tree(jax.random.PRNGKey(1), model_defs(cfg),
                       dtype=jnp.float32)
    model = from_jax_params(tcfg, jax.device_get(params))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    labels = rng.integers(-1, cfg.vocab, (2, 16)).astype(np.int32)
    xt = torch.from_numpy(x).requires_grad_(True)
    tot, n = chunked_xent(xt, model.embed, tcfg, torch.from_numpy(labels),
                          chunks=chunks)
    (jtot, jn), gx = jax.jit(jax.value_and_grad(
        lambda a: jchunked_xent(a, params, cfg, jnp.asarray(labels),
                                chunks=chunks), has_aux=True))(
        jnp.asarray(x))
    assert float(n) == float(jn)
    assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    tot.backward()
    gx = np.asarray(gx)
    assert np.abs(xt.grad.numpy() - gx).max() <= 1e-4 * np.abs(gx).max()


# ---------------------------------------------------------------------------
# gradients, steps
# ---------------------------------------------------------------------------

def _port_grads(arch, dtype):
    """The port's step-1 loss, aux and gradients (float64 numpy leaves by
    JAX path) with its parameters in ``dtype``."""
    model = port_model(arch["name"], arch["params"]).to(dtype)
    params = trainable(model)
    loss_fn = make_loss_fn(model.cfg, RuntimeConfig(remat=None))
    total, (loss, aux) = loss_fn(model, torch.from_numpy(arch["tokens"]),
                                 torch.from_numpy(arch["labels"]))
    names = list(params)
    gs = torch.autograd.grad(total, [params[k] for k in names])
    tree = named_to_tree({k: g.double() for k, g in zip(names, gs)})
    return float(loss), float(aux), {k: np.asarray(v, np.float64)
                                     for k, v in _leaves64(tree)}


def _leaves64(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves64(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k].numpy()


def test_step1_gradients_match_jax(arch):
    loss, aux, got = _port_grads(arch, torch.float32)
    _, _, exact = _port_grads(arch, torch.float64)
    assert_allclose(loss, arch["loss"], rtol=1e-5)
    assert_allclose(aux, arch["aux"], rtol=1e-5, atol=1e-7)
    want = dict(leaves(arch["grads"]))
    assert got.keys() == want.keys()
    resolved = all(np.abs(w - exact[k]).max() <= 2e-4 * np.abs(w).max()
                   for k, w in want.items())
    assert resolved or arch["name"] == "gemma2-2b"
    for k, w in want.items():
        scale = np.abs(w).max()
        e_jax = np.abs(w - exact[k]).max()
        err = np.abs(got[k] - w).max()
        assert err <= 1e-4 * scale + 1e-7 + e_jax, (k, err, e_jax)
        if resolved:
            assert np.abs(got[k] - exact[k]).max() <= \
                1e-4 * np.abs(exact[k]).max() + 1e-7, k


def test_three_train_steps_match_jax(arch):
    model = port_model(arch["name"], arch["params"])
    opt = AdamW(AdamWConfig(lr=1e-3, eps=ADAM_EPS))
    state = init_state(model, opt)
    step = make_train_step(model.cfg, opt, RuntimeConfig(remat=None))
    losses = []
    for i in range(3):
        state, m = step(state, port_batch(*batch(model.cfg.vocab, seed=i)))
        losses.append(float(m["loss"]))
    assert int(state.opt.step) == 3
    assert_allclose(losses, arch["losses"], rtol=1e-4)


def _one_step(arch_name, params, rt, cfg=None):
    model = from_jax_params(cfg or configs.get_smoke(arch_name),
                            jax.device_get(params))
    opt = AdamW(AdamWConfig(lr=1e-3))
    state = init_state(model, opt)
    cfg = model.cfg
    _, m = make_train_step(cfg, opt, rt)(
        state, port_batch(*batch(cfg.vocab, seed=3)))
    return float(m["loss"]), float(m["grad_norm"])


def test_microbatching_matches_full_batch(arch):
    """Gradient accumulation is the mean of the slices' gradients; a batch
    that M does not divide falls back to one pass."""
    cfg, aux_weight = configs.get_smoke(arch["name"]), 0.01
    if cfg.moe is not None:          # nothing drops, no aux loss
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        aux_weight = 0.0
    runs = [_one_step(arch["name"], arch["params"],
                      RuntimeConfig(microbatches=m, remat=None,
                                    aux_weight=aux_weight), cfg)
            for m in (1, 2, 3)]
    assert_allclose(runs[1], runs[0], rtol=1e-5)
    assert runs[2] == runs[0]


def test_microbatches_match_jax(arch):
    loss, gnorm = _one_step(arch["name"], arch["params"],
                            RuntimeConfig(microbatches=2, remat=None))
    assert_allclose(loss, arch["microbatched"][0], rtol=1e-5)
    assert_allclose(gnorm, arch["microbatched"][1], rtol=1e-4)


@pytest.mark.parametrize("remat,group", [("full", 1), ("dots", 1),
                                         ("dots_no_batch", 1), ("full", 2),
                                         ("none", 1)])
def test_remat_matches_no_remat(arch, remat, group):
    base = _one_step(arch["name"], arch["params"], RuntimeConfig(remat=None))
    got = _one_step(arch["name"], arch["params"],
                    RuntimeConfig(remat=remat, remat_group=group))
    assert_allclose(got, base, rtol=1e-5)


def test_remat_refuses_unknown_policy_and_ragged_groups(arch):
    with pytest.raises(ValueError, match="remat policy"):
        _one_step(arch["name"], arch["params"], RuntimeConfig(remat="all"))
    n = len(port_model(arch["name"], arch["params"]).layers)
    with pytest.raises(ValueError, match="does not divide"):
        _one_step(arch["name"], arch["params"],
                  RuntimeConfig(remat="full", remat_group=n + 1))
    assert set(REMAT_POLICIES) == {None, "none", "full", "dots",
                                   "dots_no_batch"}


@pytest.mark.parametrize("arch", INT8_ARCHS, indirect=True)
def test_int8_dp_step_at_world_size_1_matches_jax(arch, tmp_path):
    cfg = arch["cfg"]
    opt = JAdamW(JAdamWConfig(lr=1e-3))
    jrt = JRuntimeConfig(remat=None)
    jstep = jax.jit(jmake_dp_step(cfg, opt, jrt, make_host_mesh(("data",))))
    jstate = jinit_state(arch["params"], opt, compress=True)
    model = port_model(arch["name"], arch["params"])
    topt = AdamW(AdamWConfig(lr=1e-3))
    state = init_state(model, topt, compress=True)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        step = make_dp_train_step_int8(model.cfg, topt,
                                       RuntimeConfig(remat=None))
        b = batch(cfg.vocab, seed=0)
        jstate, jm = jstep(jstate, jax_batch(*b))
        state, m = step(state, port_batch(*b))
    finally:
        dist.destroy_process_group()
    assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                    rtol=1e-4)
    got = dict(leaves(named_to_tree(state.compression.error)))
    for k, w in leaves(jax.device_get(jstate.compression.error)):
        step_size = 2 * np.abs(w).max() + 1e-30    # |error| <= step / 2
        diff = np.abs(got[k] - w)
        flipped = np.abs(diff - step_size) <= 0.05 * step_size
        assert np.all(flipped | (diff <= 0.05 * step_size)), k
        assert flipped.mean() <= 0.01, k


# ---------------------------------------------------------------------------
# optimizer, schedules, compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_adamw_update_and_decay_mask_match_jax(name):
    """Two updates from the same parameters and gradients, clipping on,
    with the decay mask by the JAX path of each parameter."""
    cfg = jget_smoke(name)
    params = jax.device_get(init_tree(jax.random.PRNGKey(0),
                                      model_defs(cfg), dtype=jnp.float32))
    model = port_model(name, params)
    named = dict(model.named_parameters())
    jopt = JAdamW(JAdamWConfig(lr=1e-2, weight_decay=0.5, grad_clip=0.5))
    topt = AdamW(AdamWConfig(lr=1e-2, weight_decay=0.5, grad_clip=0.5))
    # the decay mask: the port's by name against the reference's by path
    want_mask = dict(leaves(jopt._decay_mask(params)))
    got_mask = dict(leaves(named_to_tree(
        {k: torch.full(p.shape, float(topt.decayed(k)))
         for k, p in named.items()})))
    assert got_mask.keys() == want_mask.keys()
    for k in want_mask:
        assert np.all(got_mask[k] == want_mask[k]), k
    decayed = {param_path(k) for k in named if topt.decayed(k)}
    assert "embed/tokens" in decayed
    assert not any("norm" in p or p.endswith("dt_bias") for p in decayed)
    if name == "zamba2-2.7b":        # lower-cased paths: "A_log", "D" decay
        assert {"layers/mamba/ssm/A_log", "layers/mamba/ssm/D"} <= decayed

    jstate, tstate = jopt.init(params), topt.init(named)
    jp = params
    rng = np.random.default_rng(0)
    update = jax.jit(jopt.update)
    for _ in range(2):
        g = jax.tree.map(lambda p: rng.normal(size=p.shape)
                         .astype(np.float32), jp)
        jp, jstate, jn = update(g, jstate, jp)
        gt = {k: v for k, v in zip(named, _named_like(named, g))}
        _, tstate, tn = topt.update(gt, tstate, named)
        assert_allclose(float(tn), float(jn), rtol=1e-6)
    got = dict(leaves(named_to_tree(named)))
    for k, w in leaves(jax.device_get(jp)):
        assert_allclose(got[k], w, rtol=1e-6, atol=1e-7, err_msg=k)
    for tree, jtree in ((tstate.m, jstate.m), (tstate.v, jstate.v)):
        got = dict(leaves(named_to_tree(tree)))
        for k, w in leaves(jax.device_get(jtree)):
            assert_allclose(got[k], w, rtol=1e-6, atol=1e-9, err_msg=k)
    assert int(tstate.step) == int(jstate.step) == 2


def _named_like(named, jtree):
    """The JAX tree's leaves as tensors in the port's parameter order."""
    out = tree_to_named(jtree, list(named))
    return [out[k].clone() for k in named]


@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-3),
    lambda m: m.linear_warmup(3e-3, 10),
    lambda m: m.cosine_schedule(3e-3, warmup=5, total=40),
    lambda m: m.wsd_schedule(3e-3, warmup=5, stable=20, decay=10),
])
def test_schedules_match_jax(make):
    f, jf = make(tsched), make(jsched)
    steps = list(range(0, 50, 3)) + [4, 5, 25, 35, 45]
    got = [float(f(s)) for s in steps]
    want = [float(jf(s)) for s in steps]
    assert_allclose(got, want, rtol=1e-6)


def test_launcher_optimizers_follow_the_arch_recipe():
    cfg = configs.get_smoke("granite-moe-3b-a800m")
    opt = tlaunch.build_optimizer(cfg, 1e-3, 100)
    assert_allclose(float(opt.config.lr_at(50)),
                    float(jsched.cosine_schedule(1e-3, 5, 100)(50)),
                    rtol=1e-6)
    wsd = tlaunch.build_optimizer(dataclasses.replace(cfg,
                                                      lr_schedule="wsd"),
                                  1e-3, 100)
    assert_allclose(float(wsd.config.lr_at(90)),
                    float(jsched.wsd_schedule(1e-3, 5, 70, 25)(90)),
                    rtol=1e-6)


def test_compression_matches_jax_exactly():
    rng = np.random.default_rng(0)
    grads = {"a": rng.normal(size=(5, 7)).astype(np.float32),
             "b": (rng.normal(size=(13,)) * 1e-3).astype(np.float32),
             "z": np.zeros((3,), np.float32)}
    err = {k: (rng.normal(size=v.shape) * 1e-4).astype(np.float32)
           for k, v in grads.items()}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    tst = tcompress.CompressionState(
        error={k: torch.from_numpy(v) for k, v in err.items()})
    jst = jcompress.CompressionState(
        error={k: jnp.asarray(v) for k, v in err.items()})
    scales = tcompress.shared_scale(tg, tst)
    jscales = jcompress.shared_scale(grads, jst)
    for k in grads:
        assert float(scales[k]) == float(jscales[k]), k
    q, st = tcompress.compress_gradients(tg, tst, scales)
    jq, jst2 = jcompress.compress_gradients(grads, jst, jscales)
    for k in grads:
        assert q[k].dtype == torch.int8
        assert np.array_equal(q[k].numpy(), np.asarray(jq[k])), k
        assert np.array_equal(st.error[k].numpy(), np.asarray(jst2.error[k]))
    qs = {k: v.to(torch.int32) * 3 for k, v in q.items()}
    got = tcompress.decompress_sum(qs, scales, 3)
    want = jcompress.decompress_sum(
        {k: jnp.asarray(v.numpy()) for k, v in qs.items()}, jscales, 3)
    for k in grads:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    x = torch.from_numpy(grads["a"])
    tq, ts = tcompress.quantize_int8(x)
    jq1, js = jcompress.quantize_int8(jnp.asarray(grads["a"]))
    assert float(ts) == float(js)
    assert np.array_equal(tq.numpy(), np.asarray(jq1))
    assert np.array_equal(tcompress.dequantize_int8(tq, ts).numpy(),
                          np.asarray(jcompress.dequantize_int8(jq1, js)))
    zeros = tcompress.init_compression(tg)
    assert all(torch.equal(v, torch.zeros_like(v))
               for v in zeros.error.values())


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_launcher_trains_on_cpu(name, capsys):
    assert tlaunch.main(["--arch", name, "--smoke", "--device", "cpu",
                         "--steps", "2", "--seq-len", "16", "--batch", "2",
                         "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert len(lines) == 2
    for ln in lines:
        fields = dict(f.split("=") for f in ln.split()[2:])
        assert set(fields) == {"loss", "aux", "gnorm", "lr", "tok/s"}
        assert np.isfinite(float(fields["loss"]))


def test_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                      "--steps", "1"])
