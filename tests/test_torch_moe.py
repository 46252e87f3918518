"""The port's MoE serving path against the JAX package on the CPU:
granite-moe-3b-a800m's ``smoke()`` configuration (2 layers, d_model 64, 8
experts top-4), float32 parameters made by ``repro.models.init_tree`` and
carried across by ``from_jax_params``, inputs made with numpy from a seed.

Tolerances, each with its reason:
- the router and the MoE layer alone: ``MOE`` = 1e-5 — the same float32
  function, the combine summed in another order (the JAX package adds
  each token's k expert outputs one by one, the port sums them at once);
- the grouped GEMM's plain version against the Pallas kernel: 2e-4 in
  float32 and 3e-2 in bfloat16, as ``tests/test_kernels.py``;
- the model: as ``tests/test_torch_lm.py`` (``F32`` for float32 logits,
  ``BF16`` with rtol 1e-2 for the k/v the cache stores in bf16,
  ``DECODE`` for decode logits, which read those bf16 rows); greedy tokens
  identical, with the JAX run's top-2 logit gap above ``DECODE`` at every
  step, so no comparison rests on a near tie.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import decode_step as jdecode_step
from repro.models import forward_train, init_tree, model_defs
from repro.models import moe as jmoe
from repro.models import prefill as jprefill
from repro.runtime import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.kernels import moe_gemm as tgmm
from repro_torch.kernels import ops, ref
from repro_torch.models import (LM, MoEConfig, Params, cache_defs,
                                decode_step, from_jax_params, prefill)
from repro_torch.models import moe as tmoe
from repro_torch.runtime import ServeEngine

torch.set_num_threads(1)

MOE = 1e-5
F32 = 2e-4
BF16 = 2e-2
DECODE = 1e-3
ARCH = "granite-moe-3b-a800m"


@pytest.fixture(scope="module")
def models():
    cfg = jget_smoke(ARCH)
    params = init_tree(jax.random.PRNGKey(0), model_defs(cfg),
                       dtype=jnp.float32)
    tcfg = configs.get_smoke(ARCH)
    model = from_jax_params(tcfg, jax.device_get(params))
    return cfg, params, tcfg, model


def tokens(n, seed=0, vocab=515, batch=1):
    return np.random.default_rng(seed).integers(0, vocab, (batch, n))


def np32(a):
    return np.asarray(a, dtype=np.float32)


def moe_params(cfg, tcfg, seed=0, scale=1.0):
    """One MoE layer's parameters for both packages: the JAX tree from
    ``init_tree`` (the router times ``scale``) and a port ``Params`` with
    the same numbers."""
    p = jax.device_get(init_tree(jax.random.PRNGKey(seed),
                                 jmoe.moe_defs(cfg), dtype=jnp.float32))
    p["router"] = p["router"] * scale
    tp = Params(tmoe.moe_defs(tcfg), dtype=torch.float32)
    with torch.no_grad():
        for name, value in p.items():
            tp[name].copy_(torch.from_numpy(np.array(value, np.float32)))
    return {k: jnp.asarray(v) for k, v in p.items()}, tp


def with_factor(cfg, tcfg, factor):
    return (dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=factor)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(
                tcfg.moe, capacity_factor=factor)))


def most_per_expert(idx, n_experts):
    return int(np.bincount(np.asarray(idx).reshape(-1),
                           minlength=n_experts).max())


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

def test_config_is_the_jax_packages(models):
    cfg, params, tcfg, model = models
    full, jfull = configs.get_config(ARCH), jget_config(ARCH)
    for got, want in ((full, jfull), (tcfg, cfg)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(full.moe, MoEConfig)
    assert full.param_count() == jfull.param_count()
    assert round(full.param_count() / 1e7) == 330      # 3.30e9
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(params))


# ---------------------------------------------------------------------------
# router, dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row,k", [([1.0, 2.0, 2.0, 2.0, 0.0], 2),
                                   ([0.0] * 5, 2), ([0.5] * 8, 4)],
                         ids=["three_way_tie", "all_zero", "all_equal"])
def test_top_k_breaks_ties_as_jax(row, k):
    want_v, want_i = jax.lax.top_k(jnp.asarray([row]), k)
    got_v, got_i = tmoe.top_k(torch.tensor([row]), k)
    assert got_i.tolist() == np.asarray(want_i).tolist()
    assert_allclose(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("scale", [1.0, 0.0], ids=["random", "zero_router"])
def test_route_matches_jax(models, scale):
    """Same experts exactly, weights and aux loss within ``MOE``.  An
    all-zero router ties every expert: both pick experts 0..k-1."""
    cfg, _, tcfg, _ = models
    jp, tp = moe_params(cfg, tcfg, seed=1, scale=scale)
    x = np.random.default_rng(7).standard_normal((40, 64)).astype(
        np.float32)
    jw, jidx, jaux = jmoe.route(jnp.asarray(x), jp, cfg)
    tw, tidx, taux = tmoe.route(torch.from_numpy(x), tp, tcfg)
    assert tidx.tolist() == np.asarray(jidx).tolist()
    if scale == 0.0:
        assert tidx.tolist() == [list(range(cfg.moe.top_k))] * 40
    assert tw.dtype == torch.float32
    assert_allclose(tw.numpy(), np.asarray(jw), rtol=MOE, atol=MOE)
    assert_allclose(taux.item(), float(jaux), rtol=MOE, atol=MOE)


def test_capacity_matches_jax(models):
    cfg, _, tcfg, _ = models
    full, jfull = configs.get_config(ARCH), jget_config(ARCH)
    for n in (1, 4, 37, 512, 1536):
        assert tmoe.capacity(tcfg, n) == jmoe.capacity(cfg, n)
        assert tmoe.capacity(full, n) == jmoe.capacity(jfull, n)
    assert tmoe.capacity(full, 1536) == 384 and tmoe.capacity(full, 4) == 8


def test_dispatch_with_drops_matches_jax(models):
    """A capacity factor of 0.5 drops tokens (checked); which ones depends
    on the stable expert sort, so the outputs agree only if both packages
    drop the same."""
    cfg, _, tcfg, _ = models
    cfg, tcfg = with_factor(cfg, tcfg, 0.5)
    jp, tp = moe_params(cfg, tcfg, seed=2)
    x = np.random.default_rng(8).standard_normal((2, 24, 64)).astype(
        np.float32)
    _, jidx, _ = jmoe.route(jnp.asarray(x.reshape(48, 64)), jp, cfg)
    assert most_per_expert(jidx, 8) > jmoe.capacity(cfg, 48)
    jy, jaux = jmoe._moe_ffn_local(jnp.asarray(x), jp, cfg)
    ty, taux = tmoe.moe_ffn(torch.from_numpy(x), tp, tcfg)
    assert ty.shape == (2, 24, 64)
    assert_allclose(ty.numpy(), np.asarray(jy), rtol=MOE, atol=MOE)
    assert_allclose(taux.item(), float(jaux), rtol=MOE, atol=MOE)
    # the drops matter: the no-drop oracle differs
    dense, _ = tmoe.moe_ffn_dense(torch.from_numpy(x), tp, tcfg)
    assert (dense - ty).abs().max().item() > 1e-2


def test_dispatch_without_drops_matches_the_dense_oracle(models):
    cfg, _, tcfg, _ = models
    jp, tp = moe_params(cfg, tcfg, seed=3)
    x = np.random.default_rng(9).standard_normal((2, 24, 64)).astype(
        np.float32)
    _, jidx, _ = jmoe.route(jnp.asarray(x.reshape(48, 64)), jp, cfg)
    assert most_per_expert(jidx, 8) <= jmoe.capacity(cfg, 48)
    jdense, _ = jmoe.moe_ffn_dense(jnp.asarray(x), jp, cfg)
    ty, _ = tmoe.moe_ffn(torch.from_numpy(x), tp, tcfg)
    tdense, _ = tmoe.moe_ffn_dense(torch.from_numpy(x), tp, tcfg)
    assert_allclose(ty.numpy(), np.asarray(jdense), rtol=MOE, atol=MOE)
    assert_allclose(tdense.numpy(), np.asarray(jdense), rtol=MOE, atol=MOE)


def test_dispatch_in_bf16_rounds_like_jax(models):
    """bf16 activations and weights: the port sums each token's k expert
    outputs in float32 and rounds once, the JAX package adds them in bf16
    one by one; they differ by a few bf16 steps of the output."""
    cfg, _, tcfg, _ = models
    jp, tp = moe_params(cfg, tcfg, seed=4)
    x = np.random.default_rng(10).standard_normal((1, 32, 64)).astype(
        np.float32)
    jy, _ = jmoe._moe_ffn_local(jnp.asarray(x, jnp.bfloat16),
                                {k: v.astype(jnp.bfloat16)
                                 for k, v in jp.items()}, cfg)
    ty, _ = tmoe.moe_ffn(torch.from_numpy(x).bfloat16(),
                         tp.to(torch.bfloat16), tcfg)
    assert ty.dtype == torch.bfloat16
    scale = np.abs(np32(jy)).max()
    assert_allclose(ty.float().numpy(), np32(jy), rtol=3e-2,
                    atol=3e-2 * scale)


# ---------------------------------------------------------------------------
# the grouped GEMM's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 32, 24), (3, 37, 65, 41),
                                   (1, 128, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_ref_matches_pallas(shape, dtype):
    E, C, d, f = shape
    r = np.random.default_rng(30)
    x = r.standard_normal((E, C, d)).astype(np.float32)
    w = r.standard_normal((E, d, f)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    want = jops.grouped_matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                               block_c=16, block_f=16, block_d=32)
    before = ops.COUNTERS["grouped_matmul"].value
    got = ops.grouped_matmul(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(w).to(tdt))
    assert ops.COUNTERS["grouped_matmul"].value == before
    assert got.dtype == tdt and tuple(got.shape) == (E, C, f)
    tol = 2e-4 if dtype == "float32" else 3e-2
    assert_allclose(got.float().numpy(), np32(want), rtol=tol, atol=tol)
    assert_allclose(ref.grouped_matmul_ref(torch.from_numpy(x),
                                           torch.from_numpy(w)).numpy(),
                    np32(jref.grouped_matmul_ref(jnp.asarray(x),
                                                 jnp.asarray(w))),
                    rtol=2e-4, atol=2e-4)


def test_grouped_matmul_wrapper_refuses_host_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgmm.grouped_matmul(torch.ones(2, 8, 16), torch.ones(2, 16, 4))


# ---------------------------------------------------------------------------
# the model and the engine
# ---------------------------------------------------------------------------

def close_cache(got, want):
    assert set(got) == set(want) == {"k", "v"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.bfloat16
        assert_allclose(got[k].float().numpy(), np32(want[k]), err_msg=k,
                        rtol=1e-2, atol=BF16)


def test_forward_matches_jax(models):
    cfg, params, _, model = models
    toks = tokens(40, seed=1, batch=2)
    want, _ = forward_train(params, cfg, jnp.asarray(toks))
    got = model(torch.from_numpy(toks))
    assert_allclose(got.numpy(), np.asarray(want), rtol=F32, atol=F32)


def test_prefill_and_decode_match_jax(models):
    cfg, params, tcfg, model = models
    toks = tokens(37, seed=2)
    jl, jc = jprefill(params, cfg, jnp.asarray(toks), capacity=48)
    tl, tc = prefill(model, torch.from_numpy(toks), capacity=48)
    assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32, atol=F32)
    close_cache(tc, jc)
    assert {k: tuple(v) for k, v in cache_defs(tcfg, 1, 48).items()} == \
        {k: v.shape for k, v in jc.items()}
    tok = np.array(jnp.argmax(jl, -1))
    jl2, jc2 = jdecode_step(params, cfg, jc, jnp.asarray(tok),
                            jnp.asarray(37))
    tl2, tc2 = decode_step(model, tc, torch.from_numpy(tok).long(), 37)
    assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=DECODE, atol=DECODE)
    close_cache(tc2, jc2)


def _record(fn, store):
    def wrapped(*args):
        logits, cache = fn(*args)
        store.append(np32(logits))
        return logits, cache
    return wrapped


def test_serve_engine_greedy_tokens_match_jax(models):
    """Three requests through two slots (the third joins mid-flight): the
    same greedy tokens from both engines."""
    cfg, params, tcfg, model = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (20, 37, 9)]
    jeng = JServeEngine(cfg, params, slots=2, capacity=64, temperature=0.0)
    seen = []
    jeng._prefill1 = _record(jeng._prefill1, seen)
    jeng._decode = _record(jeng._decode, seen)
    teng = ServeEngine(tcfg, model, slots=2, capacity=64, temperature=0.0,
                       device="cpu")
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, max_new=6)
    want = {r.rid: r.out for r in jeng.run_to_completion()}
    got = {r.rid: r.out for r in teng.run_to_completion()}
    assert len(want) == 3 and all(len(o) == 6 for o in want.values())
    for logits in seen:
        top2 = np.sort(logits, axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0] > DECODE).all()
    assert got == want


def test_cpu_serving_launches_no_kernel(models):
    _, _, tcfg, model = models
    before = {k: c.value for k, c in ops.COUNTERS.items()}
    prefill(model, torch.from_numpy(tokens(20, seed=6)))
    assert {k: c.value for k, c in ops.COUNTERS.items()} == before


def test_launch_serve_runs_granite_on_the_cpu(capsys):
    from repro_torch.launch import serve as tlaunch
    rc = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4",
                       "--capacity", "32"])
    assert rc == 0
    assert "3 requests, 12 tokens" in capsys.readouterr().out
