"""The port's LM serving path against the JAX package on the CPU: zamba2's
``smoke()`` configuration (4 layers, d_model 64), float32 parameters made
by ``repro.models.init_tree`` and carried across by ``from_jax_params``.

Tolerances, each with its reason:
- float32 activations (SSM outputs and state, prefill and forward logits):
  ``F32`` = 2e-4 — the same function summed in another order (the port's
  SSD is the token-by-token recurrence, JAX's the chunked scan);
- tensors the cache stores in bf16 (k, v, conv buffers): ``BF16`` = 2e-2
  with rtol 1e-2 — float32 values a few 1e-6 apart may round to
  neighbouring bf16 numbers (one bf16 step is 2^-8 relative);
- decode logits, which read those bf16 rows: ``DECODE`` = 1e-3;
- greedy tokens: identical, and the test checks that the JAX run's top-2
  logit gap exceeds ``DECODE`` at every step, so no comparison rests on a
  near tie.
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
from repro.models import decode_step as jdecode_step
from repro.models import forward_train, init_tree, model_defs
from repro.models import prefill as jprefill
from repro.models import ssm as jssm
from repro.runtime import ServeEngine as JServeEngine
from repro_torch import configs
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import serve as tlaunch
from repro_torch.models import (LM, cache_defs, decode_step, from_jax_params,
                                init_cache, prefill)
from repro_torch.models import ssm as tssm
from repro_torch.runtime import ServeEngine

torch.set_num_threads(1)

F32 = 2e-4
BF16 = 2e-2
DECODE = 1e-3
ARCH = "zamba2-2.7b"


@pytest.fixture(scope="module")
def models():
    cfg = jget_smoke(ARCH)
    params = init_tree(jax.random.PRNGKey(0), model_defs(cfg),
                       dtype=jnp.float32)
    tcfg = configs.get_smoke(ARCH)
    model = from_jax_params(tcfg, jax.device_get(params))
    return cfg, params, tcfg, model


def tokens(n, seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (1, n))


def np32(a):
    return np.asarray(a, dtype=np.float32)


def close_cache(got, want):
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        tol = (dict(rtol=F32, atol=F32) if k == "h"
               else dict(rtol=1e-2, atol=BF16))
        assert_allclose(got[k].float().numpy(), np32(want[k]),
                        err_msg=k, **tol)


def test_config_is_the_jax_packages(models):
    cfg, params, tcfg, model = models
    full, jfull = configs.get_config(ARCH), jget_config(ARCH)
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab", "hybrid_attn_every"):
        assert getattr(full, name) == getattr(jfull, name)
        assert getattr(tcfg, name) == getattr(cfg, name)
    assert full.param_count() == jfull.param_count()
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(params))


def test_registry_names_the_ported_archs():
    """An arch the port lacks raises KeyError naming the ten it has, the
    JAX package's; a family the port does not know raises ValueError
    naming those it runs."""
    with pytest.raises(KeyError, match="zamba2-2.7b.*whisper-large-v3"):
        configs.get_config("llama-7b")
    assert len(configs.arch_names()) == 10
    from repro_torch.models.config import ModelConfig
    j = jget_smoke("whisper-large-v3")
    odd = ModelConfig(**{f: getattr(j, f) for f in
                         ModelConfig.__dataclass_fields__})
    odd = dataclasses.replace(odd, family="video")
    with pytest.raises(ValueError, match="unknown family 'video'.*audio"):
        LM(odd)


def test_ssd_prefill_and_decode_match_jax(models):
    cfg, params, tcfg, model = models
    jp = jax.tree.map(lambda a: a[0, 0], params["layers"]["mamba"])["ssm"]
    tp = model.layers[0].mamba[0]["ssm"]
    x = np.random.default_rng(3).standard_normal((2, 37, 64)).astype(
        np.float32)
    # 37 = two chunks of 16 and a tail of 5
    jy, jh, jconv = jssm.ssd_prefill(jnp.asarray(x), jp, cfg)
    ty, th, tconv = tssm.ssd_prefill(torch.from_numpy(x), tp, tcfg)
    assert_allclose(ty.numpy(), np.asarray(jy), rtol=F32, atol=F32)
    assert_allclose(th.numpy(), np.asarray(jh), rtol=F32, atol=F32)
    for k in jconv:
        assert_allclose(tconv[k].float().numpy(), np32(jconv[k]), rtol=1e-2,
                        atol=BF16)
    x1 = np.random.default_rng(4).standard_normal((2, 1, 64)).astype(
        np.float32)
    jy1, jh1, _ = jssm.ssd_decode(jnp.asarray(x1), jp, cfg, h=jh,
                                  conv_state=jconv)
    ty1, th1, _ = tssm.ssd_decode(torch.from_numpy(x1), tp, tcfg, h=th,
                                  conv_state=tconv)
    assert_allclose(ty1.numpy(), np.asarray(jy1), rtol=DECODE, atol=DECODE)
    assert_allclose(th1.numpy(), np.asarray(jh1), rtol=F32, atol=F32)


def test_forward_matches_jax(models):
    cfg, params, _, model = models
    toks = tokens(40, seed=1)
    want, _ = forward_train(params, cfg, jnp.asarray(toks))
    got = model(torch.from_numpy(toks))
    assert_allclose(got.numpy(), np.asarray(want), rtol=F32, atol=F32)


def test_prefill_and_decode_match_jax(models):
    cfg, params, tcfg, model = models
    toks = tokens(37, seed=2)            # a ragged prompt: 2 chunks + 5
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
    """Three requests through two slots (the third joins mid-flight), two
    of them with a ragged tail: the same greedy tokens from both engines."""
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


def test_serve_engine_reports_each_step(models):
    """``on_step`` sees one prefill per request with its prompt length and
    one call per decode step with its active slots, with the step's
    logits; the decode calls count every token after each first one."""
    _, _, tcfg, model = models
    seen = []
    eng = ServeEngine(tcfg, model, slots=2, capacity=64, temperature=0.0,
                      device="cpu",
                      on_step=lambda *a: seen.append(a))
    for n in (20, 37, 9):
        eng.submit(tokens(n, seed=n)[0].tolist(), max_new=4)
    done = eng.run_to_completion()
    prefills = [a for a in seen if a[0] == "prefill"]
    decodes = [a for a in seen if a[0] == "decode"]
    assert [a[1] for a in prefills] == [20, 37, 9]
    assert all(a[3].shape == (1, tcfg.vocab) for a in prefills)
    assert all(a[3].shape == (2, tcfg.vocab) and 1 <= a[1] <= 2
               for a in decodes)
    assert sum(a[1] for a in decodes) == sum(len(r.out) - 1 for r in done)
    assert all(a[2] > 0 for a in seen)


def test_serve_engine_needs_a_card_unless_asked_for_the_cpu(models,
                                                            monkeypatch):
    _, _, tcfg, model = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tcfg, model, slots=2, capacity=32)
    eng = ServeEngine(tcfg, model, slots=2, capacity=32, device="cpu")
    assert eng.cache["k"].device.type == "cpu"


def test_init_cache_layout_and_dtypes(models):
    _, _, tcfg, _ = models
    c = init_cache(tcfg, 3, 32)
    assert c["h"].dtype == torch.float32
    assert all(c[k].dtype == torch.bfloat16 for k in c if k != "h")
    assert tuple(c["k"].shape) == (2, 3, 32, 4, 16)
    assert tuple(c["h"].shape) == (2, 1, 3, 8, 16, 16)
    h = tssm.init_ssm_state(tcfg, 3)
    conv = tssm.init_conv_state(tcfg, 3)
    assert h.shape == c["h"][0, 0].shape and h.dtype == torch.float32
    for k in ("x", "B", "C"):
        assert conv[k].shape == c["conv_" + k][0, 0].shape
        assert conv[k].dtype == torch.bfloat16


def test_model_init_follows_the_scale_rules():
    cfg = configs.get_smoke(ARCH)
    m = LM(cfg, dtype=torch.float32,
           generator=torch.Generator().manual_seed(0))
    blk = m.layers[0].mamba[0]
    assert torch.equal(blk["ln1"]["scale"], torch.ones(64))
    assert torch.equal(blk["ssm"]["dt_bias"], torch.zeros(8))
    w = m.layers[0].attn["ffn"]["w_in"]           # (64, 128): fan_in 64
    assert abs(w.std().item() - 64 ** -0.5) < 0.01
    m2 = LM(cfg, dtype=torch.float32,
            generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 m2.parameters()))


@pytest.mark.parametrize("call", [
    lambda: tflash.flash_attention(*(torch.ones(1, 2, 8, 16),) * 3),
    lambda: tflash.flash_attention_bshd(*(torch.ones(1, 8, 2, 16),) * 3),
    lambda: tssd.ssd_scan(torch.ones(1, 16, 32), torch.ones(1, 16, 2),
                          torch.ones(1, 16, 16), torch.ones(1, 16, 16),
                          -torch.ones(2), chunk=16),
    lambda: tssd.ssd_scan_backward(
        torch.ones(1, 16, 32), torch.ones(1, 16, 2), torch.ones(1, 16, 16),
        torch.ones(1, 16, 16), -torch.ones(2), None,
        torch.ones(1, 1, 2, 16, 16), torch.ones(1, 2, 16),
        torch.ones(1, 16, 32), None, chunk=16),
], ids=["flash_attention", "flash_attention_bshd", "ssd_scan",
        "ssd_scan_backward"])
def test_kernel_wrappers_refuse_host_tensors(call):
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()


def test_cpu_serving_launches_no_kernel(models):
    _, _, tcfg, model = models
    before = {k: c.value for k, c in ops.COUNTERS.items()}
    prefill(model, torch.from_numpy(tokens(20, seed=6)))
    assert {k: c.value for k, c in ops.COUNTERS.items()} == before


def test_launch_serve_runs_on_the_cpu(capsys):
    rc = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4",
                       "--capacity", "32"])
    assert rc == 0
    assert "3 requests, 12 tokens" in capsys.readouterr().out
