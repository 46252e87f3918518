"""The decode step's four kernels (``ops.rmsnorm``, ``ops.rope_cache_write``,
``ops.decode_attention``, ``ops.ssd_decode_step``) on the CPU.

- Each plain version (``kernels/ref.py``) against its JAX counterpart on
  the same numpy inputs: ``rmsnorm`` (also after a residual add),
  ``apply_rope`` with ``update_cache``, ``decode_attention`` and
  ``ssd_decode`` (through the port's ``ssm.ssd_decode``, whose unsharded
  step calls ``ops``), in float32 (rtol 1e-5) and bf16 (3e-2, as
  ``tests/test_kernels.py``); a ``hypothesis`` case over the position
  (before the window, past it, past the cache's end, below 0), the window,
  a rolling cache, the GQA group, the head dim and the softcap.
- The split-KV attention's plan and arithmetic, emulated in float32 (the
  splits' maxima, weights and sums, merged in order; the valid rows as one
  range, a uniform softmax where none is valid), against the plain
  version over the same cases.
- An int position and a 0-d tensor position give the same bits.
- The wrappers' argument checks (run by the card's wrappers and by the
  ``meta`` stand-ins) refuse shapes, dtypes, head dims, groups and
  positions the kernels do not take with ``ValueError``.
- A ``meta`` decode step of each family's smoke config counts each kernel
  by its formula (``launch/op_analysis.py``): 2 L + 1 norms (whisper 3 L +
  1), one rope write and one attention an attention layer (whisper two
  attentions), one SSD step a Mamba2 layer; the work is the formulas'.

The kernels themselves (``csrc/{rmsnorm,rope_cache,decode_attention,
ssd_decode}.cu``) run only on a card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s ``decode kernels`` part hold them to these plain
versions.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from numpy.testing import assert_allclose

from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs import get_smoke
from repro_torch.kernels import decode_step as dec
from repro_torch.kernels import ops, ref
from repro_torch.launch import roofline as rl
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.models import LM, decode_step, init_cache
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import rope_frequencies
from repro_torch.models.ssm import init_conv_state, ssm_defs

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def np32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def both(a: np.ndarray, dtype: str):
    """``a`` as a port tensor and a JAX array of one dtype (the same
    values: bf16 rounding happens once, in numpy's float32 -> torch)."""
    tdt, jdt, _ = DTYPES[dtype]
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(tdt)
    return t, jnp.asarray(t.float().numpy(), jdt)


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_ref_matches_jax(dtype, residual):
    rng = np.random.default_rng(0)
    x, jx = both(rng.standard_normal((3, 1, 1280)) * 3, dtype)
    r, jr = both(rng.standard_normal((3, 1, 1280)), dtype)
    s, js = both(1 + 0.1 * rng.standard_normal(1280), dtype)
    tol = DTYPES[dtype][2]
    if residual:
        got_sum, got = ref.rmsnorm_ref(x, s, 1e-5, residual=r)
        jsum = jx + jr
        assert_allclose(got_sum.float().numpy(), np32(jsum), rtol=tol,
                        atol=tol)
    else:
        got, jsum = ref.rmsnorm_ref(x, s, 1e-5), jx
    want = jlayers.rmsnorm(jsum, {"scale": js}, 1e-5)
    assert got.dtype == x.dtype
    assert_allclose(got.float().numpy(), np32(want), rtol=tol, atol=tol)


def _rope_case(rng, dtype, B, H, KV, hd, S):
    q, jq = both(rng.standard_normal((B, 1, H, hd)), dtype)
    k, jk = both(rng.standard_normal((B, 1, KV, hd)), dtype)
    v, jv = both(rng.standard_normal((B, 1, KV, hd)), dtype)
    kc, jkc = both(rng.standard_normal((B, S, KV, hd)), dtype)
    vc, jvc = both(rng.standard_normal((B, S, KV, hd)), dtype)
    return (q, k, v, kc, vc), (jq, jk, jv, jkc, jvc)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pos,window,S", [
    (5, None, 16), (40, None, 16), (0, None, 8),      # past the end: clamped
    (21, 16, 16), (15, 16, 16), (37, 8, 8)])          # rolling caches
@pytest.mark.parametrize("rope", [True, False])
def test_rope_cache_ref_matches_jax(dtype, pos, window, S, rope):
    B, H, KV, hd, theta = 2, 4, 2, 16, 10_000.0
    rng = np.random.default_rng(pos)
    (q, k, v, kc, vc), (jq, jk, jv, jkc, jvc) = _rope_case(
        rng, dtype, B, H, KV, hd, S)
    freqs = rope_frequencies(hd, theta) if rope else None
    got_q = ref.rope_cache_ref(q, k, v, kc, vc, pos, freqs=freqs,
                               window=window)
    if rope:
        positions = jnp.full((1, 1), pos)
        jq = jlayers.apply_rope(jq, positions, theta)
        jk = jlayers.apply_rope(jk, positions, theta)
    jkc, jvc = jattn.update_cache(jkc, jvc, jk, jv, pos, window=window)
    tol = DTYPES[dtype][2]
    for got, want in ((got_q, jq), (kc, jkc), (vc, jvc)):
        assert got.dtype == DTYPES[dtype][0]
        assert_allclose(got.float().numpy(), np32(want), rtol=tol, atol=tol)
    if not rope:
        assert got_q is q


def _attn_case(rng, dtype, B, KV, G, hd, S):
    q, jq = both(rng.standard_normal((B, 1, KV * G, hd)), dtype)
    kc, jkc = both(rng.standard_normal((B, S, KV, hd)) * 2, dtype)
    vc, jvc = both(rng.standard_normal((B, S, KV, hd)), dtype)
    return (q, kc, vc), (jq, jkc, jvc)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("G,hd,pos,window,cap", [
    (1, 64, 9, None, 0.0), (3, 64, 20, None, 0.0), (2, 256, 30, 16, 50.0),
    (6, 128, 63, None, 0.0), (2, 80, 100, None, 0.0), (12, 16, 5, 4, 30.0)])
def test_decode_attention_ref_matches_jax(dtype, G, hd, pos, window, cap):
    B, KV, S = 2, 2, 40
    rng = np.random.default_rng(G * hd)
    (q, kc, vc), (jq, jkc, jvc) = _attn_case(rng, dtype, B, KV, G, hd, S)
    got = ref.decode_attention_ref(q, kc, vc, pos=pos, window=window,
                                   logit_cap=cap, scale=0.3)
    want = jattn.decode_attention(jq, jkc, jvc, pos=jnp.asarray(pos),
                                  window=window, logit_cap=cap, scale=0.3)
    tol = DTYPES[dtype][2]
    assert got.dtype == q.dtype
    assert_allclose(got.float().numpy(), np32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_decode_matches_jax(dtype):
    """The port's unsharded ``ssd_decode`` (projections, ``ops.ssd_decode_
    step``'s plain version, ``ops.rmsnorm``, the output projection) against
    the reference's on the same parameters, state and conv buffers: y, the
    state and the conv buffers."""
    cfg, jcfg = get_smoke("zamba2-2.7b"), jget_smoke("zamba2-2.7b")
    rng = np.random.default_rng(4)
    tp, jp = {}, {}
    for name, d in ssm_defs(cfg).items():
        tp[name], jp[name] = both(rng.standard_normal(d.shape) * 0.5, dtype)
    B, s = 3, cfg.ssm
    nh = s.n_heads(cfg.d_model)
    x, jx = both(rng.standard_normal((B, 1, cfg.d_model)), dtype)
    h = torch.from_numpy(rng.standard_normal(
        (B, nh, s.d_state, s.head_dim)).astype(np.float32))
    jh = jnp.asarray(h.numpy())
    conv = init_conv_state(cfg, B)
    for k, t in conv.items():
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(
            np.float32)))
    jconv = {k: jnp.asarray(t.float().numpy(), jnp.bfloat16)
             for k, t in conv.items()}
    wy, wh, wconv = jssm.ssd_decode(jx, jp, jcfg, h=jh, conv_state=jconv)
    y, h_out, conv_out = tssm.ssd_decode(x, tp, cfg, h=h, conv_state=conv)
    assert h_out is h and conv_out is conv            # updated in place
    tol = DTYPES[dtype][2]
    assert_allclose(y.float().numpy(), np32(wy), rtol=tol, atol=tol)
    assert_allclose(h.numpy(), np32(wh), rtol=tol, atol=tol)
    for k in conv:
        assert_allclose(conv[k].float().numpy(), np32(wconv[k]), rtol=tol,
                        atol=tol)


# ---------------------------------------------------------------------------
# the split-KV attention's arithmetic, emulated
# ---------------------------------------------------------------------------

def split_attention(q, k_cache, v_cache, pos, window, cap, scale, sms):
    """csrc/decode_attention.cu's arithmetic in float32: the valid rows as
    one range (all rows at weight 1 where none is valid), each split's
    max, weights and sums, the splits merged in order."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    rows, splits = dec.split_plan(B, KV, S, sms)
    assert rows % 16 == 0 and rows <= dec.MAX_SPLIT_ROWS
    assert splits * rows >= S > (splits - 1) * rows
    hi = min(pos, S - 1)
    lo = max(0, pos - window + 1) if window is not None and S > window \
        else 0
    uniform = hi < lo
    if uniform:
        lo, hi = 0, S - 1
    out = torch.empty((B, H, hd), dtype=torch.float32)
    for b in range(B):
        for kv in range(KV):
            qg = q[b, 0, kv * G:(kv + 1) * G].float()
            parts = []
            for sp in range(splits):
                a, e = max(sp * rows, lo), min(sp * rows + rows - 1, hi)
                if e < a:
                    continue
                kk = k_cache[b, a:e + 1, kv].float()
                s = (torch.zeros((G, e - a + 1)) if uniform
                     else (qg @ kk.T) * scale)
                if cap and not uniform:
                    s = cap * torch.tanh(s / cap)
                m = s.max(-1).values
                p = torch.exp(s - m[:, None])
                parts.append((m, p.sum(-1),
                              p @ v_cache[b, a:e + 1, kv].float()))
            M = torch.stack([m for m, _, _ in parts]).max(0).values
            num = sum(torch.exp(m - M)[:, None] * o for m, _, o in parts)
            den = sum(torch.exp(m - M) * l for m, l, _ in parts)
            out[b, kv * G:(kv + 1) * G] = num / den[:, None]
    return out[:, None].to(q.dtype)


@settings(max_examples=30, deadline=None)
@given(pos=st.integers(-3, 90), window=st.sampled_from([None, 8, 24]),
       rolling=st.booleans(), G=st.sampled_from([1, 2, 3, 6, 12]),
       hd=st.sampled_from([16, 64, 80, 128, 256]),
       cap=st.sampled_from([0.0, 50.0]), sms=st.sampled_from([1, 132]),
       seed=st.integers(0, 2 ** 16))
def test_decode_attention_cases(pos, window, rolling, G, hd, cap, sms, seed):
    """Over positions before the window, past it, past the cache's end and
    below 0, rolling caches (rows = window) and longer ones: the plain
    version against the JAX package's in float32, an int position against
    a tensor one bit for bit, and the split-KV emulation against the plain
    version (at an H100's 132 SMs and at one, which cuts the rows into
    more splits)."""
    B, KV = 2, 2
    S = window if rolling and window is not None else 40
    rng = np.random.default_rng(seed)
    (q, kc, vc), (jq, jkc, jvc) = _attn_case(rng, "float32", B, KV, G, hd, S)
    kw = dict(window=window, logit_cap=cap, scale=1.0 / math.sqrt(hd))
    got = ref.decode_attention_ref(q, kc, vc, pos=pos, **kw)
    if pos >= 0:     # the reference masks every row below 0 alike
        want = jattn.decode_attention(jq, jkc, jvc, pos=jnp.asarray(pos),
                                      **kw)
        assert_allclose(got.numpy(), np32(want), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ref.decode_attention_ref(
        q, kc, vc, pos=torch.tensor(pos), **kw))
    emu = split_attention(q, kc, vc, pos, window, cap, kw["scale"], sms)
    assert_allclose(emu.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


@settings(max_examples=20, deadline=None)
@given(pos=st.integers(-3, 60), window=st.sampled_from([None, 8, 16]),
       rolling=st.booleans(), hd=st.sampled_from([16, 64, 80]),
       rope=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_rope_cache_int_and_tensor_positions_agree(pos, window, rolling, hd,
                                                   rope, seed):
    S = window if rolling and window is not None else 24
    runs = []
    for p in (pos, torch.tensor(pos)):
        (q, k, v, kc, vc), _ = _rope_case(np.random.default_rng(seed),
                                          "bfloat16", 2, 4, 2, hd, S)
        qo = ref.rope_cache_ref(q, k, v, kc, vc, p, window=window,
                                freqs=rope_frequencies(hd, 1e4) if rope
                                else None)
        runs.append((qo, kc, vc))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the argument checks
# ---------------------------------------------------------------------------

def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", [
    "x int", "scale shape", "residual dtype", "residual shape"])
def test_rmsnorm_refuses(case):
    x, s, r = meta(4, 1, 64), meta(64), None
    if case == "x int":
        x = meta(4, 1, 64, dtype=torch.int32)
    elif case == "scale shape":
        s = meta(32)
    elif case == "residual dtype":
        r = meta(4, 1, 64, dtype=torch.float32)
    else:
        r = meta(4, 1, 32)
    with pytest.raises(ValueError):
        ops.rmsnorm(x, s, 1e-5, residual=r)


@pytest.mark.parametrize("case", [
    "odd head dim", "q two tokens", "k heads", "v dtype", "cache shape",
    "cache strided", "freqs dtype", "freqs shape", "position float",
    "position vector", "position int32"])
def test_rope_cache_write_refuses(case):
    B, H, KV, S, hd = 2, 4, 2, 16, 64
    q, k, v = meta(B, 1, H, hd), meta(B, 1, KV, hd), meta(B, 1, KV, hd)
    kc, vc = meta(B, S, KV, hd), meta(B, S, KV, hd)
    freqs = meta(hd // 2, dtype=torch.float32)
    pos = 3
    if case == "odd head dim":
        q, k, v = meta(B, 1, H, 63), meta(B, 1, KV, 63), meta(B, 1, KV, 63)
        kc, vc = meta(B, S, KV, 63), meta(B, S, KV, 63)
        freqs = meta(31, dtype=torch.float32)
    elif case == "q two tokens":
        q = meta(B, 2, H, hd)
    elif case == "k heads":
        k = meta(B, 1, 3, hd)
    elif case == "v dtype":
        v = meta(B, 1, KV, hd, dtype=torch.float32)
    elif case == "cache shape":
        kc = meta(B, S, KV, hd // 2)
    elif case == "cache strided":
        kc = meta(B, KV, S, hd).transpose(1, 2)
    elif case == "freqs dtype":
        freqs = meta(hd // 2)
    elif case == "freqs shape":
        freqs = meta(hd, dtype=torch.float32)
    elif case == "position float":
        pos = 3.0
    elif case == "position vector":
        pos = torch.zeros((1,), dtype=torch.int64, device="meta")
    else:
        pos = torch.zeros((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.rope_cache_write(q, k, v, kc, vc, pos, freqs=freqs)


@pytest.mark.parametrize("case", [
    "head dim 512", "odd head dim", "group 24", "heads not a multiple",
    "q dtype", "cache dtypes differ", "cache strided", "position cpu"])
def test_decode_attention_refuses(case):
    B, H, KV, S, hd = 2, 4, 2, 16, 64
    q, kc, vc = meta(B, 1, H, hd), meta(B, S, KV, hd), meta(B, S, KV, hd)
    pos = 5
    if case == "head dim 512":
        q, kc, vc = meta(B, 1, H, 512), meta(B, S, KV, 512), \
            meta(B, S, KV, 512)
    elif case == "odd head dim":
        q, kc, vc = meta(B, 1, H, 65), meta(B, S, KV, 65), meta(B, S, KV, 65)
    elif case == "group 24":
        q = meta(B, 1, 48, hd)
    elif case == "heads not a multiple":
        q = meta(B, 1, 5, hd)
    elif case == "q dtype":
        q = meta(B, 1, H, hd, dtype=torch.float16)
    elif case == "cache dtypes differ":
        vc = meta(B, S, KV, hd, dtype=torch.float32)
    elif case == "cache strided":
        vc = meta(B, KV, S, hd).transpose(1, 2)
    else:
        pos = torch.tensor(5)
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc, vc, pos=pos)


def _ssd_args(cfg, B=2, dtype=torch.bfloat16):
    s = cfg.ssm
    nh, di, ds = s.n_heads(cfg.d_model), s.d_inner(cfg.d_model), s.d_state
    p = {k: meta(*d.shape, dtype=dtype) for k, d in ssm_defs(cfg).items()}
    conv = {k: meta(*t.shape) for k, t in init_conv_state(
        cfg, B, device="meta").items()}
    return dict(z=meta(B, 1, di, dtype=dtype), x=meta(B, 1, di, dtype=dtype),
                B=meta(B, 1, ds, dtype=dtype), C=meta(B, 1, ds, dtype=dtype),
                dt=meta(B, 1, nh, dtype=dtype), p=p,
                h=meta(B, nh, ds, s.head_dim, dtype=torch.float32),
                conv=conv)


@pytest.mark.parametrize("case", [
    "h bf16", "h shape", "dt_bias dtype", "conv weight shape",
    "buffer shape", "buffer strided", "head dim 6", "conv depth 9"])
def test_ssd_decode_step_refuses(case):
    cfg = get_smoke("zamba2-2.7b")
    a = _ssd_args(cfg)
    s = cfg.ssm
    nh, di, ds = s.n_heads(cfg.d_model), s.d_inner(cfg.d_model), s.d_state
    if case == "h bf16":
        a["h"] = meta(*a["h"].shape)
    elif case == "h shape":
        a["h"] = meta(2, nh, s.head_dim, ds + 1, dtype=torch.float32)
    elif case == "dt_bias dtype":
        a["p"]["dt_bias"] = meta(nh, dtype=torch.float32)
    elif case == "conv weight shape":
        a["p"]["conv_B"] = meta(s.conv_dim, ds + 2)
    elif case == "buffer shape":
        a["conv"]["x"] = meta(2, s.conv_dim, di)
    elif case == "buffer strided":
        a["conv"]["C"] = meta(2, ds, s.conv_dim - 1).transpose(1, 2)
    elif case == "head dim 6":
        a["dt"] = meta(2, 1, di // 6)
        a["p"].update(dt_bias=meta(di // 6), A_log=meta(di // 6),
                      D=meta(di // 6))
        a["h"] = meta(2, di // 6, ds, 6, dtype=torch.float32)
    else:
        K = 9
        a["p"].update(conv_x=meta(K, di), conv_B=meta(K, ds),
                      conv_C=meta(K, ds))
        a["conv"] = {"x": meta(2, K - 1, di), "B": meta(2, K - 1, ds),
                     "C": meta(2, K - 1, ds)}
    with pytest.raises(ValueError):
        ops.ssd_decode_step(a["z"], a["x"], a["B"], a["C"], a["dt"], a["p"],
                            h=a["h"], conv=a["conv"])


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU, ``ops`` calls the plain versions and never a card
    wrapper (each would raise)."""
    for name in ("rmsnorm", "rope_cache_write", "decode_attention",
                 "ssd_decode_step"):
        def refuse(*a, _n=name, **kw):
            raise AssertionError(f"the card's {_n} ran on the CPU")
        monkeypatch.setattr(dec, name, refuse)
    cfg = get_smoke("zamba2-2.7b")
    model = LM(cfg, generator=torch.Generator().manual_seed(0))
    cache = init_cache(cfg, 2, 24)
    before = {c.name: c.value for c in (dec.rms_launches, dec.rope_launches,
                                        dec.attn_launches, dec.ssd_launches)}
    logits, _ = decode_step(model, cache, torch.tensor([1, 2]), 3)
    assert torch.isfinite(logits).all()
    assert before == {c.name: c.value for c in (
        dec.rms_launches, dec.rope_launches, dec.attn_launches,
        dec.ssd_launches)}


# ---------------------------------------------------------------------------
# the dry-run: a meta decode step counts each kernel by its formula
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-1.3b", "zamba2-2.7b",
                                  "gemma2-2b", "granite-moe-3b-a800m",
                                  "whisper-large-v3"])
def test_meta_decode_step_counts_the_decode_kernels(arch):
    cfg = get_smoke(arch)
    B, S = 2, 48
    pos = S - 5
    model = LM(cfg, device="meta")
    cache = init_cache(cfg, B, S, device="meta")
    token = torch.empty((B,), dtype=torch.int64, device="meta")
    with OpAnalysis() as oa:
        decode_step(model, cache, token, pos)
    calls = oa.analysis.kernel_calls
    L = cfg.n_layers
    n_attn = sum(cfg.is_attention_layer(i) for i in range(L))
    n_ssm = L - n_attn
    cross = L if cfg.enc_dec else 0
    want = {"rmsnorm": 2 * L + 1 + cross, "rope_cache_write": n_attn,
            "decode_attention": n_attn + cross, "ssd_decode_step": n_ssm}
    if cfg.moe is not None:
        want["grouped_matmul"] = 3 * L
    assert calls == {k: n for k, n in want.items() if n}
    # each call's work by the formulas, at this step's shapes
    d, dt = cfg.d_model, torch.bfloat16
    norms = [rl.rmsnorm_work(B, d, dt, dt, False)] * (1 + n_attn + n_ssm) \
        + [rl.rmsnorm_work(B, d, dt, dt, True)] * (n_attn + cross)
    if n_ssm:
        di = cfg.ssm.d_inner(d)
        norms += [rl.rmsnorm_work(B, di, dt, dt, False)] * n_ssm
    assert oa.analysis.kernel_flops["rmsnorm"] == sum(f for f, _ in norms)
    assert oa.analysis.kernel_bytes["rmsnorm"] == sum(b for _, b in norms)
    if n_attn:
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        rows = []
        for i in range(L):
            if not cfg.is_attention_layer(i):
                continue
            rolling = (cfg.local_global_pattern and i % 2 == 0
                       and cache["k_local"].shape[2] == cfg.sliding_window)
            W = cfg.sliding_window if rolling else None
            rows.append(rl.decode_rows(S if not rolling else W, pos, W))
        rows += [cfg.enc_frames] * cross
        work = [rl.decode_attention_work(B, H, KV, r, hd, dt, dt)
                for r in rows]
        assert oa.analysis.kernel_bytes["decode_attention"] == \
            sum(b for _, b in work)
        rope = rl.rope_cache_work(B, H, KV, hd, dt, dt, cfg.use_rope)
        assert oa.analysis.kernel_bytes["rope_cache_write"] == \
            n_attn * rope[1]
    if n_ssm:
        s = cfg.ssm
        work = rl.ssd_decode_work(B, s.n_heads(d), s.head_dim, s.d_state,
                                  s.conv_dim, dt, torch.bfloat16)
        assert oa.analysis.kernel_flops["ssd_decode_step"] == n_ssm * work[0]


def test_decode_rows_and_split_plan():
    assert rl.decode_rows(40, 9, None) == 10
    assert rl.decode_rows(40, 100, None) == 40          # past the end
    assert rl.decode_rows(40, 30, 16) == 16             # inside the window
    assert rl.decode_rows(16, 30, 16) == 16             # rolling
    assert rl.decode_rows(40, -1, None) == 40           # uniform
    assert rl.decode_rows(40, None, None) == 40
    for B, KV, S in ((4, 8, 2048), (4, 32, 2048), (4, 20, 1500), (1, 1, 7),
                     (128, 8, 32768), (4, 4, 4096)):
        rows, splits = dec.split_plan(B, KV, S, 132)
        assert rows % 16 == 0 and 32 <= rows <= dec.MAX_SPLIT_ROWS
        assert (splits - 1) * rows < S <= splits * rows
    # B KV blocks a split: splits to fill the card eight times over
    # (granite's 32 take 32 of 64 rows), never fewer rows than 32
    assert dec.split_plan(4, 8, 2048, 132) == (64, 32)
    assert dec.split_plan(4, 32, 2048, 132) == (240, 9)
    assert dec.split_plan(1, 1, 7, 132) == (32, 1)
