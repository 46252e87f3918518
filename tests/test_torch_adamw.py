"""AdamW's gradient norm and update over lists of tensors (``ops.grad_sumsq``,
``ops.sum_in_order``, ``ops.adamw_update``) on the CPU.

- The plain versions, through ``optim.AdamW`` and ``global_norm``, against
  the JAX package's ``AdamW.update`` and ``global_norm`` on the same numpy
  inputs: float32 and bf16 parameters, float32 gradients on bf16
  parameters, clipping on and off, a sum of squares that overflows float32
  (the norm inf, the scale 0, the parameters finite: only the decay moves
  them), and the decay mask by path.  Tolerance: float32 parameters rtol
  1e-6 (the existing update test's); the moments rtol 1e-6 and atol 1e-6
  of the moment's largest value (b1 m + (1 - b1) g cancels where m and g
  differ in sign, leaving a rounding of their size); a bf16 parameter
  within one bf16 rounding step (2^-8 relative) of the reference's, since
  the two float32 updates may round a value on either side of a bf16 tie.
- On CPU tensors the optimizer takes the plain versions and never the
  card's wrappers; the card's wrappers refuse a wrong dtype, a tensor that
  is not contiguous, a shape that differs, moments that are not float32,
  and host tensors.
- The C entry points' ctypes signatures; on ``meta`` the stand-ins report
  ``roofline.adamw_work``'s bytes, and a dry-run training step counts the
  ``adamw`` kernel three times and runs none of the eager update's ops.

The kernels themselves (``csrc/adamw.cu``) run only on a card:
``tests/test_torch_cuda.py`` holds them to the plain versions bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim.adamw import global_norm as jglobal_norm
from repro_torch.configs import ShapeSpec, get_smoke
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import adamw as adamw_mod
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.cells import CellConfig
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.optim import AdamW, AdamWConfig, global_norm

torch.set_num_threads(1)

#: names as the port's parameters carry them; the JAX tree nests them by
#: the dots, so both packages see one path ("ssm/A_log")
SHAPES = {"embed.tokens": (37, 16), "attn.wq": (16, 4, 4),
          "attn_norm.scale": (16,), "ssm.A_log": (4,), "ssm.D": (4,),
          "ssm.dt_bias": (4,), "ffn.w_in": (16, 33), "ffn.bias": (33,)}
HYPER = dict(lr=1e-2, weight_decay=0.5)
BF16_STEP = 2.0 ** -8


def nested(flat):
    out = {}
    for k, v in flat.items():
        a, b = k.split(".")
        out.setdefault(a, {})[b] = v
    return out


def flat(tree):
    return {f"{a}.{b}": v for a, sub in tree.items() for b, v in sub.items()}


def draws(seed, steps, grad_scale=1.0):
    """Float32 parameters and ``steps`` gradients, numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (grad_scale * rng.normal(size=s)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def to_bf16_np(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def run_both(p_dtype, g_dtype, clip, steps=2, grad_scale=1.0):
    """The JAX package's jitted update and the port's, ``steps`` times from
    the same draws; returns both sides' parameters, moments and norms as
    float32 numpy dicts."""
    params, grads = draws(0, steps, grad_scale)
    jp_dtype = jnp.bfloat16 if p_dtype == torch.bfloat16 else jnp.float32
    jg_dtype = jnp.bfloat16 if g_dtype == torch.bfloat16 else jnp.float32
    jopt = JAdamW(JAdamWConfig(grad_clip=clip, **HYPER))
    topt = AdamW(AdamWConfig(grad_clip=clip, **HYPER))
    jparams = nested({k: jnp.asarray(v, jp_dtype) for k, v in params.items()})
    # copies: the port updates in place, and jnp.asarray may share the
    # numpy buffers
    tparams = {k: torch.tensor(v).to(p_dtype) for k, v in params.items()}
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    update = jax.jit(jopt.update)
    jnorms, tnorms = [], []
    for g in grads:
        jg = nested({k: jnp.asarray(v, jg_dtype) for k, v in g.items()})
        tg = {k: torch.from_numpy(v).to(g_dtype) for k, v in g.items()}
        jparams, jstate, jn = update(jg, jstate, jparams)
        _, tstate, tn = topt.update(tg, tstate, tparams)
        jnorms.append(float(jn))
        tnorms.append(float(tn))
    as_np = lambda d: {k: np.asarray(v, dtype=np.float32) for k, v in
                       flat(jax.device_get(d)).items()}
    want = dict(p=as_np(jax.tree.map(lambda x: x.astype(jnp.float32),
                                     jparams)),
                m=as_np(jstate.m), v=as_np(jstate.v), norms=jnorms)
    got = dict(p={k: v.float().numpy() for k, v in tparams.items()},
               m={k: v.numpy() for k, v in tstate.m.items()},
               v={k: v.numpy() for k, v in tstate.v.items()}, norms=tnorms)
    return got, want


def assert_close(got, want, p_dtype):
    for k in SHAPES:
        if p_dtype == torch.bfloat16:
            err = np.abs(got["p"][k] - want["p"][k])
            assert np.all(err <= BF16_STEP * np.abs(want["p"][k])), k
        else:
            np.testing.assert_allclose(got["p"][k], want["p"][k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        for mom in ("m", "v"):
            np.testing.assert_allclose(
                got[mom][k], want[mom][k], rtol=1e-6,
                atol=1e-6 * np.abs(want[mom][k]).max(), err_msg=f"{mom} {k}")


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_update_and_norm_match_jax(p_dtype, g_dtype, clip):
    got, want = run_both(p_dtype, g_dtype, clip)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-6)
    if clip:
        assert min(want["norms"]) > clip        # the clip is taken
    assert_close(got, want, p_dtype)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_overflowing_sum_of_squares_gives_scale_zero(p_dtype):
    """Gradients of 1e19: every square is finite or just past float32's
    range and their sum is not, so the norm is inf in both packages, the
    clip's scale 0, and only the decay moves the parameters (m and v decay
    from 0: they stay 0)."""
    got, want = run_both(p_dtype, torch.float32, 1.0, grad_scale=1e19)
    assert got["norms"] == want["norms"] == [np.inf, np.inf]
    assert_close(got, want, p_dtype)
    params, _ = draws(0, 2)
    for k in SHAPES:
        assert np.all(np.isfinite(got["p"][k])), k
        assert not np.any(got["m"][k]) and not np.any(got["v"][k]), k
        decayed = AdamW().decayed(k)
        assert np.any(got["p"][k] != to_bf16_np(params[k])
                      if p_dtype == torch.bfloat16
                      else got["p"][k] != params[k]) == decayed, k


def test_decay_mask_matches_jax():
    """The mask by path, lower-cased as the reference does it: "A_log" and
    "D" never match, so those leaves decay in both."""
    jopt = JAdamW(JAdamWConfig())
    params, _ = draws(0, 1)
    want = flat(jopt._decay_mask(nested(params)))
    got = {k: float(AdamW().decayed(k)) for k in SHAPES}
    assert got == want
    assert got["ssm.A_log"] == got["ssm.D"] == 1.0
    assert got["attn_norm.scale"] == got["ssm.dt_bias"] == 0.0


def test_global_norm_matches_jax_over_mixed_dtypes():
    _, (g,) = draws(3, 1)
    tg = {k: torch.from_numpy(v).to(torch.bfloat16 if i % 2 else
                                    torch.float32)
          for i, (k, v) in enumerate(g.items())}
    jg = nested({k: jnp.asarray(v.float().numpy(), jnp.bfloat16
                                if v.dtype == torch.bfloat16 else jnp.float32)
                 for k, v in tg.items()})
    np.testing.assert_allclose(float(global_norm(tg)),
                               float(jglobal_norm(jg)), rtol=1e-6)
    assert float(global_norm({})) == 0.0


def test_plain_sums_add_in_order():
    """The per-tensor sums are torch's, and the total adds them one at a
    time in the list's order (what ``global_norm`` did before them)."""
    gs = [torch.randn(s, generator=torch.Generator().manual_seed(i)) * 10
          for i, s in enumerate([(300,), (7, 5), (0,), (1000,)])]
    sq = ref.grad_sumsq_ref(gs)
    assert sq.dtype == torch.float32 and sq.shape == (4,)
    for s, g in zip(sq, gs):
        assert torch.equal(s, torch.sum(torch.square(g.float())))
    want = 0
    for s in sq:
        want = want + s
    assert torch.equal(ref.sum_in_order_ref(sq), want)


def test_cpu_update_takes_the_plain_versions(monkeypatch):
    """optim.AdamW on CPU tensors: the plain norm and update, each once a
    step, and none of the card's wrappers."""
    calls = dict.fromkeys(("grad_sumsq_ref", "sum_in_order_ref",
                           "adamw_update_ref"), 0)
    for name in calls:
        fn = getattr(ref, name)

        def counted(*a, _n=name, _fn=fn, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ref, name, counted)
    for name in ("grad_sumsq", "sum_in_order", "adamw_update"):
        def refuse(*a, _n=name, **kw):
            raise AssertionError(f"the card's {_n} ran on the CPU")
        monkeypatch.setattr(adamw_mod, name, refuse)
    before = adamw_mod.launches.value
    params, (g,) = draws(1, 1)
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in params.items()}
    opt = AdamW()
    state = opt.init(tp)
    opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, tp)
    assert calls == dict.fromkeys(calls, 1)
    assert adamw_mod.launches.value == before


def _update_args(n=3, p=torch.bfloat16, g=torch.bfloat16):
    shapes = [(4, 8), (16,), (3, 3)][:n]
    return ([torch.zeros(s, dtype=p) for s in shapes],
            [torch.zeros(s, dtype=g) for s in shapes],
            [torch.zeros(s) for s in shapes], [torch.zeros(s) for s in shapes],
            [True] * n, torch.ones(()))


HYPERS = dict(lr=1e-3, b1=0.9, b2=0.95, b1c=0.1, b2c=0.05, eps=1e-8, wd=0.1)


def _bad(kind):
    ps, gs, ms, vs, dec, scale = _update_args()
    if kind == "dtype":
        gs[1] = gs[1].half()
    elif kind == "param dtype":
        ps[2] = ps[2].double()
    elif kind == "moments":
        vs[0] = vs[0].bfloat16()
    elif kind == "contiguous":
        ps[0] = torch.zeros(8, 4, dtype=torch.bfloat16).t()
    elif kind == "shape":
        ms[2] = torch.zeros(9)
    elif kind == "scale":
        scale = torch.ones(2)
    elif kind == "count":
        dec = dec[:2]
    return ps, gs, ms, vs, dec, scale


@pytest.mark.parametrize("kind,match", [
    ("dtype", r"grads\[1\] must be torch.float32 or torch.bfloat16"),
    ("param dtype", r"params\[2\] must be"),
    ("moments", r"vs\[0\] must be torch.float32, got torch.bfloat16"),
    ("contiguous", r"params\[0\] must be contiguous"),
    ("shape", r"ms\[2\] \(9,\) differs from \(3, 3\)"),
    ("scale", r"scale \(2,\) differs from \(\)"),
    ("count", r"as many grads, moments and flags"),
    ("host", r"params\[0\] must be a CUDA tensor"),
])
def test_update_wrapper_refusals(kind, match):
    with pytest.raises(ValueError, match=match):
        adamw_mod.adamw_update(*_bad(kind), **HYPERS)


def test_norm_wrappers_refuse():
    with pytest.raises(ValueError, match=r"grads\[1\] must be"):
        adamw_mod.grad_sumsq([torch.zeros(3), torch.zeros(3).half()])
    with pytest.raises(ValueError, match=r"grads\[0\] must be contiguous"):
        adamw_mod.grad_sumsq([torch.zeros(3, 4).t()])
    with pytest.raises(ValueError, match="CUDA tensor"):
        adamw_mod.grad_sumsq([torch.zeros(3)])
    with pytest.raises(ValueError, match="at least one"):
        adamw_mod.grad_sumsq([])
    with pytest.raises(ValueError, match="CUDA tensor"):
        adamw_mod.sum_in_order(torch.zeros(3))


@pytest.mark.parametrize("name,params", [
    ("adamw_sumsq", [True, False, False, False, True, True, False, True]),
    ("adamw_sum", [True, False, True, False, True]),
    ("adamw_update", [True, False, False, False, True] + [False] * 10
     + [True]),
])
def test_signatures_of_the_c_entries(name, params):
    """Each new entry point: a pointer (or the stream) where the source
    takes one, one ctypes type a parameter (as test_torch_build checks every
    entry)."""
    from test_torch_build import c_entries
    assert c_entries()[name] == params
    assert [t is _build.ctypes.c_void_p
            for t in _build.SIGNATURES[name]] == params


def test_chunk_plan():
    C = adamw_mod.CHUNK
    assert C % 8 == 0
    assert adamw_mod.chunks_of([0, 1, C, C + 1, 0]) == [0, 0, 1, 2, 4, 4]


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
def test_meta_stand_ins_report_adamw_work(p_dtype, g_dtype):
    shapes = [(300, 64), (64,), (0,), (5, 7, 9)]
    ps = [torch.empty(s, dtype=p_dtype, device="meta") for s in shapes]
    gs = [torch.empty(s, dtype=g_dtype, device="meta") for s in shapes]
    ms = [torch.empty(s, device="meta") for s in shapes]
    with OpAnalysis() as oa:
        sq = ops.grad_sumsq(gs)
        total = ops.sum_in_order(sq)
        ops.adamw_update(ps, gs, ms, list(ms), [True] * 4,
                         torch.sqrt(total), **HYPERS)
    assert sq.shape == (4,) and sq.is_meta and total.shape == ()
    a = oa.analysis
    numels = [torch.Size(s).numel() for s in shapes]
    flops, nbytes = rl.adamw_work(numels, [p_dtype] * 4, [g_dtype] * 4)
    assert a.kernel_calls == {"adamw": 3}
    assert a.kernel_bytes["adamw"] == nbytes
    assert a.kernel_flops["adamw"] == flops
    if p_dtype == g_dtype == torch.bfloat16:   # ~24 bytes an element
        assert 24 * sum(numels) <= nbytes <= 24 * sum(numels) + 64


def test_dry_run_training_step_counts_the_fused_update(monkeypatch):
    """A training step on meta: the ``adamw`` kernel three times (the norm's
    two calls, the update) and none of the eager loop's ops: no square root
    or division over a parameter's elements, no plain version."""
    from torch.utils._python_dispatch import TorchDispatchMode
    for name in ("grad_sumsq_ref", "sum_in_order_ref", "adamw_update_ref"):
        def refuse(*a, _n=name, **kw):
            raise AssertionError(f"{_n} ran on meta")
        monkeypatch.setattr(ref, name, refuse)
    cfg = get_smoke("granite-moe-3b-a800m")
    numel = max(p.numel() for p in dryrun.LM(cfg, device="meta").parameters())

    class Big(TorchDispatchMode):
        """Square roots and divisions over a parameter-sized tensor."""
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if (name in ("sqrt", "div", "div_") and isinstance(out, torch.Tensor)
                    and out.numel() == numel):
                self.seen.append(name)
            return out

    shape = ShapeSpec("t", "train", 16, 2)
    with Big() as big:
        rec = dryrun.trace_cell(cfg, shape, CellConfig(remat=None))
    assert rec["op_analysis"]["kernel_calls"]["adamw"] == 3
    assert big.seen == []
    n = [p.numel() for p in dryrun.LM(cfg, device="meta").parameters()]
    assert rec["op_analysis"]["kernel_bytes"]["adamw"] == rl.adamw_work(
        n, [torch.bfloat16] * len(n))[1]
