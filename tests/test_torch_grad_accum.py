"""The microbatch gradient accumulation (``ops.grad_accumulate``) on the
CPU, bit for bit.

- The plain version, called first / middle / last as the train step calls
  it, against an inline copy of the eager loop it replaced (float32 zeros,
  ``+= g.float()`` a microbatch, ``* (1 / M)`` at the end) and against the
  JAX package's arithmetic (a ``jax.lax.scan`` from float32 zeros adding
  ``a + b.astype(jnp.float32)``, then ``x * (1.0 / M)``) on the same numpy
  arrays: M 2, 3 and 4, bf16 and float32 gradients, ragged sizes (none,
  one, odd, past a chunk), inputs that hold -0.0.  Compared as bit
  patterns: ``torch.equal`` takes -0.0 for +0.0.
- The reference's own ``repro.runtime.train._accumulate_grads`` against
  the port's on a loss linear in the parameters, one batch row a
  microbatch, so each microbatch's gradient is a given array exactly (the
  row's), bf16 and float32 parameters: the accumulated gradients the same
  bits, and the same as the eager loop's.
- On CPU tensors the plain version runs and the card's wrapper never
  does; the card's wrapper refuses a wrong dtype, shape, non-contiguity,
  device, count or mode with ``ValueError``; its C entry's ctypes
  signature; on ``meta`` the stand-in reports ``roofline.grad_accum_work``
  (6 and 10 bytes an element with bf16 gradients), and a dry-run training
  step at four microbatches counts four ``grad_accum`` calls and runs no
  plain version and none of the eager loop's float32 ops over a
  parameter-sized tensor.

The kernel itself (``csrc/grad_accum.cu``) runs only on a card:
``tests/test_torch_cuda.py`` holds it to the plain version bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import RuntimeConfig as JRuntimeConfig
from repro.runtime.train import _accumulate_grads as j_accumulate_grads
from repro_torch.configs import ShapeSpec, get_smoke
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import adamw as adamw_mod
from repro_torch.kernels import grad_accum as accum_mod
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.cells import CellConfig
from repro_torch.launch.op_analysis import OpAnalysis
from repro_torch.runtime import RuntimeConfig
from repro_torch.runtime.train import _accumulate_grads

torch.set_num_threads(1)

#: ragged sizes: empty, one element, odd, past one kernel chunk
SHAPES = [(0,), (1,), (7,), (3, 5), (2, 4, 9), (adamw_mod.CHUNK + 9,)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
MODES = ("first", "middle", "last")


def modes(M):
    return ["first"] + ["middle"] * (M - 2) + ["last"]


def draws(M, seed=0):
    """M microbatches of gradients, float32 numpy, each with -0.0 at every
    fifth element and +0.0 at every seventh from the second: where every
    microbatch holds -0.0 the sum is +0.0 only through the first call's
    0 + (-0.0)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(M):
        gs = []
        for s in SHAPES:
            g = rng.normal(size=s).astype(np.float32)
            flat = g.reshape(-1)
            flat[::5] = -0.0
            flat[1::7] = 0.0
            gs.append(g)
        out.append(gs)
    return out


def as_dtype(gs, tdtype):
    """Torch tensors of ``tdtype`` and their values as float32 numpy (what
    JAX is given, rounded the same way)."""
    ts = [torch.from_numpy(g).to(tdtype) for g in gs]
    return ts, [t.float().numpy() for t in ts]


def bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def eager_loop(micro):
    """The port's loop before the kernel, inline: float32 zeros, ``+=
    g.float()`` a microbatch, ``v * inv`` at the end."""
    accs = [torch.zeros_like(g, dtype=torch.float32) for g in micro[0]]
    for gs in micro:
        for a, g in zip(accs, gs):
            a += g.float()
    inv = 1.0 / len(micro)
    return [a * inv for a in accs]


def jax_scan(micro_np, jdtype):
    """The reference's arithmetic: a scan from float32 zeros adding
    ``a + b.astype(jnp.float32)``, then ``x * inv``, jitted."""
    M = len(micro_np)
    xs = [jnp.asarray(np.stack([m[j] for m in micro_np]), jdtype)
          for j in range(len(SHAPES))]

    @jax.jit
    def run(xs):
        def step(acc, mb):
            return [a + b.astype(jnp.float32) for a, b in zip(acc, mb)], None
        g0 = [jnp.zeros(x.shape[1:], jnp.float32) for x in xs]
        g, _ = jax.lax.scan(step, g0, xs)
        inv = 1.0 / M
        return [x * inv for x in g]
    return [np.asarray(x) for x in run(xs)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M", [2, 3, 4])
def test_plain_version_is_the_eager_loop_and_jax_bit_for_bit(M, dtype):
    tdtype, jdtype = DTYPES[dtype]
    micro, micro_np = zip(*(as_dtype(gs, tdtype) for gs in draws(M)))
    accs = [torch.empty(s) for s in SHAPES]
    for mode, gs in zip(modes(M), micro):
        ops.grad_accumulate(accs, list(gs), mode=mode, scale=1.0 / M)
    want = eager_loop(micro)
    jwant = jax_scan(micro_np, jdtype)
    for a, w, j in zip(accs, want, jwant):
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert np.array_equal(bits(a.numpy()), bits(w.numpy()))
        assert np.array_equal(bits(a.numpy()), bits(j))
    flat = np.concatenate([a.numpy().reshape(-1) for a in accs])
    # the first call turns -0.0 into +0.0 (zeros + g), as both do
    assert (flat == 0).any() and not np.signbit(flat[flat == 0]).any()


def test_first_call_does_not_read_the_accumulator():
    """``first`` writes 0 + g over whatever the accumulator held (the card
    allocates them with ``torch.empty``); a nan there does not leak."""
    acc = torch.full((5,), float("nan"))
    g = torch.tensor([1.0, -0.0, 0.0, -2.5, 3.0]).bfloat16()
    ops.grad_accumulate([acc], [g], mode="first")
    assert np.array_equal(bits(acc.numpy()), bits(
        np.array([1.0, 0.0, 0.0, -2.5, 3.0], np.float32)))


def test_last_call_scales_by_the_float32_of_one_over_m():
    """At M = 3, 1 / 3 is not exact: the scale is the float32 of the
    host's double, as PyTorch's ``v * inv`` and the reference multiply."""
    g = torch.tensor([3.0, 1.0, 7.0, 1e-30])
    acc = torch.empty(4)
    ops.grad_accumulate([acc], [g], mode="first")
    ops.grad_accumulate([acc], [g], mode="last", scale=1.0 / 3)
    want = (np.float32(2) * g.numpy()) * np.float32(1.0 / 3)
    assert np.array_equal(bits(acc.numpy()), bits(want))


# ---------------------------------------------------------------------------
# the reference's _accumulate_grads against the port's
# ---------------------------------------------------------------------------

PARAMS = {"embed": (6, 4), "w": (adamw_mod.CHUNK + 3,), "norm": (5,),
          "empty": (0,)}


class Linear(torch.nn.Module):
    """Parameters of PARAMS; the loss of a batch row r is sum over the
    parameters of sum(p * W[name][r]), so its gradient is W[name][r]."""

    def __init__(self, dtype):
        super().__init__()
        for k, s in PARAMS.items():
            self.register_parameter(k, torch.nn.Parameter(
                torch.ones(s, dtype=dtype)))


def linear_rows(M, seed=1):
    """W[name]: (M, *shape) float32 numpy with -0.0 in every row."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in PARAMS.items():
        w = rng.normal(size=(M, *s)).astype(np.float32)
        w.reshape(M, -1)[:, ::3] = -0.0
        out[k] = w
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("M", [2, 3, 4])
def test_accumulate_grads_match_the_reference_bit_for_bit(M, dtype):
    tdtype, jdtype = DTYPES[dtype]
    W = {k: torch.from_numpy(w).to(tdtype) for k, w in linear_rows(M).items()}
    tokens = np.arange(M, dtype=np.int32)[:, None]        # the row's index
    labels = np.zeros((M, 1), np.int32)

    def port_loss(model, toks, labs, extras):
        r = int(toks[0, 0])
        total = sum((p * W[k][r]).sum() for k, p in model.named_parameters())
        return total, (total.detach().float(), torch.zeros(()))

    model = Linear(tdtype)
    got, loss, aux = _accumulate_grads(
        port_loss, model, {"tokens": torch.from_numpy(tokens),
                           "labels": torch.from_numpy(labels)},
        RuntimeConfig(microbatches=M))

    jW = {k: jnp.asarray(W[k].float().numpy(), jdtype) for k in W}

    def jax_loss(params, toks, labs, extras):
        r = toks[0, 0]
        total = sum(jnp.sum(p * jW[k][r]) for k, p in params.items())
        return total, (total.astype(jnp.float32), jnp.zeros((), jnp.float32))

    jparams = {k: jnp.ones(s, jdtype) for k, s in PARAMS.items()}
    jgot, _, _ = jax.jit(lambda p, b: j_accumulate_grads(
        jax_loss, p, b, JRuntimeConfig(microbatches=M)))(
        jparams, {"tokens": jnp.asarray(tokens),
                  "labels": jnp.asarray(labels)})
    want = eager_loop([[W[k][r] for k in PARAMS] for r in range(M)])
    assert list(got) == list(PARAMS)
    for (k, g), w in zip(got.items(), want):
        assert g.dtype == torch.float32 and g.shape == PARAMS[k]
        assert np.array_equal(bits(g.numpy()), bits(jgot[k]))
        assert np.array_equal(bits(g.numpy()), bits(w.numpy()))
    assert float(aux) == 0.0 and np.isfinite(float(loss))


# ---------------------------------------------------------------------------
# dispatch, the card wrapper's refusals, the C entry, meta
# ---------------------------------------------------------------------------

def test_cpu_takes_the_plain_version(monkeypatch):
    calls = []
    plain = ref.grad_accumulate_ref
    monkeypatch.setattr(ref, "grad_accumulate_ref",
                        lambda *a, **k: calls.append(k["mode"])
                        or plain(*a, **k))

    def refuse(*a, **k):
        raise AssertionError("the card's grad_accumulate ran on the CPU")
    monkeypatch.setattr(accum_mod, "grad_accumulate", refuse)
    before = accum_mod.launches.value
    accs, gs = [torch.empty(3)], [torch.ones(3)]
    for mode in modes(3):
        ops.grad_accumulate(accs, gs, mode=mode, scale=1.0 / 3)
    assert calls == modes(3)
    assert accum_mod.launches.value == before
    assert torch.equal(accs[0], torch.ones(3))


def _bad(kind):
    accs = [torch.zeros(4, 8), torch.zeros(16)]
    gs = [torch.zeros(4, 8, dtype=torch.bfloat16), torch.zeros(16)]
    mode = "middle"
    if kind == "grad dtype":
        gs[1] = gs[1].half()
    elif kind == "acc dtype":
        accs[0] = accs[0].bfloat16()
    elif kind == "contiguous":
        gs[0] = torch.zeros(8, 4, dtype=torch.bfloat16).t()
    elif kind == "shape":
        gs[1] = torch.zeros(17)
    elif kind == "count":
        gs = gs[:1]
    elif kind == "none":
        accs, gs = [], []
    elif kind == "mode":
        mode = "final"
    return accs, gs, mode


@pytest.mark.parametrize("kind,match", [
    ("grad dtype", r"grads\[1\] must be torch.float32 or torch.bfloat16"),
    ("acc dtype", r"accs\[0\] must be torch.float32, got torch.bfloat16"),
    ("contiguous", r"grads\[0\] must be contiguous"),
    ("shape", r"grads\[1\] \(17,\) differs from \(16,\)"),
    ("count", r"one gradient an accumulator"),
    ("none", r"at least one"),
    ("mode", r"mode must be one of"),
    ("host", r"accs\[0\] must be a CUDA tensor"),
])
def test_wrapper_refusals(kind, match):
    accs, gs, mode = _bad(kind)
    with pytest.raises(ValueError, match=match):
        accum_mod.grad_accumulate(accs, gs, mode=mode)


def test_plain_version_refuses_a_mode_it_does_not_have():
    with pytest.raises(ValueError, match="mode must be one of"):
        ops.grad_accumulate([torch.zeros(2)], [torch.zeros(2)], mode="sum")


def test_signature_of_the_c_entry():
    """A pointer (or the stream) where the source takes one, as
    test_torch_build checks every entry."""
    from test_torch_build import c_entries
    params = [True, False, False, False, False, False, False, True]
    assert c_entries()["grad_accum"] == params
    assert [t is _build.ctypes.c_void_p
            for t in _build.SIGNATURES["grad_accum"]] == params
    assert accum_mod.MODES == {"first": 0, "middle": 1, "last": 2}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_meta_stand_in_reports_grad_accum_work(dtype):
    tdtype = DTYPES[dtype][0]
    accs = [torch.empty(s, device="meta") for s in SHAPES]
    gs = [torch.empty(s, dtype=tdtype, device="meta") for s in SHAPES]
    with OpAnalysis() as oa:
        for mode in modes(4):
            ops.grad_accumulate(accs, gs, mode=mode, scale=0.25)
    a = oa.analysis
    numels = [torch.Size(s).numel() for s in SHAPES]
    n, size = sum(numels), tdtype.itemsize
    assert a.kernel_calls == {"grad_accum": 4}
    assert a.kernel_bytes["grad_accum"] == n * (size + 4) + 3 * n * (size + 8)
    assert a.kernel_flops["grad_accum"] == 3 * n + 2 * n
    for mode, per in zip(MODES, (size + 4, size + 8, size + 8)):
        assert rl.grad_accum_work(numels, [tdtype] * len(numels), mode)[1] \
            == n * per
    if tdtype == torch.bfloat16:       # 6 and 10 bytes an element
        assert rl.grad_accum_work([10], [tdtype], "first") == (10.0, 60.0)
        assert rl.grad_accum_work([10], [tdtype], "last") == (20.0, 100.0)


def test_dry_run_training_step_counts_the_accumulation(monkeypatch):
    """A training step on meta at four microbatches: the ``grad_accum``
    kernel four times with its work, and no plain version and none of the
    eager loop's ops (float32 zeros, casts, adds, products) over a
    tensor of the largest parameter's size."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def refuse(*a, **kw):
        raise AssertionError("grad_accumulate_ref ran on meta")
    monkeypatch.setattr(ref, "grad_accumulate_ref", refuse)
    cfg = get_smoke("granite-moe-3b-a800m")
    params = list(dryrun.LM(cfg, device="meta").parameters())
    numel = max(p.numel() for p in params)

    class Big(TorchDispatchMode):
        """float32 zeros, casts, adds and products of a parameter's
        size."""
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if (name in ("zeros_like", "zero_", "fill_", "_to_copy", "add",
                         "add_", "mul", "mul_")
                    and isinstance(out, torch.Tensor)
                    and out.dtype == torch.float32 and out.numel() == numel):
                self.seen.append(name)
            return out

    shape = ShapeSpec("t", "train", 16, 4)
    with Big() as big:
        rec = dryrun.trace_cell(cfg, shape,
                                CellConfig(microbatches=4, remat=None))
    assert rec["cell"]["microbatches"] == 4
    assert big.seen == []
    ana = rec["op_analysis"]
    assert ana["kernel_calls"]["grad_accum"] == 4
    n = [p.numel() for p in params]
    bf16 = [torch.bfloat16] * len(n)
    assert ana["kernel_bytes"]["grad_accum"] == sum(
        rl.grad_accum_work(n, bf16, m)[1] for m in modes(4))
