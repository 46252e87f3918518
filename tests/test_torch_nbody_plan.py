"""The N-body kernel's launch plan and its order of summation, on the CPU.

``csrc/nbody.cu`` runs a grid of (target tile, source split): the wrapper
picks the splits from the SM count (``kernels/nbody.py:launch_plan``), each
split's sweep adds its sources in order into float32 sums, and a second
pass adds the splits' partial sums in split order 0..S-1.  The plan is
tested here as a pure function; the order is emulated in float32 and held
to the float64 plain version and to the JAX package's Pallas kernel
(interpreted on the CPU) under the card checks' bound, max |err| <= 3e-4 x
max |acc|.  Inputs are made with numpy from a seed.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ref
from repro_torch.kernels import nbody as tnbody

torch.set_num_threads(1)

NBODY_TOL = 3e-4        # as chip_smoke.py: max |err| / max |acc|, float64
H100_SMS = 132
#: one accelerator slot's targets (share 0.4) against all bodies, at the
#: paper's three N-body size classes
SLOT_SHAPES = [(3277, 8192), (6554, 16384), (13107, 32768)]


def gen(i):
    return np.random.default_rng(300 + i)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_i,n_j,sms", [
    *[(n_i, n_j, H100_SMS) for n_i, n_j in SLOT_SHAPES],
    (1000, 1001, H100_SMS), (129, 32767, H100_SMS), (1, 32768, H100_SMS),
    (1, 1, H100_SMS), (7, 2048, H100_SMS), (5000, 2049, H100_SMS),
    (13107, 32768, 1), (13107, 32768, 7), (3, 100_003, 132),
    (270_337, 32768, H100_SMS),
])
def test_plan_covers_every_source_once_in_whole_tiles(n_i, n_j, sms):
    plan = tnbody.launch_plan(n_i, n_j, sms)
    tile = tnbody.TILE
    assert plan.split_len % tile == 0 and plan.split_len > 0
    assert len(plan.ranges) == plan.splits >= 1
    assert plan.ranges[0][0] == 0 and plan.ranges[-1][1] == n_j
    for s, (a, b) in enumerate(plan.ranges):
        assert a == s * plan.split_len and a % tile == 0
        assert a < b <= a + plan.split_len
    for (_, b), (a, _) in zip(plan.ranges, plan.ranges[1:]):
        assert b == a
    assert plan.targets_per_block == tnbody.THREADS * \
        tnbody.TARGETS_PER_THREAD
    assert plan.row_blocks * plan.targets_per_block >= n_i > \
        (plan.row_blocks - 1) * plan.targets_per_block
    # the entry point's own check: the last split holds a source
    assert (plan.splits - 1) * plan.split_len < n_j <= \
        plan.splits * plan.split_len


@pytest.mark.parametrize("n_i,n_j", SLOT_SHAPES)
def test_plan_gives_every_slot_shape_two_blocks_an_sm(n_i, n_j):
    plan = tnbody.launch_plan(n_i, n_j, H100_SMS)
    assert plan.splits > 1
    assert plan.blocks >= 2 * H100_SMS


@pytest.mark.parametrize("n_i,n_j", [
    (1000, 1001),                                   # chip_smoke's ragged
    (33, 2047),                                     # below SPLIT_MIN
    (tnbody.BLOCKS_PER_SM * H100_SMS * 512, 32768),  # tiles fill the card
    (2_000_000, 8192),
])
def test_plan_does_not_split_small_or_overfilled_calls(n_i, n_j):
    plan = tnbody.launch_plan(n_i, n_j, H100_SMS)
    assert plan.splits == 1 and plan.ranges == ((0, n_j),)
    assert plan.split_len >= n_j


def test_plan_refuses_empty_calls():
    for args in [(0, 10, 132), (10, 0, 132), (10, 10, 0)]:
        with pytest.raises(ValueError, match="no plan"):
            tnbody.launch_plan(*args)


def test_scratch_holds_packed_sources_then_partials():
    assert tnbody.scratch_rows(13107, 32768, 1) == 32768
    assert tnbody.scratch_rows(1000, 1001, 1) == 1024
    assert tnbody.scratch_rows(13107, 32768, 22) == 32768 + 22 * 13107
    assert tnbody.scratch_rows(129, 32767, 256) == 32768 + 256 * 129


def test_plan_constants_are_the_kernels():
    """``launch_plan`` counts blocks and tiles with the constants that
    ``csrc/nbody.cu`` is built with, and the C entry point takes the
    scratch, the splits and the split length."""
    src = (_build.CSRC / "nbody.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) == tnbody.THREADS
    assert int(consts["kTargets"]) == tnbody.TARGETS_PER_THREAD
    assert int(consts["kTile"]) == tnbody.TILE
    decl = src[src.index('extern "C" int nbody_acc_f32'):]
    assert "void* scratch, int splits" in decl
    assert "int split_len" in decl
    assert len(_build.SIGNATURES["nbody_acc_f32"]) == 12
    assert "atomicAdd" not in src


# ---------------------------------------------------------------------------
# the kernel's order of summation, in float32
# ---------------------------------------------------------------------------

def split_major(targets, pos, mass, plan, softening=tnbody.SOFTENING,
                tile=tnbody.TILE):
    """The kernel's arithmetic in float32: sources packed and padded to a
    whole tile with mass 0; each split's sweep adds its sources one at a
    time, in order (the last split through the padding); the partial sums
    added in split order."""
    n_j = pos.shape[0]
    n_pad = -(-n_j // tile) * tile
    packed = torch.zeros((n_pad, 4), dtype=torch.float32)
    packed[:n_j, :3] = pos
    packed[:n_j, 3] = mass
    soft = torch.tensor(softening, dtype=torch.float32)
    total = None
    for a, b in plan.ranges:
        acc = torch.zeros_like(targets)
        for j in range(a, min(n_pad, a + plan.split_len)):
            d = packed[j, :3] - targets                       # (n_i, 3)
            r2 = ((d[:, 0] * d[:, 0] + soft) + d[:, 1] * d[:, 1]) \
                + d[:, 2] * d[:, 2]
            inv = torch.rsqrt(r2)
            w = packed[j, 3] * (inv * inv * inv)
            acc = acc + w[:, None] * d
        total = acc if total is None else total + acc
    return total


@pytest.mark.parametrize("n,sms", [(2100, H100_SMS), (2100, 2),
                                   (2000, H100_SMS)])
def test_split_major_order_holds_the_bound(n, sms):
    """Every target against every body, as the Pallas kernel computes them:
    the split-major float32 order within NBODY_TOL of float64 and of the
    Pallas kernel, with single-tile splits (132 SMs), splits of two tiles
    and a ragged last one (2 SMs), and one split (fewer sources than
    SPLIT_MIN_SOURCES)."""
    pos = gen(n).standard_normal((n, 3)).astype(np.float32)
    mass = (gen(n + 1).random(n) + 0.1).astype(np.float32)
    plan = tnbody.launch_plan(n, n, sms)
    assert (plan.splits > 1) == (n >= tnbody.SPLIT_MIN_SOURCES)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    got = split_major(tp, tp, tm, plan)
    want64 = ref.nbody_ref(tp.double(), tm.double())
    scale = want64.abs().max().item()
    assert (got.double() - want64).abs().max().item() <= NBODY_TOL * scale
    pallas = np.asarray(jops.nbody_accelerations(
        jnp.asarray(pos), jnp.asarray(mass), block_i=256, block_j=1024))
    assert np.abs(got.numpy() - pallas).max() <= NBODY_TOL * scale


def test_split_major_order_on_a_slot_of_the_bodies():
    """A slot's targets (a row range) against every body, with a ragged
    source count: the padding adds nothing."""
    n_j, lo, hi = 2509, 400, 541
    pos = gen(7).standard_normal((n_j, 3)).astype(np.float32)
    mass = (gen(8).random(n_j) + 0.1).astype(np.float32)
    tp, tm = torch.from_numpy(pos), torch.from_numpy(mass)
    plan = tnbody.launch_plan(hi - lo, n_j, H100_SMS)
    assert plan.splits > 1 and plan.ranges[-1][1] % tnbody.TILE
    got = split_major(tp[lo:hi], tp, tm, plan)
    want64 = ref.nbody_ref(tp.double(), tm.double(),
                           targets=tp[lo:hi].double())
    scale = want64.abs().max().item()
    assert (got.double() - want64).abs().max().item() <= NBODY_TOL * scale
