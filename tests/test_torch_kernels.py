"""The port's plain kernel versions against the JAX package's Pallas kernels
(run through ``repro.kernels.ops``, which interprets them on the CPU), on
the same numpy inputs made from a seed; and the CUDA wrappers' refusal of
anything but CUDA tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels import filter_pipeline as tfilter
from repro_torch.kernels import nbody as tnbody
from repro_torch.kernels import saxpy as tsaxpy
from repro_torch.kernels import segmentation as tseg

torch.set_num_threads(1)


def gen(i):
    return np.random.default_rng(100 + i)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 1000, 4096])
def test_saxpy_matches_pallas(n):
    x = gen(0).standard_normal(n).astype(np.float32)
    y = gen(1).standard_normal(n).astype(np.float32)
    want = np.asarray(jops.saxpy(2.5, jnp.asarray(x), jnp.asarray(y),
                                 block=256))
    got = ops.saxpy(2.5, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(32, 32), (50, 36), (64, 128)])
def test_filter_pipeline_matches_pallas(hw):
    img = (gen(2).random(hw) * 255).astype(np.float32)
    want = np.asarray(jops.filter_pipeline(jnp.asarray(img), seed=3,
                                           block_rows=16))
    got = ops.filter_pipeline(torch.from_numpy(img), 3).numpy()
    assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_filter_pipeline_without_noise_is_exact():
    img = (gen(3).random((40, 24)) * 255).astype(np.float32)
    want = np.asarray(jops.filter_pipeline(jnp.asarray(img), seed=5,
                                           noise_scale=0.0, block_rows=8))
    got = ops.filter_pipeline(torch.from_numpy(img), 5,
                              noise_scale=0.0).numpy()
    assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_filter_pipeline_hash_bits_exact(seed):
    """At noise_scale 1000 one hash step (1/65535 of it) moves a pixel by
    0.015, a hundred times the float rounding between the two versions:
    agreeing within 1e-3 means every unclipped pixel's hash bits agree."""
    img = (gen(4).random((48, 40)) * 255).astype(np.float32)
    want = np.asarray(jops.filter_pipeline(jnp.asarray(img), seed=seed,
                                           noise_scale=1000.0,
                                           block_rows=16))
    got = ops.filter_pipeline(torch.from_numpy(img), seed,
                              noise_scale=1000.0).numpy()
    assert_allclose(got, want, rtol=0, atol=1e-3)
    unclipped = (want > 0) & (want < 255)
    assert unclipped.mean() > 0.05


def test_filter_pipeline_is_mirrored():
    img = torch.arange(16.0)[None, :].repeat(4, 1)
    out = ops.filter_pipeline(img, noise_scale=0.0)
    assert float(out[0, 0]) >= float(out[0, -1])


@pytest.mark.parametrize("shape", [(8, 8, 4), (16, 24, 5), (32, 8, 3)])
def test_segmentation_matches_pallas_exactly(shape):
    v = (gen(5).random(shape) * 255).astype(np.float32)
    v.flat[::7] = np.nan
    v.flat[1] = 85.0
    v.flat[2] = 170.0
    want = np.asarray(jops.segmentation(jnp.asarray(v)))
    got = ops.segmentation(torch.from_numpy(v)).numpy()
    assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0.0, 128.0, 255.0}


@pytest.mark.parametrize("n", [33, 100, 256])
def test_nbody_matches_pallas(n):
    pos = gen(6).standard_normal((n, 3)).astype(np.float32)
    mass = (gen(7).random(n) + 0.1).astype(np.float32)
    want = np.asarray(jops.nbody_accelerations(
        jnp.asarray(pos), jnp.asarray(mass), block_i=32, block_j=64))
    got = ops.nbody_accelerations(torch.from_numpy(pos),
                                  torch.from_numpy(mass)).numpy()
    assert_allclose(got, want, rtol=3e-4, atol=3e-4)


def test_nbody_targets_are_rows_of_the_full_sum():
    """A slot's bodies against the copy of all bodies give its own rows."""
    pos = torch.from_numpy(gen(8).standard_normal((90, 3)).astype(np.float32))
    mass = torch.from_numpy((gen(9).random(90) + 0.1).astype(np.float32))
    full = ops.nbody_accelerations(pos, mass)
    part = ops.nbody_accelerations(pos, mass, targets=pos[31:70])
    assert_allclose(part.numpy(), full[31:70].numpy(), rtol=1e-6, atol=1e-6)


def test_nbody_momentum_is_conserved():
    """Loop-skeleton integration: momentum is conserved by symmetry."""
    n = 64
    p = torch.from_numpy(gen(10).standard_normal((n, 3)).astype(np.float32))
    v = torch.zeros((n, 3))
    mass = torch.ones(n)
    for _ in range(3):
        p, v = ops.nbody_step(p, v, mass, dt=1e-3)
    total = (mass[:, None] * v).sum(0)
    assert total.abs().max() < 1e-2


def test_nbody_step_matches_pallas_step():
    n = 48
    pos = gen(11).standard_normal((n, 3)).astype(np.float32)
    vel = gen(12).standard_normal((n, 3)).astype(np.float32)
    mass = (gen(13).random(n) + 0.1).astype(np.float32)
    wp, wv = jops.nbody_step(jnp.asarray(pos), jnp.asarray(vel),
                             jnp.asarray(mass), dt=0.01)
    gp, gv = ops.nbody_step(torch.from_numpy(pos), torch.from_numpy(vel),
                            torch.from_numpy(mass), 0.01)
    assert_allclose(gv.numpy(), np.asarray(wv), rtol=3e-4, atol=3e-4)
    assert_allclose(gp.numpy(), np.asarray(wp), rtol=3e-4, atol=3e-4)


# ---------------------------------------------------------------------------
# dispatch: by device only
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = {k: c.value for k, c in ops.COUNTERS.items()}
    x = torch.ones(10)
    ops.saxpy(1.0, x, x)
    ops.segmentation(x)
    ops.filter_pipeline(torch.ones(4, 4))
    ops.nbody_accelerations(torch.ones(5, 3), torch.ones(5))
    assert {k: c.value for k, c in ops.COUNTERS.items()} == before
    assert set(ops.COUNTERS) == {"saxpy", "filter_pipeline", "segmentation",
                                 "nbody", "flash_attention", "ssd_scan",
                                 "grouped_matmul", "flash_attention_bwd",
                                 "ssd_scan_bwd"}


def test_meta_tensors_give_shapes():
    m = ops.nbody_step(torch.empty(7, 3, device="meta"),
                       torch.empty(7, 3, device="meta"),
                       torch.empty(9, device="meta"),
                       all_pos=torch.empty(9, 3, device="meta"))
    assert [tuple(t.shape) for t in m] == [(7, 3), (7, 3)]
    assert ops.filter_pipeline(torch.empty(3, 5, device="meta")).shape == \
        (3, 5)


@pytest.mark.parametrize("call", [
    lambda: tsaxpy.saxpy(1.0, torch.ones(8), torch.ones(8)),
    lambda: tseg.segmentation(torch.ones(8)),
    lambda: tfilter.filter_pipeline(torch.ones(4, 4)),
    lambda: tnbody.nbody_accelerations(torch.ones(4, 3), torch.ones(4, 3),
                                       torch.ones(4)),
], ids=["saxpy", "segmentation", "filter_pipeline", "nbody"])
def test_kernel_wrappers_refuse_host_tensors(call):
    """A wrapper launches its kernel or raises; it never computes on the
    host."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
