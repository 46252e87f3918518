"""The port's main path against the JAX package's, on the CPU.

The paper's four benchmark SCTs are built in both packages with the same
kernel specs: the port's from :mod:`repro_torch.suite` (bodies call the
port's kernels, here their plain versions), the reference's below (bodies
call ``repro.kernels.ops``, the Pallas kernels, interpreted on the CPU).
The same numpy inputs go through ``Scheduler`` + ``ThreadedExecutor`` of
both, over the same hybrid slot layout, and the merged outputs are held
together within the kernel tolerances of ``tests/test_kernels.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import repro.core as R
from repro.kernels import ops as jops
import repro_torch.core as T
from repro_torch import suite

torch.set_num_threads(1)

SHARES = [(0.25, 0.25, 0.25, 0.25), (0.4, 0.3, 0.2, 0.1),
          (0.7, 0.1, 0.2, 0.0), (1.0, 0.0, 0.0, 0.0)]


# ---------------------------------------------------------------------------
# the reference's SCTs, with the port's specs and Pallas-kernel bodies
# ---------------------------------------------------------------------------

def ref_saxpy_sct():
    return R.Map(R.kernel(
        lambda a, x, y: jops.saxpy(a, x, y, block=256), name="saxpy",
        inputs=[R.scalar("a"), R.vector("x"), R.vector("y")],
        outputs=[R.vector("z")], flops_per_item=2.0, bytes_per_item=12.0))


def ref_segmentation_sct(plane):
    return R.Map(R.kernel(
        lambda v: jops.segmentation(v), name="segmentation",
        inputs=[R.vector("vol")], outputs=[R.vector("seg")],
        flops_per_item=2.0 * plane, bytes_per_item=8.0 * plane))


def ref_filter_sct(width, src="img", dst="out"):
    return R.Map(R.kernel(
        lambda img, seed: jops.filter_pipeline(img, seed, block_rows=8),
        name="filter_pipeline",
        inputs=[R.vector(src), R.scalar("seed")], outputs=[R.vector(dst)],
        flops_per_item=9.0 * width, bytes_per_item=8.0 * width))


def ref_nbody_sct(n_bodies):
    """The JAX kernel has no separate target operand: a slot computes the
    accelerations of every body and keeps its own rows (OFFSET trait).

    One step, as a Map: the reference's ``Loop`` cannot run on its
    ``ThreadedExecutor`` (``jax.eval_shape`` in ``_ensure_body_outputs``
    rejects the ``__partition__`` entry of a slot's environment), so the
    port's one-iteration Loop is held against the body applied once."""
    def body(pos, vel, all_pos, mass, off):
        acc = jops.nbody_accelerations(jnp.asarray(all_pos),
                                       jnp.asarray(mass),
                                       block_i=16, block_j=32)
        acc = acc[off:off + pos.shape[0]]
        vel = vel + acc * suite.NBODY_DT
        return pos + vel * suite.NBODY_DT, vel

    k = R.kernel(body, name="nbody_step",
                 inputs=[R.vector("pos"), R.vector("vel"),
                         R.vector("all_pos", copy=True),
                         R.vector("mass", copy=True),
                         R.scalar("off", trait=R.Trait.OFFSET)],
                 outputs=[R.vector("pos"), R.vector("vel")],
                 flops_per_item=20.0 * n_bodies, bytes_per_item=16.0)
    return R.Map(k)


def inputs(name, seed=0):
    """Numpy inputs of each SCT, made from a seed (small sizes)."""
    g = np.random.default_rng(seed)
    if name == "saxpy":
        return {"a": 2.5, "x": g.standard_normal(1003).astype(np.float32),
                "y": g.standard_normal(1003).astype(np.float32)}
    if name == "segmentation":
        vol = (g.random((12, 8, 8)) * 255).astype(np.float32)
        vol.flat[::11] = np.nan
        return {"vol": vol}
    if name == "filter_pipeline":
        return {"img": (g.random((48, 24)) * 255).astype(np.float32),
                "seed": 3}
    pos = g.standard_normal((40, 3)).astype(np.float32)
    return {"pos": pos, "vel": np.zeros((40, 3), np.float32),
            "all_pos": pos.copy(),
            "mass": (g.random(40) + 0.1).astype(np.float32)}


PAIRS = {
    "saxpy": (ref_saxpy_sct, suite.saxpy_sct),
    "segmentation": (lambda: ref_segmentation_sct(64),
                     lambda: suite.segmentation_sct(64)),
    "filter_pipeline": (lambda: ref_filter_sct(24),
                        lambda: suite.filter_pipeline_sct(24)),
    "nbody": (lambda: ref_nbody_sct(40), lambda: suite.nbody_sct(40)),
}
TOL = {"saxpy": (1e-5, 1e-5), "filter_pipeline": (1e-5, 1e-4),
       "segmentation": (0.0, 0.0), "nbody": (3e-4, 3e-4)}


def slots(P):
    return [P.ExecutionSlot("gpu0/q0", "gpu"), P.ExecutionSlot("gpu0/q1", "gpu"),
            P.ExecutionSlot("cpu0/f0", "cpu"), P.ExecutionSlot("cpu0/f1", "cpu")]


def scheduler(P, executor, share_a=0.6, balancer=None):
    """Two accelerator queues and two host fission slots, from a KB
    profile the first request derives its configuration from."""
    kb = P.KnowledgeBase()
    for sid, dims in [("map(kernel[saxpy])", (8,)),
                      ("map(kernel[segmentation])", (2, 8, 8)),
                      ("map(kernel[filter_pipeline])", (8, 24)),
                      ("loop(kernel[nbody_step])", (8, 3)),
                      ("map(kernel[nbody_step])", (8, 3))]:
        kb.store(P.Profile(
            sct_id=sid, workload=P.Workload(dims), share_a=share_a,
            config=P.PlatformConfig(fission_level="L2", overlap=2),
            best_time=1.0))
    return P.Scheduler(
        host=P.HostPlatform(P.DeviceInfo("cpu0", "cpu", compute_units=4),
                            topology={"L2": 2, "NO_FISSION": 1}),
        accel=P.AcceleratorPlatform([P.DeviceInfo("gpu0", "gpu")],
                                    max_overlap=2),
        executor=executor, kb=kb, balancer=balancer)


def as_numpy(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# ---------------------------------------------------------------------------
# decomposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PAIRS))
def test_decomposition_is_identical(name):
    ref_sct, port_sct = PAIRS[name][0](), PAIRS[name][1]()
    arrs = inputs(name)
    shapes = {k: np.shape(v) for k, v in arrs.items()}
    rp, tp = R.build_plan(ref_sct, shapes), T.build_plan(port_sct, shapes)
    assert rp.domain_units == tp.domain_units
    for shares in SHARES:
        a = rp.partition(slots(R), shares)
        b = tp.partition(slots(T), shares)
        assert a.layout() == b.layout()
        for v in rp.vectors:
            assert a.sizes(v) == b.sizes(v)
            assert a.offsets(v) == b.offsets(v)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PAIRS))
def test_scheduled_runs_match_the_reference(name):
    ref_sct, port_sct = PAIRS[name][0](), PAIRS[name][1]()
    rtol, atol = TOL[name]
    # timings differ between the packages: keep the balancer out, so both
    # run the KB profile's distribution ("derived", then "reused")
    rs = scheduler(R, R.ThreadedExecutor(),
                   balancer=R.LoadBalancer(trigger=math.inf))
    ts = scheduler(T, T.ThreadedExecutor(device="cpu"),
                   balancer=T.LoadBalancer(trigger=math.inf))
    try:
        for seed in (0, 1):
            arrs = inputs(name, seed)
            want = rs.run(ref_sct, arrs)
            got = ts.run(port_sct, arrs)
            assert got.action == want.action == ("derived", "reused")[seed]
            assert got.stats.share_a == want.stats.share_a
            assert len(got.stats.times) == len(want.stats.times) == 4
            assert set(got.outputs) == set(want.outputs)
            for k, v in want.outputs.items():
                if rtol == atol == 0.0:
                    assert_array_equal(as_numpy(got.outputs[k]), v)
                else:
                    assert_allclose(as_numpy(got.outputs[k]), v,
                                    rtol=rtol, atol=atol)
    finally:
        rs.close()
        ts.close()


def test_session_runs_and_outputs_are_host_tensors():
    with T.Session(scheduler(T, T.ThreadedExecutor(device="cpu"))) as s:
        arrs = inputs("saxpy")
        run = s.run(suite.saxpy_sct(), **arrs).get()
        z = run.outputs["z"]
        assert isinstance(z, torch.Tensor) and z.device.type == "cpu"
        want = 2.5 * arrs["x"] + arrs["y"]
        assert_allclose(z.numpy(), want, rtol=1e-6, atol=1e-6)


def _chain(P, sct_fn, residency):
    g = P.JobGraph()
    first = g.add(sct_fn(24), residency=residency)
    g.add(sct_fn(24, src="out", dst="out2"), after=first)
    return g


@pytest.mark.parametrize("fault", [False, True], ids=["clean", "faulted"])
def test_chain_resident_equals_merged_and_reference(fault):
    """filter -> filter: the resident handoff on the port is bit-identical
    to the same graph merged between steps, and matches the reference.
    A fault in the first step makes it merge instead (no handoff).  The
    filter's row ids are local to each slot's slice, so every run keeps
    the KB profile's distribution (the balancer never triggers)."""
    arrs = inputs("filter_pipeline")
    outs = {}
    for residency in (None, False):
        inj = T.FaultInjector(crash_on_call={"gpu0": [2]}) if fault else None
        sched = scheduler(T, T.ThreadedExecutor(device="cpu", injector=inj),
                          balancer=T.LoadBalancer(trigger=math.inf))
        with T.Session(sched) as s:
            h = s.submit(_chain(T, suite.filter_pipeline_sct, residency),
                         **arrs)
            res = h.result(timeout=60)
            first = h.graph.names()[0]
            assert h.runs[first].stats.resident == (residency is None
                                                    and not fault)
            outs[residency] = res.outputs["out2"].clone()
    assert torch.equal(outs[None], outs[False])
    # row ids of the filter's noise are local to each slot's slice, so a
    # faulted run is compared with the reference under the same faults
    inj = R.FaultInjector(crash_on_call={"gpu0": [2]}) if fault else None
    rsched = scheduler(R, R.ThreadedExecutor(injector=inj),
                       balancer=R.LoadBalancer(trigger=math.inf))
    with R.Session(rsched) as s:
        want = s.submit(_chain(R, ref_filter_sct, None), **arrs).result(
            timeout=60).outputs["out2"]
    assert_allclose(outs[None].numpy(), want, rtol=1e-5, atol=1e-4)


def test_injected_fault_is_contained_and_output_unchanged():
    arrs = inputs("segmentation")
    clean = scheduler(T, T.ThreadedExecutor(device="cpu"))
    inj = T.FaultInjector(crash_on_call={"gpu0": [1]})
    faulty = scheduler(T, T.ThreadedExecutor(device="cpu", injector=inj))
    try:
        a = clean.run(suite.segmentation_sct(64), arrs)
        b = faulty.run(suite.segmentation_sct(64), arrs)
        assert b.stats.retries == 1 and len(b.stats.failures) == 1
        assert torch.equal(a.outputs["seg"], b.outputs["seg"])
    finally:
        clean.close()
        faulty.close()
