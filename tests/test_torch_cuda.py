"""The port on a CUDA card: each kernel against its plain version, and the
main path at small sizes (accelerator slots on CUDA streams).  Every test
here skips without a card.  This file imports neither JAX nor the JAX
package, so on a machine without JAX it runs on its own:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import math

import pytest
import torch

import repro_torch.core as T
from repro_torch import suite
from repro_torch.core import occupancy
from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["saxpy", "segmentation",
                                    "filter_pipeline", "nbody"])
def test_kernel_matches_plain_on_card(kernel, cuda_device):
    g = torch.Generator().manual_seed(0)
    before = ops.COUNTERS[kernel].value
    if kernel == "saxpy":
        x = torch.randn(100_003, generator=g).to(cuda_device)[1:]
        y = torch.randn(100_003, generator=g).to(cuda_device)[1:]
        torch.testing.assert_close(ops.saxpy(2.5, x, y),
                                   ref.saxpy_ref(2.5, x, y),
                                   rtol=1e-5, atol=1e-5)
    elif kernel == "segmentation":
        v = (torch.rand(5, 64, 63, generator=g) * 255).to(cuda_device)
        v.view(-1)[::13] = float("nan")
        assert torch.equal(ops.segmentation(v), ref.segmentation_ref(v))
    elif kernel == "filter_pipeline":
        img = (torch.rand(77, 131, generator=g) * 255).to(cuda_device)
        torch.testing.assert_close(ops.filter_pipeline(img, 3),
                                   ref.filter_pipeline_ref(img, 3),
                                   rtol=1e-5, atol=1e-4)
    else:
        pos = torch.randn(1001, 3, generator=g).to(cuda_device)
        mass = (torch.rand(1001, generator=g) + 0.1).to(cuda_device)
        got = ops.nbody_accelerations(pos, mass, targets=pos[:333])
        want = ref.nbody_ref(pos.double(), mass.double(),
                             targets=pos[:333].double())
        assert (got.double() - want).abs().max() <= \
            3e-4 * want.abs().max()
    torch.cuda.synchronize()
    assert ops.COUNTERS[kernel].value == before + 1


@pytest.mark.cuda
def test_calibration_and_limits_come_from_the_card(cuda_device):
    """``calibrate(workload)`` times each device with CUDA events; the
    occupancy limits are the card's own."""
    x = torch.randn(1 << 20, device=cuda_device)
    accel = T.AcceleratorPlatform([T.DeviceInfo("gpu0", "gpu"),
                                   T.DeviceInfo("gpu0b", "gpu")])
    scores = accel.calibrate(lambda d: ops.saxpy(2.0, x, x))
    assert len(scores) == 2 and all(s > 0 for s in scores)
    assert abs(sum(scores) - 1.0) < 1e-9
    props = torch.cuda.get_device_properties(0)
    lim = occupancy.gpu_limits()
    assert lim.sms == props.multi_processor_count
    assert 48 * 1024 < lim.smem_per_block_optin <= lim.smem_per_sm


def _scheduler(balancer=None):
    kb = T.KnowledgeBase()
    for sid, dims in [("map(kernel[saxpy])", (8,)),
                      ("map(kernel[segmentation])", (2, 64, 64)),
                      ("map(kernel[filter_pipeline])", (8, 96)),
                      ("loop(kernel[nbody_step])", (8, 3))]:
        kb.store(T.Profile(sct_id=sid, workload=T.Workload(dims),
                           share_a=0.75,
                           config=T.PlatformConfig(fission_level="L2",
                                                   overlap=2),
                           best_time=1.0))
    return T.Scheduler(
        host=T.HostPlatform(T.DeviceInfo("cpu0", "cpu"),
                            topology={"L2": 2, "NO_FISSION": 1}),
        accel=T.AcceleratorPlatform([T.DeviceInfo("gpu0", "gpu")],
                                    max_overlap=2),
        executor=T.ThreadedExecutor(), kb=kb, balancer=balancer)


@pytest.mark.cuda
def test_main_path_on_card(cuda_device):
    g = torch.Generator().manual_seed(1)
    img = torch.rand(200, 96, generator=g) * 255
    pos = torch.randn(300, 3, generator=g)
    cases = [
        (suite.saxpy_sct(), {"a": 2.5, "x": torch.randn(10_001, generator=g),
                             "y": torch.randn(10_001, generator=g)}),
        (suite.segmentation_sct(64 * 64),
         {"vol": torch.rand(9, 64, 64, generator=g) * 255}),
        (suite.filter_pipeline_sct(96), {"img": img, "seed": 4}),
        (suite.nbody_sct(300), {"pos": pos, "vel": torch.zeros(300, 3),
                                "all_pos": pos,
                                "mass": torch.rand(300, generator=g) + 0.1}),
    ]
    for c in ops.COUNTERS.values():
        c.reset()
    with T.Session(_scheduler(T.LoadBalancer(trigger=math.inf))) as s:
        for sct, arrays in cases:
            for _ in range(2):
                run = s.run(sct, **arrays).get()
                out = {k: v.clone() for k, v in run.outputs.items()}
                assert all(v.device.type == "cpu" for v in out.values())
                if "z" in out:
                    torch.testing.assert_close(
                        out["z"], ref.saxpy_ref(2.5, arrays["x"],
                                                arrays["y"]),
                        rtol=1e-5, atol=1e-5)
                if "seg" in out:
                    assert torch.equal(out["seg"],
                                       ref.segmentation_ref(arrays["vol"]))
                if "out" in out:
                    part = run.node_plan.part
                    for off, n in zip(part.offsets("img"), part.sizes("img")):
                        torch.testing.assert_close(
                            out["out"][off:off + n],
                            ref.filter_pipeline_ref(img[off:off + n], 4),
                            rtol=1e-5, atol=1e-4)
                if "vel" in out:
                    acc = ref.nbody_ref(pos.double(),
                                        arrays["mass"].double())
                    err = (out["vel"].double() / suite.NBODY_DT - acc)
                    assert err.abs().max() <= 3e-4 * acc.abs().max()
        g2 = T.JobGraph()
        first = g2.add(suite.filter_pipeline_sct(96, dst="mid"))
        g2.add(suite.filter_pipeline_sct(96, src="mid", dst="out2"),
               after=first)
        h = s.submit(g2, img=img, seed=4)
        resident = h.result(timeout=120).outputs["out2"].clone()
        head = h.runs[first]
        assert head.stats.resident
        handle = head.resident_handle
        devices = {slot.device_type: env["mid"].device.type
                   for env, slot in zip(handle.envs, handle.part.slots)}
        assert devices == {"gpu": "cuda", "cpu": "cpu"}
    for name, c in ops.COUNTERS.items():
        assert c.value >= 4, name       # two requests x two streams
    with T.Session(_scheduler(T.LoadBalancer(trigger=math.inf))) as s:
        g3 = T.JobGraph()
        first = g3.add(suite.filter_pipeline_sct(96, dst="mid"),
                       residency=False)
        g3.add(suite.filter_pipeline_sct(96, src="mid", dst="out2"),
               after=first)
        merged = s.submit(g3, img=img, seed=4).result(
            timeout=120).outputs["out2"]
        assert torch.equal(resident, merged)


@pytest.mark.cuda
def test_device_fault_aborts_without_retry(cuda_device):
    """A failure of an accelerator slot that was not injected aborts the
    run; the range is not re-split onto the host slots."""
    bad = T.Map(T.kernel(lambda x: ops.saxpy(1.0, x, x[:-1]), name="bad",
                         inputs=[T.vector("x")], outputs=[T.vector("z")]))
    with T.Session(_scheduler()) as s:
        with pytest.raises(T.ExecutionError) as info:
            s.run(bad, x=torch.ones(1000)).get()
    kinds = {r.kind for r in info.value.records}
    assert "device" in kinds
    assert all(r.attempt == 0 for r in info.value.records)
