"""The port on a CUDA card: each kernel against its plain version, and the
main path at small sizes (accelerator slots on CUDA streams).  Every test
here skips without a card.  This file imports neither JAX nor the JAX
package, so on a machine without JAX it runs on its own:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import math

import pytest
import torch
import torch.nn.functional as F

import repro_torch.core as T
from repro_torch import suite
from repro_torch.core import occupancy
from repro_torch.kernels import ops, ref

from flash_bwd_bounds import attention_bwd_rounding, cancelling


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
    for name in ("saxpy", "segmentation", "filter_pipeline", "nbody"):
        assert ops.COUNTERS[name].value >= 4, name  # 2 requests x 2 streams
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


# ---------------------------------------------------------------------------
# the LM kernels and the serving path
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kw", [
    (torch.float32, dict(causal=True)),
    (torch.float32, dict(causal=False, kv_len=70)),
    (torch.float32, dict(causal=True, window=16, logit_cap=20.0)),
    (torch.float32, dict(causal=True, window=8, kv_len=20)),  # empty rows
    (torch.bfloat16, dict(causal=True)),
    (torch.bfloat16, dict(causal=False, kv_len=70)),
    (torch.bfloat16, dict(causal=True, window=16, logit_cap=20.0)),
    (torch.bfloat16, dict(causal=True, window=8, kv_len=20)),
], ids=["causal", "kv_len", "window_softcap", "fully_masked", "bf16",
        "bf16_kv_len", "bf16_window_softcap", "bf16_fully_masked"])
@pytest.mark.parametrize("hd", [16, 64, 80, 128, 256])
def test_flash_attention_matches_plain_on_card(dtype, kw, hd, cuda_device):
    g = torch.Generator().manual_seed(hd)
    q = torch.randn(2, 4, 100, hd, generator=g).to(cuda_device, dtype)
    k = torch.randn(2, 2, 100, hd, generator=g).to(cuda_device, dtype)
    v = torch.randn(2, 2, 100, hd, generator=g).to(cuda_device, dtype)
    before = ops.COUNTERS["flash_attention"].value
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    # bf16: both sum in float32 and round once, so one bf16 step (2^-7 of
    # the value) apart at most, plus the float32 tolerance
    rtol, atol = (3e-4, 3e-4) if dtype == torch.float32 else (2 ** -7, 3e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    bshd = ops.flash_attention_bshd(*(t.transpose(1, 2).contiguous()
                                      for t in (q, k, v)), **kw)
    assert torch.equal(bshd.transpose(1, 2), got)
    torch.cuda.synchronize()
    assert ops.COUNTERS["flash_attention"].value == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,kw", [
    (1, 24, 8, 300, 300, 64, dict(causal=True)),
    (2, 4, 2, 77, 77, 80, dict(causal=True)),
    (1, 4, 4, 77, 200, 128, dict(causal=False)),
    (1, 96, 8, 1536, 1536, 128, dict(causal=True)),
    (1, 36, 36, 1536, 1536, 64, dict(causal=True)),
    (1, 48, 8, 1536, 1536, 128, dict(causal=True, window=1000)),
], ids=["gqa_24_8", "ragged_rows", "sq_not_sk", "command_r_gqa_96_8",
        "minicpm_36_36", "mixtral_gqa_48_8_window"])
def test_flash_attention_bf16_shapes_on_card(B, H, KV, Sq, Sk, hd, kw,
                                             cuda_device):
    """bf16 (the tensor-core kernel): granite's GQA 24/8 at head_dim 64,
    query rows that leave a ragged last 64-row tile, fewer queries than
    keys, command-r-plus's 96/8 and minicpm's 36/36 at a 1536-token prompt,
    mixtral's 48/8 with a window in force, each within one bf16 step (2^-7
    of the value) plus 3e-4."""
    g = torch.Generator().manual_seed(Sq + hd)
    q = torch.randn(B, H, Sq, hd, generator=g).to(cuda_device,
                                                  torch.bfloat16)
    k = torch.randn(B, KV, Sk, hd, generator=g).to(cuda_device,
                                                   torch.bfloat16)
    v = torch.randn(B, KV, Sk, hd, generator=g).to(cuda_device,
                                                   torch.bfloat16)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 80])
def test_flash_attention_bf16_unaligned_rows_on_card(hd, cuda_device):
    """bf16 q/k/v whose rows do not start on 16 bytes (views one element
    into their storage) take the kernel's element-wise loads: the same
    output, bit for bit, as aligned copies, which take cp.async."""
    g = torch.Generator().manual_seed(hd + 1)
    n = 2 * 4 * 100 * hd
    q, k, v = (torch.randn(n + 1, generator=g).to(cuda_device,
                                                  torch.bfloat16)[1:]
               .view(2, 4, 100, hd) for _ in range(3))
    assert q.data_ptr() % 16 and q.is_contiguous()
    kw = dict(causal=True, window=40, kv_len=90)
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q.clone(), k.clone(), v.clone(), **kw)
    assert torch.equal(got, want)
    ref_out = ref.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), ref_out.float(), rtol=2 ** -7,
                               atol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_matches_plain_on_card(dtype, cuda_device):
    """nh 4, hd 64, ds 64: 512 positions in chunks of 256, then a tail of
    chunk 232 chained through h0, against the token-by-token recurrence
    over the whole sequence."""
    g = torch.Generator().manual_seed(3)
    S, tail, nh, hd, ds = 512, 232, 4, 64, 64
    x = (torch.randn(1, S + tail, nh * hd, generator=g) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(1, S + tail, nh,
                                                  generator=g))
    Bm = (torch.randn(1, S + tail, ds, generator=g) * 0.5).to(dtype)
    Cm = (torch.randn(1, S + tail, ds, generator=g) * 0.5).to(dtype)
    A = -torch.exp(torch.randn(nh, generator=g) * 0.3)
    x, dt, Bm, Cm, A = (t.to(cuda_device) for t in (x, dt, Bm, Cm, A))
    y1, h1 = ops.ssd_scan(x[:, :S], dt[:, :S], Bm[:, :S], Cm[:, :S], A,
                          chunk=256)
    y2, h2 = ops.ssd_scan(x[:, S:], dt[:, S:], Bm[:, S:], Cm[:, S:], A,
                          chunk=tail, h0=h1)
    wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=1)
    y = torch.cat([y1, y2], 1)
    assert y.dtype == dtype and h2.dtype == torch.float32
    # bf16 y: one bf16 step (2^-7 of the value) plus the float32 bound
    rtol = 0.0 if dtype == torch.float32 else 2 ** -7
    scale = max(1.0, wy.float().abs().max().item())
    assert ((y.float() - wy.float()).abs()
            <= rtol * wy.float().abs() + 3e-4 * scale).all()
    assert (h2 - wh).abs().max().item() <= 3e-4 * max(
        1.0, wh.abs().max().item())


def _ssd_inputs(Bsz, S, nh, hd, ds, dtype, device, seed=3, a_scale=0.3):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(Bsz, S, nh * hd, generator=g) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn(Bsz, S, nh, generator=g))
    Bm = (torch.randn(Bsz, S, ds, generator=g) * 0.5).to(dtype)
    Cm = (torch.randn(Bsz, S, ds, generator=g) * 0.5).to(dtype)
    A = -torch.exp(torch.randn(nh, generator=g) * a_scale)
    return [t.to(device) for t in (x, dt, Bm, Cm, A)]


def _ssd_within_bound(y, h, wy, wh):
    """float32: |err| <= 3e-4 x max(1, max |want|) for y and for h; bf16 y:
    each element within one bf16 step (2^-7 of its value) more."""
    rtol = 0.0 if y.dtype == torch.float32 else 2 ** -7
    scale = max(1.0, wy.float().abs().max().item())
    assert ((y.float() - wy.float()).abs()
            <= rtol * wy.float().abs() + 3e-4 * scale).all()
    assert (h - wh).abs().max().item() <= 3e-4 * max(
        1.0, wh.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_at_zamba2_shape_on_card(dtype, cuda_device):
    """zamba2-2.7b's prefill shape (nh 80, hd 64, ds 64, 1536 positions in
    chunks of 256): four kernels a call, one count; a second call gives
    the same bits."""
    x, dt, Bm, Cm, A = _ssd_inputs(1, 1536, 80, 64, 64, dtype, cuda_device)
    before = ops.COUNTERS["ssd_scan"].value
    y, h = ops.ssd_scan(x, dt, Bm, Cm, A, chunk=256)
    y2, h2 = ops.ssd_scan(x, dt, Bm, Cm, A, chunk=256)
    torch.cuda.synchronize()
    assert ops.COUNTERS["ssd_scan"].value == before + 2
    assert torch.equal(y, y2) and torch.equal(h, h2)
    wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=256)
    assert y.dtype == dtype and h.dtype == torch.float32
    _ssd_within_bound(y, h, wy, wh)


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [1, 7, 65, 232])
def test_ssd_scan_tail_chained_on_card(tail, cuda_device):
    """512 positions in chunks of 256, then a ragged tail as one chunk of
    its own through h0, as the model chains a prompt's tail."""
    S, nh, hd, ds = 512, 4, 64, 64
    x, dt, Bm, Cm, A = _ssd_inputs(1, S + tail, nh, hd, ds, torch.float32,
                                   cuda_device, seed=tail)
    y1, h1 = ops.ssd_scan(x[:, :S], dt[:, :S], Bm[:, :S], Cm[:, :S], A,
                          chunk=256)
    y2, h2 = ops.ssd_scan(x[:, S:], dt[:, S:], Bm[:, S:], Cm[:, S:], A,
                          chunk=tail, h0=h1)
    wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=1)
    _ssd_within_bound(torch.cat([y1, y2], 1), h2, wy, wh)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bsz,S,nh,hd,ds,chunk", [
    (1, 300, 3, 16, 16, 100),
    (1, 260, 2, 128, 128, 130),
    (1, 192, 2, 16, 128, 64),
    (1, 200, 2, 128, 16, 40),
    (2, 384, 3, 48, 80, 128),
    (8, 512, 64, 64, 128, 256),
], ids=["hd16_ds16", "hd128_ds128", "hd16_ds128", "hd128_ds16", "batch2",
        "mamba2_training"])
def test_ssd_scan_shapes_on_card(Bsz, S, nh, hd, ds, chunk, dtype,
                                 cuda_device):
    """head_dim and d_state at 16 and 128, chunks that are no multiple of
    64, batch 2, with an h0: y and h_final against the recurrence."""
    x, dt, Bm, Cm, A = _ssd_inputs(Bsz, S, nh, hd, ds, dtype, cuda_device,
                                   seed=hd + ds)
    h0 = torch.randn(Bsz, nh, ds, hd,
                     generator=torch.Generator().manual_seed(1)).to(
        cuda_device)
    y, h = ops.ssd_scan(x, dt, Bm, Cm, A, chunk=chunk, h0=h0)
    wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=chunk, h0=h0)
    _ssd_within_bound(y, h, wy, wh)


@pytest.mark.cuda
def test_ssd_scan_strong_decay_on_card(cuda_device):
    """A decay so strong that exp(cum_q - cum_k) underflows to 0 a few
    positions back, and exp(cum_k - cum_q) above the diagonal overflows:
    selected, never multiplied, so no NaN."""
    x, dt, Bm, Cm, A = _ssd_inputs(1, 256, 2, 32, 32, torch.float32,
                                   cuda_device, seed=9)
    A = A * 40.0
    y, h = ops.ssd_scan(x, dt, Bm, Cm, A, chunk=128)
    wy, wh = ref.ssd_scan_ref(x, dt, Bm, Cm, A, chunk=128)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    _ssd_within_bound(y, h, wy, wh)


@pytest.mark.cuda
def test_ssd_scan_unaligned_views_on_card(cuda_device):
    """x, B, C and h0 as views one element into their storage (rows that
    do not start on 16 bytes): the same bits as aligned copies."""
    x, dt, Bm, Cm, A = _ssd_inputs(1, 128, 2, 32, 16, torch.float32,
                                   cuda_device, seed=4)
    h0 = torch.randn(1, 2, 16, 32,
                     generator=torch.Generator().manual_seed(2)).to(
        cuda_device)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=cuda_device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view
    views = [shifted(t) for t in (x, Bm, Cm, h0)]
    assert all(v.data_ptr() % 16 and v.is_contiguous() for v in views)
    got = ops.ssd_scan(views[0], dt, views[1], views[2], A, chunk=64,
                       h0=views[3])
    want = ops.ssd_scan(x, dt, Bm, Cm, A, chunk=64, h0=h0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_ssd_scan_refuses_what_it_cannot_take_on_card(cuda_device):
    x, dt, Bm, Cm, A = _ssd_inputs(1, 64, 2, 16, 16, torch.float32,
                                   cuda_device)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd_scan(x, dt, Bm, Cm, A, chunk=48)
    with pytest.raises(ValueError, match="1 <= chunk"):
        ops.ssd_scan(x, dt, Bm, Cm, A, chunk=0)
    x2, dt2, Bm2, Cm2, A2 = _ssd_inputs(1, 64, 2, 24, 16, torch.float32,
                                        cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        ops.ssd_scan(x2, dt2, Bm2, Cm2, A2, chunk=64)


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(3, 0), (1023, 0), (1024, 0),
                                      (1025, 1), (4097, 0), (1_000_003, 2),
                                      (20_000_000, 0)])
def test_saxpy_ragged_and_repeatable_on_card(n, offset, cuda_device):
    """Lengths under, at and past one block's 1024 float4 loads, views
    that start off 16 bytes (the scalar path), the slot's 2e7: within the
    card checks' 1e-5, and bit-identical across calls."""
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n + offset, generator=g).to(cuda_device)[offset:]
    y = torch.randn(n + offset, generator=g).to(cuda_device)[offset:]
    got = ops.saxpy(2.5, x, y)
    assert torch.equal(got, ops.saxpy(2.5, x, y))
    torch.testing.assert_close(got, ref.saxpy_ref(2.5, x, y), rtol=1e-5,
                               atol=1e-5)


NBODY_TOL = 3e-4        # as chip_smoke.py: max |err| / max |acc|, float64


def _nbody_inputs(n_j, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    pos = torch.randn(n_j, 3, generator=g).to(device)
    mass = (torch.rand(n_j, generator=g) + 0.1).to(device)
    return pos, mass


def _nbody_within_bound(got, pos, mass, targets):
    want = ref.nbody_ref(pos.double(), mass.double(),
                         targets=targets.double())
    err = (got.double() - want).abs().max().item()
    assert err <= NBODY_TOL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("n_i,n_j", [(3277, 8192), (6554, 16384),
                                     (13107, 32768), (1000, 1001),
                                     (129, 32767), (1, 32768), (1, 5)])
def test_nbody_shapes_on_card(n_i, n_j, cuda_device):
    """One accelerator slot's targets at the paper's three size classes
    (split sources), chip_smoke.py's ragged cases, one target: within
    NBODY_TOL of float64, one launch counted a call."""
    pos, mass = _nbody_inputs(n_j, cuda_device, seed=n_i)
    before = ops.COUNTERS["nbody"].value
    got = ops.nbody_accelerations(pos, mass, targets=pos[:n_i])
    torch.cuda.synchronize()
    assert ops.COUNTERS["nbody"].value == before + 1
    assert got.shape == (n_i, 3) and torch.isfinite(got).all()
    _nbody_within_bound(got, pos, mass, pos[:n_i])


@pytest.mark.cuda
def test_nbody_without_sources_on_card(cuda_device):
    pos, mass = _nbody_inputs(0, cuda_device)
    tgt = torch.randn(7, 3, device=cuda_device)
    assert torch.equal(ops.nbody_accelerations(pos, mass, targets=tgt),
                       torch.zeros_like(tgt))


@pytest.mark.cuda
@pytest.mark.parametrize("n_i,n_j", [(13107, 32768), (129, 32767),
                                     (1000, 1001)])
def test_nbody_repeats_bit_for_bit_on_card(n_i, n_j, cuda_device):
    """The partial sums are added in a fixed order: no call differs from
    another by a bit."""
    pos, mass = _nbody_inputs(n_j, cuda_device, seed=1)
    first = ops.nbody_accelerations(pos, mass, targets=pos[:n_i])
    for _ in range(3):
        assert torch.equal(first, ops.nbody_accelerations(
            pos, mass, targets=pos[:n_i]))


@pytest.mark.cuda
def test_nbody_two_streams_at_once_on_card(cuda_device):
    """Two slots' calls at once, each from its own thread on its own
    stream, as the executor's overlap slots run them: each call equals the
    same call made alone (the scratch is the call's own)."""
    import concurrent.futures
    pos, mass = _nbody_inputs(32768, cuda_device, seed=2)
    halves = [pos[:13107], pos[13107:26214]]
    lone = [ops.nbody_accelerations(pos, mass, targets=t) for t in halves]
    torch.cuda.synchronize()

    def slot(k):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            outs = [ops.nbody_accelerations(pos, mass, targets=halves[k])
                    for _ in range(4)]
        stream.synchronize()
        return outs

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(slot, k) for k in range(2)]
        results = [f.result(timeout=120) for f in futures]
    for k in range(2):
        assert all(torch.equal(o, lone[k]) for o in results[k])


@pytest.mark.cuda
def test_nbody_refuses_what_it_cannot_take_on_card(cuda_device):
    """The C entry point refuses a split call without scratch, and split
    lengths that are not whole tiles or do not cover the sources."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import nbody as tnbody
    pos, mass = _nbody_inputs(1000, cuda_device)
    acc = torch.empty(10, 3, device=cuda_device)
    scratch = torch.empty(tnbody.scratch_rows(10, 1000, 8), 4,
                          device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.library()
    for ptr, splits, split_len in [(None, 2, 512), (None, 1, 1024),
                                   (scratch.data_ptr(), 2, 500),
                                   (scratch.data_ptr(), 2, 384),
                                   (scratch.data_ptr(), 8, 256),
                                   (scratch.data_ptr(), 0, 1024)]:
        assert lib.nbody_acc_f32(
            pos.data_ptr(), 10, pos.data_ptr(), mass.data_ptr(), 1000,
            acc.data_ptr(), 1e-3, ptr, splits, split_len, 0, stream) != 0
    with pytest.raises(ValueError, match="mass has"):
        ops.nbody_accelerations(pos, mass[:-1])


@pytest.mark.cuda
def test_smoke_model_serves_on_card_as_on_cpu(cuda_device):
    """zamba2's smoke config in float32: prefill logits and state on the
    card (kernels) against the CPU (plain versions), then greedy serving
    through the kernels, with one flash launch per attention layer and one
    or two SSD launches per Mamba2 layer per prefill."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import LM, prefill
    from repro_torch.runtime import ServeEngine
    cfg = get_smoke("zamba2-2.7b")
    card = LM(cfg, dtype=torch.float32, device=cuda_device,
              generator=torch.Generator(device=cuda_device).manual_seed(0))
    host = LM(cfg, dtype=torch.float32)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (1, 37),
                         generator=torch.Generator().manual_seed(1))
    lc, cc = prefill(card, toks.to(cuda_device))
    lh, ch = prefill(host, toks)
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(cc["h"].cpu(), ch["h"], rtol=1e-3, atol=1e-3)
    for c in ops.COUNTERS.values():
        c.reset()
    eng = ServeEngine(cfg, card, slots=2, capacity=64)
    for n in (20, 37, 32):
        eng.submit(torch.randint(0, cfg.vocab, (n,)).tolist(), max_new=5)
    done = eng.run_to_completion()
    assert sorted(len(r.out) for r in done) == [5, 5, 5]
    assert ops.COUNTERS["flash_attention"].value == 2 * 3
    assert ops.COUNTERS["ssd_scan"].value == 2 * (2 + 2 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "minicpm-2b", "gemma2-2b",
                                  "nemotron-4-15b", "internvl2-26b",
                                  "command-r-plus-104b", "mixtral-8x22b"])
def test_family_smoke_model_serves_on_card_as_on_cpu(arch, cuda_device):
    """Each new family's smoke config in float32: prefill logits and cache
    on the card (kernels) against the CPU (plain versions), a 24-token
    prompt past gemma2's and mixtral's 16-token window; then greedy
    serving through the kernels, with one flash launch per attention layer
    and one or two SSD launches per Mamba2 layer per prefill, and three
    grouped GEMMs per MoE layer per prefill and decode step."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import LM, prefill
    from repro_torch.runtime import ServeEngine
    cfg = get_smoke(arch)
    card = LM(cfg, dtype=torch.float32, device=cuda_device,
              generator=torch.Generator(device=cuda_device).manual_seed(0))
    host = LM(cfg, dtype=torch.float32)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    toks = torch.randint(0, cfg.vocab, (1, 24),
                         generator=torch.Generator().manual_seed(1))
    lc, cc = prefill(card, toks.to(cuda_device), capacity=32)
    lh, ch = prefill(host, toks, capacity=32)
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-3, atol=1e-3)
    for k in ch:
        # bf16 cache rows: one bf16 step apart where they round apart
        tol = 1e-3 if k == "h" else 2 ** -7
        torch.testing.assert_close(cc[k].float().cpu(), ch[k].float(),
                                   rtol=tol, atol=1e-3)
    for c in ops.COUNTERS.values():
        c.reset()
    steps = []
    eng = ServeEngine(cfg, card, slots=2, capacity=32,
                      on_step=lambda kind, *a: steps.append(kind))
    lengths = (20, 24, 9)
    for n in lengths:
        eng.submit(torch.randint(0, cfg.vocab, (n,)).tolist(), max_new=5)
    done = eng.run_to_completion()
    assert sorted(len(r.out) for r in done) == [5, 5, 5]
    n_attn = sum(cfg.is_attention_layer(i) for i in range(cfg.n_layers))
    assert ops.COUNTERS["flash_attention"].value == n_attn * 3
    if cfg.ssm is not None:
        Q = cfg.ssm.chunk
        assert ops.COUNTERS["ssd_scan"].value == cfg.n_layers * sum(
            2 if n > Q and n % Q else 1 for n in lengths)
    # every prefill and decode step, and the decode graph's warm-up step
    moe_calls = (3 * cfg.n_layers * (len(steps) + 1) if cfg.moe is not None
                 else 0)
    assert ops.COUNTERS["grouped_matmul"].value == moe_calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 37, 65, 41), (40, 8, 1536, 512),
                                   (40, 384, 512, 1536),
                                   (40, 384, 1536, 512), (4, 72, 1536, 512),
                                   (8, 480, 6144, 16384),
                                   (8, 480, 16384, 6144)],
                         ids=["odd", "decode", "prefill_w_out",
                              "prefill_in", "ragged_c", "mixtral_w_in",
                              "mixtral_w_out"])
def test_grouped_matmul_matches_plain_on_card(shape, dtype, cuda_device):
    """Weights of std 1/sqrt(d), as the model draws them.  float32: max
    |err| <= 2e-4 x max |plain|; bf16: both sum in float32 and round once,
    so each element within one bf16 step (2^-7 of its value) plus that."""
    E, C, d, f = shape
    g = torch.Generator().manual_seed(C)
    x = torch.randn(E, C, d, generator=g).to(cuda_device, dtype)
    w = (torch.randn(E, d, f, generator=g) * d ** -0.5).to(cuda_device,
                                                           dtype)
    before = ops.COUNTERS["grouped_matmul"].value
    got = ops.grouped_matmul(x, w)
    want = ref.grouped_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (E, C, f)
    assert ops.COUNTERS["grouped_matmul"].value == before + 1
    err = (got.float() - want.float()).abs()
    scale = want.float().abs().max().item()
    rtol = 0.0 if dtype == torch.float32 else 2 ** -7
    assert (err <= rtol * want.float().abs() + 2e-4 * scale).all()


@pytest.mark.cuda
def test_grouped_matmul_takes_unaligned_rows_on_card(cuda_device):
    """bf16 rows that do not start on 16 bytes (a view one element into
    its storage) take the WMMA kernel, by the wrapper's alignment check:
    the same result as that kernel on an aligned copy, and within one bf16
    step of the TMA + wgmma kernel, which the aligned copy takes.  The TMA
    kernel's entry point refuses the view outright."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import moe_gemm
    g = torch.Generator().manual_seed(5)
    base = torch.randn(4 * 72 * 136 + 1, generator=g).to(cuda_device,
                                                         torch.bfloat16)
    x = base[1:].view(4, 72, 136)
    w = (torch.randn(4, 136, 200, generator=g) * 136 ** -0.5).to(
        cuda_device, torch.bfloat16)
    assert x.is_contiguous() and x.data_ptr() % 16
    paths = moe_gemm.bf16_launches
    before = {k: c.value for k, c in paths.items()}
    got, want = ops.grouped_matmul(x, w), ref.grouped_matmul_ref(x, w)
    assert paths["wmma"].value == before["wmma"] + 1
    scale = want.float().abs().max().item()
    assert ((got.float() - want.float()).abs()
            <= 2 ** -7 * want.float().abs() + 2e-4 * scale).all()
    xa = x.contiguous().clone()
    lib, stream = _build.library(), torch.cuda.current_stream().cuda_stream
    # the WMMA kernel on the aligned copy: bit-identical
    y = torch.empty(4, 72, 200, dtype=torch.bfloat16, device=cuda_device)
    assert lib.grouped_matmul_wmma_fwd(xa.data_ptr(), w.data_ptr(),
                                       y.data_ptr(), 4, 72, 136, 200,
                                       x.device.index, stream) == 0
    assert torch.equal(got, y)
    aligned = ops.grouped_matmul(xa, w)
    torch.cuda.synchronize()
    assert paths["tma"].value == before["tma"] + 1
    assert ((aligned.float() - want.float()).abs()
            <= 2 ** -7 * want.float().abs() + 2e-4 * scale).all()
    assert lib.grouped_matmul_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                  1, 4, 72, 136, 200, x.device.index,
                                  stream) != 0


@pytest.mark.cuda
def test_granite_smoke_model_serves_on_card_as_on_cpu(cuda_device):
    """granite's smoke config in float32: the same parameters serve the
    same greedy tokens on the card (kernels) as on the CPU (plain
    versions), with no near tie behind any CPU token, and one flash launch
    per layer per prefill, three grouped GEMMs per layer per step."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import LM
    from repro_torch.runtime import ServeEngine
    cfg = get_smoke("granite-moe-3b-a800m")
    host = LM(cfg, dtype=torch.float32,
              generator=torch.Generator().manual_seed(0))
    card = LM(cfg, dtype=torch.float32, device=cuda_device)
    card.load_state_dict(host.state_dict())
    prompts = [torch.randint(0, cfg.vocab, (n,),
                             generator=torch.Generator().manual_seed(n)
                             ).tolist() for n in (20, 37, 32)]
    gaps, steps = [], []
    outs = {}
    for c in ops.COUNTERS.values():
        c.reset()
    for model, device in ((host, "cpu"), (card, "cuda")):
        def on_step(kind, n, seconds, logits, device=device):
            if device == "cuda":
                steps.append(kind)
                return
            rows = [0] if kind == "prefill" else [
                i for i, r in enumerate(eng.active) if r is not None]
            top2 = logits[rows].float().topk(2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).min().item())
        eng = ServeEngine(cfg, model, slots=2, capacity=64, device=device,
                          on_step=on_step)
        for p in prompts:
            eng.submit(p, max_new=5)
        outs[device] = {r.rid: r.out for r in eng.run_to_completion()}
    torch.cuda.synchronize()
    assert min(gaps) > 1e-3
    assert outs["cuda"] == outs["cpu"]
    assert ops.COUNTERS["flash_attention"].value == cfg.n_layers * 3
    # every prefill and decode step, and the decode graph's warm-up step
    assert ops.COUNTERS["grouped_matmul"].value == 3 * cfg.n_layers * (
        len(steps) + 1)
    assert ops.COUNTERS["ssd_scan"].value == 0


# ---------------------------------------------------------------------------
# gradients: the flash backward kernel, the grouped GEMM under autograd
# ---------------------------------------------------------------------------

#: float32 gradients: max |err| <= BWD_TOL x max |plain| (the same float32
#: function summed in another order); bf16 inputs: each element within one
#: bf16 step (2^-7 of its value) plus that, plus for dq and dk how far D =
#: rowsum(dO o) moves with o rounded to bf16 (tests/flash_bwd_bounds.py)
BWD_TOL = 1e-4


def _flash_grads(q, k, v, do, fn, **kw):
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o = fn(qs, ks, vs, **kw)
    assert o.grad_fn is not None
    return (o, *torch.autograd.grad(o, (qs, ks, vs), do))


def _check_flash_grads(q, k, v, do, kw):
    got = _flash_grads(q, k, v, do, ops.flash_attention, **kw)
    want = _flash_grads(q.float(), k.float(), v.float(), do.float(),
                        ref.attention_ref, **kw)
    rounding = (*attention_bwd_rounding(q, k, got[0], do, **kw), 0.0)
    for name, g, w, r in zip("qkv", got[1:], want[1:], rounding):
        assert g.dtype == q.dtype and g.shape == w.shape
        err = (g.float() - w).abs()
        bound = BWD_TOL * w.abs().max()
        if q.dtype == torch.bfloat16:
            bound = bound + 2 ** -7 * w.abs() + r
        assert (err <= bound).all(), (name, err.max().item())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True,
                                                       window=40),
                                dict(causal=True, logit_cap=5.0),
                                dict(causal=False)],
                         ids=["causal", "window", "softcap", "noncausal"])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128, 256])
def test_flash_backward_matches_plain_on_card(hd, kw, dtype, cuda_device):
    """GQA 24/8, a ragged 150 rows, every head dim of the kernel: dq, dk
    and dv against autograd through the plain version; repeated calls
    bit-identical; one backward launch a call, through the tensor-core
    kernels for bf16 and the FMA kernels for float32."""
    from repro_torch.kernels import flash_attention as flash_mod
    g = torch.Generator().manual_seed(hd)
    q, do = (torch.randn(1, 24, 150, hd, generator=g).to(cuda_device, dtype)
             for _ in range(2))
    k, v = (torch.randn(1, 8, 150, hd, generator=g).to(cuda_device, dtype)
            for _ in range(2))
    before = ops.COUNTERS["flash_attention_bwd"].value
    paths = {n: c.value for n, c in flash_mod.bwd_paths.items()}
    got = _check_flash_grads(q, k, v, do, kw)
    again = _flash_grads(q, k, v, do, ops.flash_attention, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert ops.COUNTERS["flash_attention_bwd"].value == before + 2
    took = "mma" if dtype == torch.bfloat16 else "fma"
    assert {n: c.value - paths[n] for n, c in flash_mod.bwd_paths.items()} \
        == {"mma": 0, "fma": 0, took: 2}


@pytest.mark.cuda
def test_flash_gemma2_window_in_force_on_card(cuda_device):
    """gemma2's local layer past its window: bf16, 8 query and 4 kv heads
    of 256, softcap 50, scale 1/16, window 4096 over 5120 tokens; the
    forward within one bf16 step plus 3e-4 of the plain version, the
    gradients within the backward's bound."""
    g = torch.Generator().manual_seed(256)
    q, do = (torch.randn(1, 8, 5120, 256, generator=g).to(cuda_device,
                                                         torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(1, 4, 5120, 256, generator=g).to(cuda_device,
                                                        torch.bfloat16)
            for _ in range(2))
    kw = dict(causal=True, window=4096, logit_cap=50.0, scale=256 ** -0.5)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got.float(), want, rtol=2 ** -7, atol=3e-4)
    _check_flash_grads(q, k, v, do, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 80, 256])
def test_flash_backward_cancelling_head_on_card(hd, cuda_device):
    """bf16, causal, GQA 8/2 over 256 rows, kv head 0 and its query heads
    built so that their terms nearly cancel (tests/flash_bwd_bounds.py):
    within the bound, which a single bf16 rounding of P or dS would
    break."""
    g = torch.Generator().manual_seed(100 + hd)
    q, k, v, do = cancelling(*(
        torch.randn(2, h, 256, hd, generator=g).to(cuda_device,
                                                   torch.bfloat16)
        for h in (8, 2, 2, 8)))
    _check_flash_grads(q, k, v, do, dict(causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw,Sq,Sk", [(dict(causal=False, window=8), 40, 24),
                                      (dict(causal=True, window=4), 36, 20),
                                      (dict(causal=True, window=0), 24, 24)],
                         ids=["noncausal_past_keys", "causal_past_keys",
                              "no_window"])
def test_flash_backward_rows_without_keys_on_card(kw, Sq, Sk, dtype,
                                                  cuda_device):
    g = torch.Generator().manual_seed(Sq)
    q, do = (torch.randn(2, 4, Sq, 64, generator=g).to(cuda_device, dtype)
             for _ in range(2))
    k, v = (torch.randn(2, 2, Sk, 64, generator=g).to(cuda_device, dtype)
            for _ in range(2))
    _check_flash_grads(q, k, v, do, kw)


@pytest.mark.cuda
def test_flash_backward_in_the_model_layout_on_card(cuda_device):
    """The model's (B, S, H, hd) layout (strided views for the kernel)
    gives the (B, H, S, hd) gradients, bit for bit; kv_len is refused."""
    g = torch.Generator().manual_seed(3)
    q, do = (torch.randn(2, 24, 130, 64, generator=g).to(cuda_device,
                                                         torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(2, 8, 130, 64, generator=g).to(cuda_device,
                                                       torch.bfloat16)
            for _ in range(2))
    want = _flash_grads(q, k, v, do, ops.flash_attention)
    t = lambda x: x.transpose(1, 2).contiguous()
    got = _flash_grads(t(q), t(k), t(v), t(do), ops.flash_attention_bshd)
    assert all(torch.equal(a.transpose(1, 2), b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="kv_len"):
        ops.flash_attention(q.requires_grad_(True), k, v, kv_len=100)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq", [1, 4, 448, 1500])
def test_flash_whisper_noncausal_1500_keys_on_card(Sq, dtype, cuda_device):
    """whisper's attention without a mask: 20 heads of 64 over 1500 keys
    (the encoder's frames; a ragged last key tile), queries of one decode
    row, a 4-token prompt, the decoder's 448 tokens (the cross-attention)
    and the encoder's own 1500 rows.  The forward within 3e-4 (float32) or
    one bf16 step plus that of the plain version, the gradients within the
    backward's bound, one launch each."""
    g = torch.Generator().manual_seed(Sq)
    q, do = (torch.randn(1, 20, Sq, 64, generator=g).to(cuda_device, dtype)
             for _ in range(2))
    k, v = (torch.randn(1, 20, 1500, 64, generator=g).to(cuda_device, dtype)
            for _ in range(2))
    kw = dict(causal=False)
    before = {n: ops.COUNTERS[n].value
              for n in ("flash_attention", "flash_attention_bwd")}
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    rtol, atol = (3e-4, 3e-4) if dtype == torch.float32 else (2 ** -7, 3e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    _check_flash_grads(q, k, v, do, kw)
    torch.cuda.synchronize()
    assert {n: ops.COUNTERS[n].value - c for n, c in before.items()} == \
        {"flash_attention": 2, "flash_attention_bwd": 1}


@pytest.mark.cuda
def test_whisper_smoke_model_on_card_as_on_cpu(cuda_device):
    """whisper's smoke config in float32: a 24-token prompt over 8 frames,
    the prefill's logits and every cache key (k, v, and the
    cross-attention's xk, xv) on the card (kernels) against the CPU (plain
    versions), then three decode steps fed the same tokens, each device
    reading its own cache; one flash launch per encoder layer and two per
    decoder layer a prefill, none a decode step."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import LM, decode_step, prefill
    cfg = get_smoke("whisper-large-v3")
    card = LM(cfg, dtype=torch.float32, device=cuda_device,
              generator=torch.Generator(device=cuda_device).manual_seed(0))
    host = LM(cfg, dtype=torch.float32)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 24), generator=g)
    frames = torch.randn(2, cfg.enc_frames, cfg.d_model, generator=g)
    for c in ops.COUNTERS.values():
        c.reset()
    lc, cc = prefill(card, toks.to(cuda_device), capacity=32,
                     frames=frames.to(cuda_device))
    lh, ch = prefill(host, toks, capacity=32, frames=frames)
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-3, atol=1e-3)
    assert set(ch) == {"k", "v", "xk", "xv"}
    for k in ch:
        # bf16 cache rows: one bf16 step apart where they round apart
        torch.testing.assert_close(cc[k].float().cpu(), ch[k].float(),
                                   rtol=2 ** -7, atol=1e-3)
    for i in range(3):
        tok = toks[:, i]
        lc, cc = decode_step(card, cc, tok.to(cuda_device), 24 + i)
        lh, ch = decode_step(host, ch, tok, 24 + i)
        torch.testing.assert_close(lc.cpu(), lh, rtol=1e-3, atol=1e-3)
    torch.cuda.synchronize()
    assert ops.COUNTERS["flash_attention"].value == \
        cfg.n_enc_layers + 2 * cfg.n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 1024, 1536, 512),
                                   (40, 1024, 512, 1536), (4, 72, 1536, 512)],
                         ids=["granite_w_in", "granite_w_out", "ragged_c"])
def test_grouped_matmul_backward_matches_plain_on_card(shape, cuda_device):
    """bf16 dx = dy w^T and dw = x^T dy, each through its backward kernel
    (no transposed copy), within one bf16 step plus 2e-4 x max |plain| of
    autograd through the plain version."""
    from repro_torch.kernels import moe_gemm
    E, C, d, f = shape
    g = torch.Generator().manual_seed(C + d)
    x = torch.randn(E, C, d, generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn(E, d, f, generator=g) * d ** -0.5).to(cuda_device,
                                                           torch.bfloat16)
    dy = torch.randn(E, C, f, generator=g).to(cuda_device, torch.bfloat16)
    counters = (moe_gemm.bwd_launches, moe_gemm.bf16_launches["tma"],
                moe_gemm.bf16_launches["wmma"], *moe_gemm.bwd_kernels.values())
    before = [c.value for c in counters]
    xs, ws = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = ops.grouped_matmul(xs, ws)
    got = torch.autograd.grad(y, (xs, ws), dy)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    want = torch.autograd.grad(ref.grouped_matmul_ref(xr, wr), (xr, wr), dy)
    torch.cuda.synchronize()
    # the forward on the TMA kernel, then one dx and one dw kernel
    assert [c.value - b for c, b in zip(counters, before)] == [2, 1, 0, 1, 1]
    for a, b in zip(got, want):
        scale = b.float().abs().max().item()
        assert ((a.float() - b.float()).abs()
                <= 2 ** -7 * b.float().abs() + 2e-4 * scale).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 1024, 1536, 512),
                                   (40, 1024, 512, 1536), (40, 1, 1536, 512),
                                   (4, 65, 1536, 512), (4, 72, 512, 1536),
                                   (3, 72, 520, 72), (3, 65, 72, 520)],
                         ids=["granite_w_in", "granite_w_out", "C1", "C65",
                              "C72", "d520_f72", "d72_f520"])
def test_grouped_matmul_dx_dw_kernels_match_plain_on_card(shape,
                                                          cuda_device):
    """Each backward kernel alone against its plain version: dx and dw
    within one bf16 step plus 2e-4 x max |plain| (as the backward above),
    at granite's shapes, capacities that leave ragged tiles or a single
    row, and widths that are multiples of 8 but not of 64."""
    from repro_torch.kernels import moe_gemm
    E, C, d, f = shape
    g = torch.Generator().manual_seed(C * 7 + d)
    x = torch.randn(E, C, d, generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn(E, d, f, generator=g) * d ** -0.5).to(cuda_device,
                                                           torch.bfloat16)
    dy = torch.randn(E, C, f, generator=g).to(cuda_device, torch.bfloat16)
    before = {k: c.value for k, c in moe_gemm.bwd_kernels.items()}
    got = {"dx": moe_gemm.grouped_matmul_dx(dy, w),
           "dw": moe_gemm.grouped_matmul_dw(x, dy)}
    want = {"dx": ref.grouped_matmul_dx_ref(dy, w),
            "dw": ref.grouped_matmul_dw_ref(x, dy)}
    torch.cuda.synchronize()
    for k in got:
        assert moe_gemm.bwd_kernels[k].value == before[k] + 1
        assert got[k].dtype == torch.bfloat16
        assert got[k].shape == want[k].shape
        err = (got[k].float() - want[k].float()).abs()
        scale = want[k].float().abs().max().item()
        assert (err <= 2 ** -7 * want[k].float().abs() + 2e-4 * scale).all(), k


@pytest.mark.cuda
def test_grouped_matmul_dx_dw_kernels_refuse_what_the_tma_cannot_read(
        cuda_device):
    """A width that is not a multiple of 8, or a base off 16 bytes: the
    wrappers raise, and the entry points return an error without a
    launch."""
    from repro_torch.kernels import _build, moe_gemm
    bf = dict(device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        moe_gemm.grouped_matmul_dx(torch.ones(2, 8, 12, **bf),
                                   torch.ones(2, 16, 12, **bf))
    base = torch.ones(2 * 8 * 16 + 1, **bf)
    with pytest.raises(ValueError, match="16-byte"):
        moe_gemm.grouped_matmul_dw(base[1:].view(2, 8, 16),
                                   torch.ones(2, 8, 16, **bf))
    lib, stream = _build.library(), torch.cuda.current_stream().cuda_stream
    out = torch.empty(2, 16, 16, **bf)
    assert lib.grouped_matmul_dw(base[1:].data_ptr(), out.data_ptr(),
                                 out.data_ptr(), 2, 8, 16, 16,
                                 cuda_device.index or 0, stream) != 0
    assert lib.grouped_matmul_dx(out.data_ptr(), out.data_ptr(),
                                 out.data_ptr(), 2, 8, 12, 16,
                                 cuda_device.index or 0, stream) != 0


@pytest.mark.cuda
def test_grouped_matmul_backward_copies_nothing_on_card(cuda_device):
    """The bf16 backward at granite's w_in allocates dx and dw and nothing
    of x's or w's size besides: the peak over the backward stays below
    dx + dw + one w (the parent's transposed copies added an x and a w)."""
    E, C, d, f = 40, 1024, 1536, 512
    g = torch.Generator().manual_seed(3)
    x = torch.randn(E, C, d, generator=g).to(cuda_device, torch.bfloat16)
    w = (torch.randn(E, d, f, generator=g) * d ** -0.5).to(cuda_device,
                                                           torch.bfloat16)
    dy = torch.randn(E, C, f, generator=g).to(cuda_device, torch.bfloat16)
    xs, ws = x.requires_grad_(True), w.requires_grad_(True)
    y = ops.grouped_matmul(xs, ws)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    dx, dw = torch.autograd.grad(y, (xs, ws), dy)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - start
    nbytes = 2 * (E * C * d + E * d * f)        # dx and dw
    assert nbytes <= extra < nbytes + 2 * E * d * f, (extra, nbytes)


@pytest.mark.cuda
def test_ssd_scan_refuses_to_be_differentiated_on_card(cuda_device):
    """The backward takes float32 x, B and C: a bfloat16 input that needs a
    gradient raises, and does not take the plain version; without grad
    bf16 runs the forward kernel."""
    x = torch.randn(1, 64, 32, device=cuda_device,
                    dtype=torch.bfloat16).requires_grad_(True)
    dt = torch.rand(1, 64, 2, device=cuda_device)
    B, C = (torch.randn(1, 64, 16, device=cuda_device, dtype=torch.bfloat16)
            for _ in range(2))
    A = -torch.rand(2, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        ops.ssd_scan(x, dt, B, C, A, chunk=32)
    with torch.no_grad():
        ops.ssd_scan(x, dt, B, C, A, chunk=32)


def _ssd_grads(fn, inputs, h0, dy, dh, chunk):
    """fn's gradients (dx, ddt, dB, dC, dA, and dh0 when h0 is given) for
    the output gradients dy and dh (None: h_final unused)."""
    xs = [t.detach().clone().requires_grad_(True) for t in inputs]
    h0r = None if h0 is None else h0.detach().clone().requires_grad_(True)
    y, h = fn(*xs, chunk=chunk, h0=h0r)
    outs, gs = ([y, h], [dy, dh]) if dh is not None else ([y], [dy])
    return torch.autograd.grad(outs, xs + ([] if h0r is None else [h0r]),
                               gs)


def _ssd_grads_within_bound(got, want):
    """max |err| <= 1e-4 x max |g| for each gradient, as the CPU emulation
    of the kernel is held (tests/test_torch_ssd_bwd_emu.py)."""
    assert len(got) == len(want)
    for name, g, w in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"), got, want):
        assert torch.isfinite(g).all(), name
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item(), \
            name


@pytest.mark.cuda
@pytest.mark.parametrize("Bsz,S,nh,hd,ds,chunk,h0,dh", [
    (1, 64, 2, 16, 16, 16, False, False),
    (2, 96, 2, 16, 64, 16, True, True),
    (1, 300, 3, 16, 16, 100, True, False),
    (1, 232, 2, 64, 64, 232, False, True),
    (2, 384, 3, 48, 80, 128, True, True),
    (1, 260, 2, 128, 128, 130, True, True),
    (1, 192, 2, 16, 128, 64, False, True),
    (1, 200, 2, 128, 16, 40, True, False),
    (8, 512, 80, 64, 64, 256, False, False),
    (2, 300, 5, 64, 128, 150, True, True),
    (8, 512, 64, 64, 128, 256, False, False),
], ids=["chunk16", "chunk16_h0_dh", "chunk100_h0", "chunk232_dh", "hd48_ds80",
        "hd128_ds128", "hd16_ds128", "hd128_ds16", "zamba2_training",
        "hd64_ds128_chunk150", "mamba2_training"])
def test_ssd_backward_matches_plain_on_card(Bsz, S, nh, hd, ds, chunk, h0,
                                            dh, cuda_device):
    """``ops.ssd_scan``'s gradients (the forward kernel, then the backward
    kernel under autograd) against autograd through the plain recurrence,
    h0 and dh_final each present and absent; zamba2's training shape (8 x
    512 tokens, 80 heads of 64, d_state 64), and head_dim 64 against
    d_state 128 on chunks of 150 (no multiple of 64)."""
    inputs = _ssd_inputs(Bsz, S, nh, hd, ds, torch.float32, cuda_device,
                         seed=hd + ds + chunk)
    g = torch.Generator().manual_seed(chunk)
    rand = lambda *s: torch.randn(*s, generator=g).to(cuda_device)
    h0t = rand(Bsz, nh, ds, hd) if h0 else None
    dy = rand(Bsz, S, nh * hd)
    dht = rand(Bsz, nh, ds, hd) if dh else None
    before = ops.COUNTERS["ssd_scan_bwd"].value
    got = _ssd_grads(ops.ssd_scan, inputs, h0t, dy, dht, chunk)
    torch.cuda.synchronize()
    assert ops.COUNTERS["ssd_scan_bwd"].value == before + 1
    want = _ssd_grads(ref.ssd_scan_ref, inputs, h0t, dy, dht, chunk)
    _ssd_grads_within_bound(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,ds,groups", [
    (128, 128, 1), (128, 128, 2), (128, 128, 3), (128, 128, 4),
    (128, 128, 5), (64, 128, 2), (128, 64, 2), (64, 64, 2),
], ids=["hd128_ds128_one_group", "hd128_ds128_3_2", "hd128_ds128_2_2_1",
        "hd128_ds128_2_2_1_empty", "hd128_ds128_one_head_a_group",
        "hd64_ds128_3_2", "hd128_ds64_3_2", "hd64_ds64_3_2"])
def test_ssd_backward_groups_of_heads_on_card(hd, ds, groups, monkeypatch,
                                              cuda_device):
    """5 heads taken by the query and key kernels in ``groups`` groups of
    ceil(5 / groups), the last ragged (3 + 2, 2 + 2 + 1) or, at 4 groups,
    empty: dCB and the state terms of dB and dC summed over each group's
    heads in shared memory, then over the groups, for every build of
    head_dim and d_state in one or two 64-wide pieces; chunks of 150, h0
    and dh_final present."""
    from repro_torch.kernels import ssd_scan as tssd
    monkeypatch.setattr(tssd, "head_groups", lambda nh: groups)
    Bsz, S, nh, chunk = 2, 300, 5, 150
    inputs = _ssd_inputs(Bsz, S, nh, hd, ds, torch.float32, cuda_device,
                         seed=groups + hd + ds)
    g = torch.Generator().manual_seed(groups)
    rand = lambda *s: torch.randn(*s, generator=g).to(cuda_device)
    h0t = rand(Bsz, nh, ds, hd)
    dy = rand(Bsz, S, nh * hd)
    dht = rand(Bsz, nh, ds, hd)
    before = ops.COUNTERS["ssd_scan_bwd"].value
    got = _ssd_grads(ops.ssd_scan, inputs, h0t, dy, dht, chunk)
    torch.cuda.synchronize()
    assert ops.COUNTERS["ssd_scan_bwd"].value == before + 1
    want = _ssd_grads(ref.ssd_scan_ref, inputs, h0t, dy, dht, chunk)
    _ssd_grads_within_bound(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [1, 37, 232])
def test_ssd_backward_tail_chained_on_card(tail, cuda_device):
    """512 positions in chunks of 256, then a ragged tail as one chunk of
    its own through h0, as ``ssd_prefill`` chains them: the gradients of
    both calls together against the recurrence over the whole sequence."""
    S, nh, hd, ds = 512, 4, 64, 64
    inputs = _ssd_inputs(1, S + tail, nh, hd, ds, torch.float32,
                         cuda_device, seed=tail)
    dy = torch.randn(1, S + tail, nh * hd,
                     generator=torch.Generator().manual_seed(tail)).to(
        cuda_device)

    def chained(x, dt, Bm, Cm, A, chunk, h0):
        y1, h1 = ops.ssd_scan(x[:, :S], dt[:, :S], Bm[:, :S], Cm[:, :S], A,
                              chunk=256)
        y2, h2 = ops.ssd_scan(x[:, S:], dt[:, S:], Bm[:, S:], Cm[:, S:], A,
                              chunk=tail, h0=h1)
        return torch.cat([y1, y2], 1), h2
    before = ops.COUNTERS["ssd_scan_bwd"].value
    got = _ssd_grads(chained, inputs, None, dy, None, 1)
    torch.cuda.synchronize()
    assert ops.COUNTERS["ssd_scan_bwd"].value == before + 2
    _ssd_grads_within_bound(got, _ssd_grads(ref.ssd_scan_ref, inputs, None,
                                            dy, None, 1))


@pytest.mark.cuda
def test_ssd_backward_strong_decay_and_repeats_on_card(cuda_device):
    """A decay so strong (A x 40) that exp(cum_q - cum_k) above the diagonal
    overflows: selected, never multiplied, so no NaN; and no float atomics,
    so a second call gives the same bits."""
    x, dt, Bm, Cm, A = _ssd_inputs(1, 256, 2, 32, 32, torch.float32,
                                   cuda_device, seed=9)
    inputs = (x, dt, Bm, Cm, A * 40.0)
    g = torch.Generator().manual_seed(9)
    h0 = torch.randn(1, 2, 32, 32, generator=g).to(cuda_device)
    dy = torch.randn(1, 256, 64, generator=g).to(cuda_device)
    dh = torch.randn(1, 2, 32, 32, generator=g).to(cuda_device)
    got = _ssd_grads(ops.ssd_scan, inputs, h0, dy, dh, 128)
    again = _ssd_grads(ops.ssd_scan, inputs, h0, dy, dh, 128)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _ssd_grads_within_bound(got, _ssd_grads(ref.ssd_scan_ref, inputs, h0,
                                            dy, dh, 128))


@pytest.mark.cuda
def test_ssd_backward_repeats_bit_for_bit_at_zamba2_shape_on_card(
        cuda_device):
    """At the training shape every sum over heads, chunks and batch is a
    fixed-order pass: two calls of the backward give the same bits, one
    launch count each."""
    from repro_torch.kernels import ssd_scan as tssd
    x, dt, Bm, Cm, A = _ssd_inputs(8, 512, 80, 64, 64, torch.float32,
                                   cuda_device, seed=5)
    _, _, states, cum = tssd.ssd_scan_with_states(x, dt, Bm, Cm, A,
                                                  chunk=256)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(5)).to(
        cuda_device)
    before = tssd.bwd_launches.value
    first = tssd.ssd_scan_backward(x, dt, Bm, Cm, A, None, states, cum, dy,
                                   None, chunk=256)
    second = tssd.ssd_scan_backward(x, dt, Bm, Cm, A, None, states, cum, dy,
                                    None, chunk=256)
    torch.cuda.synchronize()
    assert tssd.bwd_launches.value == before + 2
    assert first[5] is None and second[5] is None
    assert all(torch.equal(a, b) for a, b in zip(first[:5], second[:5]))


@pytest.mark.cuda
def test_zamba2_launcher_trains_on_card(cuda_device, capsys):
    """``launch.train`` of the hybrid family on the card (it stopped before
    its first step while the SSD scan had no backward kernel)."""
    from repro_torch.launch import train as tlaunch
    assert tlaunch.main(["--arch", "zamba2-2.7b", "--smoke", "--steps",
                         "2"]) == 0
    out = capsys.readouterr().out
    assert "[train] done" in out and "device=cuda" in out


@pytest.mark.cuda
def test_zamba2_smoke_train_step_on_card_as_on_cpu(cuda_device):
    """One float32 train step of zamba2's smoke config, the same parameters
    and batch on the card (kernels, their backward) and on the CPU (plain
    versions): the loss at rtol 1e-5, every gradient within 1e-4 x its
    max |g| (plus 1e-7), and the launches of one forward and backward."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import LM
    from repro_torch.runtime import RuntimeConfig, make_loss_fn
    from repro_torch.runtime.train import trainable
    cfg = get_smoke("zamba2-2.7b")
    host = LM(cfg, dtype=torch.float32,
              generator=torch.Generator().manual_seed(0))
    card = LM(cfg, dtype=torch.float32, device=cuda_device)
    card.load_state_dict(host.state_dict())
    b = batch_at(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2), 0)
    loss_fn = make_loss_fn(cfg, RuntimeConfig(remat=None))
    out = {}
    for c in ops.COUNTERS.values():
        c.reset()
    for model, dev in ((host, "cpu"), (card, "cuda")):
        params = trainable(model)
        total, (loss, _) = loss_fn(model, b["tokens"].to(dev),
                                   b["labels"].to(dev))
        grads = torch.autograd.grad(total, list(params.values()))
        out[dev] = (loss.item(), {k: g.cpu() for k, g in zip(params, grads)})
    torch.cuda.synchronize()
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for k, w in out["cpu"][1].items():
        assert (out["cuda"][1][k] - w).abs().max() <= \
            1e-4 * w.abs().max() + 1e-7, k
    groups = len(card.layers)
    mamba = sum(len(grp.mamba) for grp in card.layers)
    assert ops.COUNTERS["ssd_scan"].value == mamba
    assert ops.COUNTERS["ssd_scan_bwd"].value == mamba
    assert ops.COUNTERS["flash_attention"].value == groups
    assert ops.COUNTERS["flash_attention_bwd"].value == groups


@pytest.mark.cuda
def test_no_cuda_entry_returns_a_result_autograd_cannot_see(cuda_device):
    """Every CUDA entry of ops, given an input that requires grad, either
    returns a result with a grad_fn or raises."""
    dev = cuda_device
    req = lambda *s: torch.rand(*s, device=dev).requires_grad_(True)
    carried = [
        ops.flash_attention(req(1, 2, 16, 16), req(1, 2, 16, 16),
                            req(1, 2, 16, 16)),
        ops.flash_attention_bshd(req(1, 16, 2, 16), req(1, 16, 2, 16),
                                 req(1, 16, 2, 16)),
        ops.grouped_matmul(req(2, 8, 16), req(2, 16, 8)),
        *ops.ssd_scan(req(1, 32, 16), torch.rand(1, 32, 1, device=dev),
                      torch.rand(1, 32, 16, device=dev),
                      torch.rand(1, 32, 16, device=dev),
                      -torch.rand(1, device=dev), chunk=32),
    ]
    assert all(t.grad_fn is not None for t in carried)
    refused = [
        lambda: ops.saxpy(2.0, req(10), req(10)),
        lambda: ops.filter_pipeline(req(8, 8) * 255),
        lambda: ops.segmentation(req(2, 8, 8) * 255),
        lambda: ops.nbody_accelerations(req(8, 3), torch.rand(8, device=dev)),
        lambda: ops.nbody_step(req(8, 3), torch.zeros(8, 3, device=dev),
                               torch.rand(8, device=dev)),
    ]
    for fn in refused:
        with pytest.raises(NotImplementedError, match="backward"):
            fn()


@pytest.mark.cuda
def test_granite_smoke_train_step_on_card_as_on_cpu(cuda_device):
    """One float32 train step of granite's smoke config, the same
    parameters and batch on the card (kernels, their backward) and on the
    CPU (plain versions): the loss at rtol 1e-5, every gradient within
    1e-4 x its max |g|, and the launches of one forward and backward."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import LM
    from repro_torch.runtime import RuntimeConfig, make_loss_fn
    from repro_torch.runtime.train import trainable
    cfg = get_smoke("granite-moe-3b-a800m")
    host = LM(cfg, dtype=torch.float32,
              generator=torch.Generator().manual_seed(0))
    card = LM(cfg, dtype=torch.float32, device=cuda_device)
    card.load_state_dict(host.state_dict())
    b = batch_at(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=2), 0)
    loss_fn = make_loss_fn(cfg, RuntimeConfig(remat=None))
    out = {}
    for c in ops.COUNTERS.values():
        c.reset()
    for model, dev in ((host, "cpu"), (card, "cuda")):
        params = trainable(model)
        total, (loss, _) = loss_fn(model, b["tokens"].to(dev),
                                   b["labels"].to(dev))
        grads = torch.autograd.grad(total, list(params.values()))
        out[dev] = (loss.item(), {k: g.cpu() for k, g in zip(params, grads)})
    torch.cuda.synchronize()
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    for k, w in out["cpu"][1].items():
        assert (out["cuda"][1][k] - w).abs().max() <= \
            1e-4 * w.abs().max() + 1e-7, k
    L = cfg.n_layers
    assert ops.COUNTERS["flash_attention"].value == L
    assert ops.COUNTERS["flash_attention_bwd"].value == L
    assert ops.COUNTERS["grouped_matmul"].value == 9 * L


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True,
                                                       window=40)],
                         ids=["causal", "window"])
@pytest.mark.parametrize("hd", [84, 96])
def test_flash_padded_head_dims_match_plain_on_card(hd, kw, dtype,
                                                    cuda_device):
    """Head dims the kernels are not instantiated for run padded up to 128
    (scale 1/sqrt(hd)): forward, forward with lse and backward, GQA 4/2,
    against the plain version at the other dims' bounds; each call
    launches the kernels."""
    g = torch.Generator().manual_seed(hd)
    q, do = (torch.randn(2, 4, 150, hd, generator=g).to(cuda_device, dtype)
             for _ in range(2))
    k, v = (torch.randn(2, 2, 150, hd, generator=g).to(cuda_device, dtype)
            for _ in range(2))
    before = (ops.COUNTERS["flash_attention"].value,
              ops.COUNTERS["flash_attention_bwd"].value)
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    rtol, atol = (3e-4, 3e-4) if dtype == torch.float32 else (2 ** -7, 3e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    assert got.shape == q.shape and got.is_contiguous()
    _check_flash_grads(q, k, v, do, kw)
    torch.cuda.synchronize()
    assert (ops.COUNTERS["flash_attention"].value,
            ops.COUNTERS["flash_attention_bwd"].value) == \
        (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_flash_refuses_head_dims_above_256_on_card(cuda_device):
    q = torch.randn(1, 2, 8, 264, device=cuda_device)
    with pytest.raises(ValueError, match="above 256"):
        ops.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("gate", ["locality", "pipeline", "telemetry_smoke"])
def test_gate_on_cuda_stream_slots(gate, cuda_device, tmp_path):
    """Each gate of ``repro_torch.bench`` at its smoke size with the
    accelerator slots on CUDA streams: every deterministic gate holds
    (wall-clock ratios are not asserted); the telemetry smoke's clean
    accelerator slot spans each last at least their CUDA-event time."""
    import json
    from repro_torch.bench import locality, pipeline, telemetry_smoke
    if gate == "telemetry_smoke":
        trace = tmp_path / "trace.json"
        res = telemetry_smoke.smoke(str(trace), "cuda")
        assert res["deterministic_failures"] == []
        spans = [s for s in telemetry_smoke.slot_spans(
            json.loads(trace.read_text()))
            if s["device"].startswith("gpu") and "fault" not in s["args"]]
        assert spans and all(s["us"] >= s["args"]["device_ms"] * 1e3
                             for s in spans)
        return
    mod = {"locality": locality, "pipeline": pipeline}[gate]
    res = mod.bench(True, (1 << 19) if gate == "locality" else (1 << 18),
                    "cuda")
    assert mod.deterministic_failures(res) == []


@pytest.mark.cuda
def test_quickstart_on_card(cuda_device, capsys):
    from repro_torch.examples import quickstart
    quickstart.main(["--device", "cuda"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "quickstart OK"


@pytest.mark.cuda
def test_hybrid_host_saxpy_on_card(cuda_device):
    """``hybrid``'s host testbed for saxpy at 10^6: Algorithm 1 searches
    on the card's stream slots and the host's fission slots and returns a
    profile, the tuned run's and the GPU-only baseline's outputs hold to
    the plain version (checked inside ``host_cell``), and every
    accelerator segment launched the saxpy kernel."""
    from repro_torch.bench import hybrid
    ops.COUNTERS["saxpy"].reset()
    cell = hybrid.host_cell("saxpy", 10 ** 6, "cuda")
    assert cell["evals"] == len(cell["trace"]) > 0
    assert math.isfinite(cell["hybrid_time"]) and 0 <= cell["gpu_share"] <= 1
    assert cell["fission"] in cell["threads"]
    assert set(cell["max_abs_err"]) == {"hybrid", "gpu_only"}
    assert ops.COUNTERS["saxpy"].value >= cell["gpu_segments"] > 0


# ---------------------------------------------------------------------------
# the dry-run's meta route against the card's
# ---------------------------------------------------------------------------

def _meta_and_card(fn, *tensors):
    """``fn`` on the card's tensors and on meta copies, forward and (where
    the inputs need grad) backward: the outputs' and the gradients' shapes
    and dtypes from both."""
    def run(dev):
        ins = [t.detach().to(dev).requires_grad_(t.requires_grad)
               for t in tensors]
        out = fn(*ins)
        outs = out if isinstance(out, tuple) else (out,)
        sig = [(tuple(o.shape), o.dtype) for o in outs]
        if any(t.requires_grad for t in ins):
            outs[0].float().sum().backward()
            sig += [(tuple(t.grad.shape), t.grad.dtype) for t in ins
                    if t.requires_grad]
        return sig
    return run("meta"), run(tensors[0].device)


@pytest.mark.cuda
@pytest.mark.parametrize("grad", [False, True])
def test_meta_route_shapes_equal_card_route(grad, cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=cuda_device).to(
            dtype).requires_grad_(grad)

    q, k = randn(2, 128, 8, 64, dtype=bf16), randn(2, 128, 2, 64, dtype=bf16)
    v = randn(2, 128, 2, 64, dtype=bf16)
    meta, card = _meta_and_card(lambda a, b, c: ops.flash_attention_bshd(
        a, b, c, causal=True, window=48), q, k, v)
    assert meta == card
    x = randn(2, 256, 4 * 64)
    dt = (torch.rand((2, 256, 4), generator=g, device=cuda_device) * 0.1)
    Bm, Cm = randn(2, 256, 64), randn(2, 256, 64)
    A = -torch.rand(4, generator=g, device=cuda_device)
    meta, card = _meta_and_card(lambda a, b, c, d, e: ops.ssd_scan(
        a, b, c, d, e, chunk=128), x, dt, Bm, Cm, A)
    assert meta == card
    xe, w = randn(4, 64, 128, dtype=bf16), randn(4, 128, 96, dtype=bf16)
    meta, card = _meta_and_card(ops.grouped_matmul, xe, w)
    assert meta == card


@pytest.mark.cuda
def test_one_dry_run_cell_fits_the_card(cuda_device):
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import HBM_PER_CARD
    assert torch.cuda.get_device_properties(0).total_memory == HBM_PER_CARD
    rec = dryrun.run_cell("mamba2-1.3b", "long_500k")
    assert rec["memory"]["fits_hbm"]
    assert 0 < rec["memory"]["peak_per_card_bytes"] < HBM_PER_CARD


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off,window", [(0, None), (160, None), (160, 200),
                                        (160, 64)],
                         ids=["offset0", "offset", "window_past_block",
                              "window_inside"])
def test_flash_offset_matches_plain_on_card(off, window, dtype, cuda_device):
    """A sequence shard's causal attention (``flash_attention_offset_bshd``:
    96 queries at positions off .. off+95 over the keys 0 .. off+95, GQA
    8/2, head dim 64, model layout): the kernel's two calls merged by
    their log-sum-exps, and the backward kernel on each block with the
    merged output, against the plain version with the query offset.
    float32: BWD_TOL of the largest value.  bf16: each block's output and
    dq are rounded to bf16 before they are merged or summed, so one more
    bf16 step (2^-7) than a single call's bound."""
    g = torch.Generator().manual_seed(off + (window or 0))
    Sq, Sk = 96, off + 96
    q, do = (torch.randn(2, Sq, 8, 64, generator=g).to(cuda_device, dtype)
             for _ in range(2))
    k, v = (torch.randn(2, Sk, 2, 64, generator=g).to(cuda_device, dtype)
            for _ in range(2))
    kw = dict(q_offset=off, window=window)

    def plain(q, k, v, q_offset, window):
        o = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, window=window,
                              q_offset=q_offset)
        return o.transpose(1, 2)

    before = ops.COUNTERS["flash_attention"].value
    got = _flash_grads(q, k, v, do, ops.flash_attention_offset_bshd, **kw)
    want = _flash_grads(q.float(), k.float(), v.float(), do.float(), plain,
                        **kw)
    torch.cuda.synchronize()
    a = 0 if window is None else max(0, off - window + 1)
    calls = 1 if off == 0 or a >= off else 2
    assert ops.COUNTERS["flash_attention"].value == before + calls
    for name, x, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and x.shape == w.shape
        err = (x.float() - w).abs()
        bound = BWD_TOL * w.abs().max()
        if dtype == torch.bfloat16:
            bound = bound + 3 * 2 ** -7 * w.abs() + 3e-3 * w.abs().max()
        assert (err <= bound).all(), (name, err.max().item())


# ---------------------------------------------------------------------------
# the decode step as one CUDA graph (repro_torch.runtime.graphs)
# ---------------------------------------------------------------------------

GRAPH_STEPS = 16


@pytest.mark.cuda
@pytest.mark.parametrize("arch,prompt", [("zamba2-2.7b", 20),
                                         ("granite-moe-3b-a800m", 20),
                                         ("gemma2-2b", 24)])
def test_graphed_engine_matches_eager_step_on_card(arch, prompt,
                                                   cuda_device):
    """bf16 smoke models as served: the engine's decode graph and an eager
    ``decode_step`` over a copy of the same cache, from the same tokens,
    give bit-identical logits and the same greedy tokens over 16 steps
    (gemma2's prompts run past its 16-row window, so its local cache
    rolls); each replay counts the grouped GEMMs the eager step launches."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import LM, decode_step
    from repro_torch.runtime import ServeEngine, greedy
    cfg = get_smoke(arch)
    model = LM(cfg, device=cuda_device,
               generator=torch.Generator(device=cuda_device).manual_seed(0))
    seen = []
    eng = ServeEngine(cfg, model, slots=2, capacity=64,
                      on_step=lambda kind, n, s, logits: seen.append(
                          logits.clone()) if kind == "decode" else None)
    assert eng.graph.cuda_graph is not None
    g = torch.Generator().manual_seed(1)
    for n in (prompt, prompt - 5):
        eng.submit(torch.randint(0, cfg.vocab, (n,), generator=g).tolist(),
                   max_new=GRAPH_STEPS + 1)
    eng._admit()
    cache = {k: v.clone() for k, v in eng.cache.items()}
    tok, pos = eng.cur_token.clone(), eng.pos
    for c in ops.COUNTERS.values():
        c.reset()
    for i in range(GRAPH_STEPS):
        assert eng.step() == (2 if i < GRAPH_STEPS - 1 else 0)
        want, _ = decode_step(model, cache, tok, pos + i)
        assert torch.equal(seen[-1], want), i
        tok = greedy(want)
        assert torch.equal(eng.cur_token, tok), i
    for k in cache:
        assert torch.equal(eng.cache[k], cache[k]), k
    torch.cuda.synchronize()
    moe_calls = (3 * cfg.n_layers * 2 * GRAPH_STEPS
                 if cfg.moe is not None else 0)
    assert ops.COUNTERS["grouped_matmul"].value == moe_calls


@pytest.mark.cuda
def test_whisper_decode_graph_matches_eager_step_on_card(cuda_device):
    """whisper's smoke model: a ``DecodeGraph`` over a prefilled cache with
    frames against eager steps over a copy, past the 128-row table of
    learned positions (a position there reads the table's last row)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import LM, decode_step, prefill
    from repro_torch.runtime import DecodeGraph
    cfg = get_smoke("whisper-large-v3")
    model = LM(cfg, device=cuda_device,
               generator=torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator(device=cuda_device).manual_seed(7)
    frames = torch.randn((2, cfg.enc_frames, cfg.d_model), generator=g,
                         device=cuda_device).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=g,
                         device=cuda_device)
    logits, cache = prefill(model, toks, capacity=32, frames=frames)
    eager = {k: v.clone() for k, v in cache.items()}
    graph = DecodeGraph(model, cache, 2)
    tok = greedy_of(logits)
    for pos in [*range(20, 20 + GRAPH_STEPS // 2), 127, 128, 200]:
        got = graph(pos, tok)
        want, _ = decode_step(model, eager, tok, pos)
        assert torch.equal(got, want), pos
        tok = greedy_of(want)
    for k in cache:
        assert torch.equal(cache[k], eager[k]), k


def greedy_of(logits):
    return torch.argmax(logits, dim=-1)


@pytest.mark.cuda
def test_decode_graph_refuses_rebound_parameters_on_card(cuda_device):
    """A replay after a parameter was rebound raises (the graph baked in the
    old address, the grouped GEMM's TMA maps too), in the graph and through
    the engine; nothing falls back to an eager step."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.faults import ExecutionError
    from repro_torch.models import LM, init_cache
    from repro_torch.runtime import DecodeGraph, ServeEngine
    cfg = get_smoke("granite-moe-3b-a800m")
    model = LM(cfg, device=cuda_device,
               generator=torch.Generator(device=cuda_device).manual_seed(0))
    graph = DecodeGraph(model, init_cache(cfg, 2, 32, device=cuda_device), 2)
    eng = ServeEngine(cfg, model, slots=2, capacity=32)
    eng.submit([1, 2, 3], max_new=4)
    assert eng.step() == 1
    before = graph(3).clone()
    moe = model.layers[0].moe
    moe.w_in = torch.nn.Parameter(moe.w_in.detach().clone(),
                                  requires_grad=False)
    with pytest.raises(RuntimeError, match="moved since its capture"):
        graph(4)
    with pytest.raises(ExecutionError, match="moved since its capture"):
        eng.step()
    assert torch.isfinite(before).all()


@pytest.mark.cuda
def test_decode_graphs_give_their_memory_back_on_card(cuda_device):
    """A decode graph dropped leaves nothing allocated: after a first graph
    (which may make the lazy handles a process keeps), three more made and
    dropped return ``memory_allocated`` to where it was."""
    import gc
    from repro_torch.configs import get_smoke
    from repro_torch.models import LM, init_cache
    from repro_torch.runtime import DecodeGraph, ServeEngine
    cfg = get_smoke("granite-moe-3b-a800m")
    model = LM(cfg, device=cuda_device,
               generator=torch.Generator(device=cuda_device).manual_seed(0))
    DecodeGraph(model, init_cache(cfg, 2, 32, device=cuda_device), 2)(3)
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for _ in range(3):
        DecodeGraph(model, init_cache(cfg, 2, 32, device=cuda_device), 2)(3)
        eng = ServeEngine(cfg, model, slots=2, capacity=32)
        eng.submit([1, 2, 3], max_new=3)
        eng.run_to_completion()
        del eng
        gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


# ---------------------------------------------------------------------------
# The prefill as one CUDA graph per prompt length (runtime/graphs.py)
# ---------------------------------------------------------------------------

def _kernel_counts():
    torch.cuda.synchronize()
    return {k: c.value for k, c in ops.COUNTERS.items()}


def _reset_counts():
    for c in ops.COUNTERS.values():
        c.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-moe-3b-a800m",
                                  "gemma2-2b"])
def test_prefill_graph_replays_match_eager_on_card(arch, cuda_device):
    """bf16 smoke models as served: prompts long, short, long, short,
    long, each drawn anew (gemma2's long one past its 16-row window),
    through one ``PrefillGraphs``: each call's logits and every cache
    entry bit-identical to an eager prefill into a fresh cache (a length's
    first call eager, its second captured and replayed, its third a replay
    after the other length's graph used the shared pool and the static
    cache), one graph a length in one shared pool, and each call, eager,
    captured or replayed, counting the launches of one eager prefill."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import LM, prefill
    from repro_torch.runtime import PrefillGraphs
    cfg = get_smoke(arch)
    model = LM(cfg, device=cuda_device,
               generator=torch.Generator(device=cuda_device).manual_seed(0))
    graphs = PrefillGraphs(model, 32)
    assert graphs.pool is not None
    g = torch.Generator().manual_seed(2)
    for n in (28, 9, 28, 9, 28):
        toks = torch.randint(0, cfg.vocab, (1, n), generator=g).to(
            cuda_device)
        _reset_counts()
        logits, cache = graphs(toks)
        counted = _kernel_counts()
        _reset_counts()
        want_logits, want_cache = prefill(model, toks, capacity=32)
        assert counted == _kernel_counts(), n
        assert counted["flash_attention"] > 0, n
        assert torch.equal(logits, want_logits), n
        for k in want_cache:
            assert torch.equal(cache[k], want_cache[k]), (n, k)
    seen = graphs.lengths
    assert sorted(seen) == [9, 28]
    assert [seen[n].replays for n in (28, 9)] == [2, 1]
    for length in seen.values():
        assert length.graph is not None and length.capture_s > 0
    assert graphs.pool_bytes() > 0


@pytest.mark.cuda
def test_prefill_graph_refuses_rebound_parameters_on_card(cuda_device):
    """A replay after a parameter was rebound raises (the graph baked in
    the old address, the grouped GEMM's TMA maps too), in the holder and
    through the engine's admit; nothing falls back to an eager prefill."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import LM
    from repro_torch.runtime import PrefillGraphs, ServeEngine
    cfg = get_smoke("granite-moe-3b-a800m")
    model = LM(cfg, device=cuda_device,
               generator=torch.Generator(device=cuda_device).manual_seed(0))
    graphs = PrefillGraphs(model, 32)
    toks = torch.arange(12, device=cuda_device)[None] % cfg.vocab
    graphs(toks)
    before = graphs(toks)[0].clone()
    assert graphs.lengths[12].graph is not None
    eng = ServeEngine(cfg, model, slots=2, capacity=32)
    for _ in range(2):
        eng.submit(toks[0].tolist(), max_new=1)
    assert len(eng.run_to_completion()) == 2
    assert eng.prefill_graphs.lengths[12].graph is not None
    moe = model.layers[0].moe
    moe.w_in = torch.nn.Parameter(moe.w_in.detach().clone(),
                                  requires_grad=False)
    with pytest.raises(RuntimeError, match="moved since its capture"):
        graphs(toks)
    eng.submit(toks[0].tolist(), max_new=1)
    with pytest.raises(RuntimeError, match="moved since its capture"):
        eng.step()
    assert torch.isfinite(before).all()


@pytest.mark.cuda
def test_engine_captures_each_repeated_prompt_length_once_on_card(
        cuda_device):
    """zamba2's smoke model through the engine: a length's first prefill
    eager, one capture at its second, a replay for each repeat (none for a
    length seen once), each request's first token the eager prefill's, and
    the kernels' counters reading one prefill a request although every
    capture happened mid-run."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import LM, prefill
    from repro_torch.runtime import ServeEngine
    cfg = get_smoke("zamba2-2.7b")
    model = LM(cfg, device=cuda_device,
               generator=torch.Generator(device=cuda_device).manual_seed(0))
    g = torch.Generator().manual_seed(3)
    lengths = (20, 37, 20, 9, 37, 20)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in lengths]
    eng = ServeEngine(cfg, model, slots=2, capacity=64)
    _reset_counts()
    for p in prompts:
        eng.submit(p, max_new=3)
    done = {r.rid: r.out for r in eng.run_to_completion()}
    served = _kernel_counts()
    want = {k: 0 for k in served}
    for rid, p in enumerate(prompts):
        _reset_counts()
        logits, _ = prefill(model, torch.tensor([p], device=cuda_device),
                            capacity=64)
        assert done[rid][0] == int(torch.argmax(logits[0])), rid
        for k, n in _kernel_counts().items():
            want[k] += n
    assert served["flash_attention"] == want["flash_attention"] > 0
    assert served["ssd_scan"] == want["ssd_scan"] > 0
    seen = eng.prefill_graphs.lengths
    assert sorted(seen) == [9, 20, 37]
    assert [seen[n].replays for n in (20, 37, 9)] == [2, 1, 0]
    assert [seen[n].graph is not None for n in (20, 37, 9)] == [
        True, True, False]


# ---------------------------------------------------------------------------
# AdamW's gradient norm and update (csrc/adamw.cu)
# ---------------------------------------------------------------------------

ADAMW_SHAPES = [(300, 64), (64,), (0,), (17,), (5, 7, 9), (16384 + 3,),
                (2 * 16384,)]
ADAMW_HYPER = dict(lr=3e-3, b1=0.9, b2=0.95, b1c=0.1899999976158142,
                   b2c=0.09750002622604370, eps=1e-8, wd=0.1)


def _adamw_state(dev, p_dtype, g_dtype, seed=0, offset=False):
    """Parameters, gradients and warm moments of ADAMW_SHAPES; with
    ``offset`` the gradients are views one element into their storage (the
    kernels' one-at-a-time path)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(s, scale=1.0):
        n = torch.Size(s).numel()
        return torch.randn(n + 1, device=dev, generator=gen) * scale

    ps = [draw(s)[:-1].view(s).to(p_dtype) for s in ADAMW_SHAPES]
    gs = [(draw(s, 3.0).to(g_dtype)[1:] if offset
           else draw(s, 3.0)[:-1].to(g_dtype)).view(s)
          for s in ADAMW_SHAPES]
    ms = [draw(s, 0.1)[:-1].view(s).clone() for s in ADAMW_SHAPES]
    vs = [draw(s, 0.1)[:-1].view(s).square().clone() for s in ADAMW_SHAPES]
    return ps, gs, ms, vs


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_adamw_kernels_match_plain_bit_for_bit_on_card(p_dtype, g_dtype,
                                                        offset,
                                                        cuda_device):
    """The update: p, m and v bit-identical to the plain loop on the card
    (every dtype pairing, decayed and not, ragged and empty tensors,
    misaligned gradients).  The norm's per-tensor sums within 1e-5 of
    torch's and the same bits run to run; its launches counted."""
    ps, gs, ms, vs = _adamw_state(cuda_device, p_dtype, g_dtype,
                                  offset=offset)
    decayed = [i % 3 != 1 for i in range(len(ps))]
    before = ops.COUNTERS["adamw"].value
    sq = ops.grad_sumsq(gs)
    want = ref.grad_sumsq_ref(gs)
    assert torch.equal(ops.grad_sumsq(gs), sq)
    assert ((sq - want).abs() <= 1e-5 * want).all()
    total = ops.sum_in_order(sq)
    assert torch.equal(total, ops.sum_in_order(sq.clone()))
    scale = torch.clamp(1.0 / torch.sqrt(total), max=1.0)
    kp, km, kv = ([t.clone() for t in ts] for ts in (ps, ms, vs))
    ops.adamw_update(kp, gs, km, kv, decayed, scale, **ADAMW_HYPER)
    ref.adamw_update_ref(ps, gs, ms, vs, decayed, scale, **ADAMW_HYPER)
    torch.cuda.synchronize()
    for got, want_ in ((kp, ps), (km, ms), (kv, vs)):
        for a, b in zip(got, want_):
            assert torch.equal(a, b)
    assert ops.COUNTERS["adamw"].value == before + 5   # 2 + 2 + 1 calls


@pytest.mark.cuda
def test_adamw_overflowing_norm_on_card(cuda_device):
    """A sum of squares past float32: the norm inf in both, the scale 0,
    the updated parameters finite and equal."""
    gs = [torch.full((4096,), 1e19, device=cuda_device),
          torch.ones(10, device=cuda_device)]
    sq = ops.grad_sumsq(gs)
    assert torch.isinf(ops.sum_in_order(sq))
    assert torch.isinf(ref.sum_in_order_ref(ref.grad_sumsq_ref(gs)))
    scale = torch.clamp(1.0 / torch.sqrt(ops.sum_in_order(sq)), max=1.0)
    assert float(scale) == 0.0
    ps = [torch.randn(4096, device=cuda_device).bfloat16(),
          torch.randn(10, device=cuda_device).bfloat16()]
    ms = [torch.zeros(4096, device=cuda_device),
          torch.zeros(10, device=cuda_device)]
    kp, km, kv = ([t.clone() for t in ts] for ts in (ps, ms, ms))
    ops.adamw_update(kp, gs, km, kv, [True, True], scale, **ADAMW_HYPER)
    ref.adamw_update_ref(ps, gs, ms, [m.clone() for m in ms], [True, True],
                         scale, **ADAMW_HYPER)
    for a, b in zip(kp, ps):
        assert torch.isfinite(a.float()).all() and torch.equal(a, b)


@pytest.mark.cuda
def test_adamw_optimizer_on_card_equals_plain(cuda_device):
    """optim.AdamW on the card (the kernels) against the plain versions on
    the card, three steps: norms, parameters and moments the same bits."""
    from repro_torch.optim import AdamW, AdamWConfig
    ps, _, _, _ = _adamw_state(cuda_device, torch.bfloat16, torch.bfloat16)
    names = [f"layers.{i}.w" if i % 2 else f"layers.{i}.norm"
             for i in range(len(ps))]
    runs = []
    for plain in (False, True):
        params = {k: p.clone() for k, p in zip(names, ps)}
        opt = AdamW(AdamWConfig(lr=1e-2))
        state = opt.init(params)
        norms = []
        for step in range(3):
            gen = torch.Generator(device=cuda_device).manual_seed(step)
            grads = {k: torch.randn(p.shape, device=cuda_device,
                                    generator=gen).bfloat16()
                     for k, p in params.items()}
            if plain:
                saved = (ops.grad_sumsq, ops.sum_in_order, ops.adamw_update)
                ops.grad_sumsq, ops.sum_in_order, ops.adamw_update = (
                    ref.grad_sumsq_ref, ref.sum_in_order_ref,
                    ref.adamw_update_ref)
            try:
                _, state, n = opt.update(grads, state, params)
            finally:
                if plain:
                    (ops.grad_sumsq, ops.sum_in_order,
                     ops.adamw_update) = saved
            norms.append(n)
        runs.append((params, state, norms))
    (p0, s0, n0), (p1, s1, n1) = runs
    assert torch.allclose(torch.stack(n0), torch.stack(n1), rtol=1e-5)
    # the kernels' norm differs from torch's sum in its last bits, and so
    # then does the clip's scale: hold the state to rounding of that
    for k in p0:
        assert torch.allclose(p0[k].float(), p1[k].float(), rtol=2 ** -7)
        assert torch.allclose(s0.m[k], s1.m[k], rtol=1e-4, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("compress", [False, True])
def test_launcher_steps_take_the_adamw_kernels_on_card(compress, cuda_device,
                                                       capsys):
    """``launch.train`` on the card, plain and with the int8 step over a
    one-process NCCL group: each step's norm and update are the kernels'
    three calls, and no plain version of them runs."""
    from repro_torch.launch import train as tlaunch
    calls = []
    saved = {n: getattr(ref, n) for n in ("grad_sumsq_ref",
                                          "sum_in_order_ref",
                                          "adamw_update_ref")}
    for n in saved:
        setattr(ref, n, lambda *a, _n=n, **k: calls.append(_n))
    try:
        before = ops.COUNTERS["adamw"].value
        assert tlaunch.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                             "--steps", "2"]
                            + (["--compress"] if compress else [])) == 0
    finally:
        for n, fn in saved.items():
            setattr(ref, n, fn)
    assert "[train] done" in capsys.readouterr().out
    assert ops.COUNTERS["adamw"].value == before + 2 * 3
    assert calls == []


# ---------------------------------------------------------------------------
# the microbatch gradient accumulation (csrc/grad_accum.cu)
# ---------------------------------------------------------------------------

ACCUM_SHAPES = [(0,), (1,), (7,), (300, 64), (5, 7, 9), (16384 + 3,),
                (2 * 16384,)]


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("g_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [2, 3, 4])
def test_grad_accum_kernel_matches_plain_bit_for_bit_on_card(M, g_dtype,
                                                             offset,
                                                             cuda_device):
    """M microbatches first / middle / last, the kernel against the plain
    loop on the card: every accumulator the same bits (-0.0 included:
    every fifth element is -0.0 in each microbatch), odd and empty sizes;
    with ``offset`` the accumulators and gradients are contiguous views one
    element into their storage (the kernel's one-at-a-time path).  One
    launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(M)

    def tensor(s, dtype):
        n = torch.Size(s).numel()
        t = torch.randn(n + 1, device=cuda_device, generator=gen).to(dtype)
        t[::5] = -0.0
        return (t[1:] if offset else t[:-1]).view(s)

    accs = [tensor(s, torch.float32) for s in ACCUM_SHAPES]
    plain = [torch.empty(s, device=cuda_device) for s in ACCUM_SHAPES]
    before = ops.COUNTERS["grad_accum"].value
    for i in range(M):
        gs = [tensor(s, g_dtype) for s in ACCUM_SHAPES]
        mode = "first" if i == 0 else "last" if i == M - 1 else "middle"
        ops.grad_accumulate(accs, gs, mode=mode, scale=1.0 / M)
        ref.grad_accumulate_ref(plain, gs, mode=mode, scale=1.0 / M)
    torch.cuda.synchronize()
    for a, b in zip(accs, plain):
        assert torch.equal(_bits(a), _bits(b))
    assert ops.COUNTERS["grad_accum"].value == before + M


@pytest.mark.cuda
@pytest.mark.parametrize("M", [3, 4])
def test_train_step_accumulates_through_the_kernel_on_card(M, cuda_device):
    """``make_train_step`` on the card at M microbatches: M ``grad_accum``
    launches a step and no plain version; the loss and gradient norm the
    same bits as with the plain version patched into ``ops``."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.runtime import (RuntimeConfig, init_state,
                                     make_train_step)
    cfg = get_smoke("granite-moe-3b-a800m")
    tokens = torch.randint(0, cfg.vocab, (M * 2, 33),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    runs = []
    for plain in (False, True):
        model = LM(cfg, device=cuda_device, generator=torch.Generator(
            device=cuda_device).manual_seed(0))
        opt = AdamW(AdamWConfig(lr=1e-3))
        step = make_train_step(cfg, opt, RuntimeConfig(microbatches=M,
                                                       remat=None))
        state = init_state(model, opt)
        calls = []
        saved = (ops.grad_accumulate, ref.grad_accumulate_ref)
        ref.grad_accumulate_ref = (lambda *a, **k: calls.append(1)
                                   or saved[1](*a, **k))
        if plain:
            ops.grad_accumulate = ref.grad_accumulate_ref
        before = ops.COUNTERS["grad_accum"].value
        try:
            for _ in range(2):
                state, m = step(state, batch)
            torch.cuda.synchronize()
        finally:
            ops.grad_accumulate, ref.grad_accumulate_ref = saved
        launched = ops.COUNTERS["grad_accum"].value - before
        assert (launched, len(calls)) == ((0, 2 * M) if plain
                                          else (2 * M, 0))
        runs.append((float(m["loss"]), float(m["grad_norm"])))
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# the decode step's kernels (csrc/rmsnorm.cu, rope_cache.cu,
# decode_attention.cu, ssd_decode.cu) against their plain versions
# ---------------------------------------------------------------------------

def _excess(got, want, atol):
    """The largest |got - want| / (2^-7 |want| + atol): at most 1 where
    they differ by one bf16 step and ``atol``."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (2.0 ** -7 * want.abs() + atol)).max().item()


def _decode_count(name):
    return ops.COUNTERS[name].value


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1280, 2560, 5120, 12288])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True])
def test_decode_rmsnorm_on_card(d, dtype, residual, cuda_device):
    """The norm within one bf16 step (float32: 1e-5) of the plain version;
    with a residual, the sum the same bits as ``x + r``; one launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = (torch.randn((4, 1, d), device=cuda_device, generator=gen) * 3
         ).to(dtype)
    r = torch.randn((4, 1, d), device=cuda_device, generator=gen).to(dtype)
    s = (1 + 0.1 * torch.randn(d, device=cuda_device, generator=gen)
         ).to(dtype)
    before = _decode_count("rmsnorm")
    if residual:
        got_s, got = ops.rmsnorm(x, s, 1e-5, residual=r)
        want_s, want = ref.rmsnorm_ref(x, s, 1e-5, residual=r)
        assert torch.equal(got_s, want_s)
    else:
        got, want = ops.rmsnorm(x, s, 1e-5), ref.rmsnorm_ref(x, s, 1e-5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _excess(got, want, 1e-3) <= 1.0
    assert _decode_count("rmsnorm") == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("pos,window,S", [
    (37, None, 64), (700, None, 64), (-2, None, 64), (70, 32, 32),
    (-1, 32, 32)])
@pytest.mark.parametrize("rope", [True, False])
def test_decode_rope_cache_on_card(hd, pos, window, S, rope, cuda_device):
    """q rotated and the cache row written as the plain version does (one
    bf16 step), every other row untouched, an int and a tensor position
    the same bits; one launch a call."""
    from repro_torch.models.layers import rope_frequencies
    gen = torch.Generator(device=cuda_device).manual_seed(hd + S)
    B, H, KV = 4, 8, 2

    def rand(*s):
        return torch.randn(s, device=cuda_device, generator=gen).to(
            torch.bfloat16)

    q, k, v = rand(B, 1, H, hd), rand(B, 1, KV, hd), rand(B, 1, KV, hd)
    base = rand(B, S, KV, hd), rand(B, S, KV, hd)
    freqs = rope_frequencies(hd, 10_000.0, cuda_device) if rope else None
    runs = []
    before = _decode_count("rope_cache_write")
    for p in (pos, torch.tensor(pos, device=cuda_device)):
        kc, vc = (t.clone() for t in base)
        qo = ops.rope_cache_write(q, k, v, kc, vc, p, freqs=freqs,
                                  window=window)
        runs.append((qo, kc, vc))
    kc, vc = (t.clone() for t in base)
    qw = ref.rope_cache_ref(q, k, v, kc, vc, pos, freqs=freqs, window=window)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    qo, kg, vg = runs[0]
    assert _excess(qo, qw, 1e-3) <= 1.0 and _excess(kg, kc, 1e-3) <= 1.0
    assert torch.equal(vg, vc)
    changed = (kg != base[0]).any(-1).any(-1).any(0)
    assert int(changed.sum()) <= 1
    assert _decode_count("rope_cache_write") == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("G,hd,S,pos,window,cap", [
    (1, 80, 2048, 1600, None, 0.0),       # zamba2's heads
    (3, 64, 2048, 1700, None, 0.0),       # granite's
    (2, 256, 4096, 5000, 4096, 50.0),     # gemma2's rolling local cache
    (2, 256, 5200, 5100, 4096, 50.0),     # a window inside a longer cache
    (6, 128, 2048, 40, None, 0.0),        # nemotron's, early
    (12, 128, 256, 255, None, 0.0),       # command-r's group
    (1, 64, 1500, 1499, None, 0.0),       # whisper's cross-attention
    (1, 64, 448, -1, None, 0.0),          # no valid row: uniform
    (2, 64, 16, 5, None, 0.0),            # one split
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_on_card(G, hd, S, pos, window, cap, dtype,
                                  cuda_device):
    """Within one bf16 step of the plain version (float32: 2e-5 of the
    largest output), an int and a tensor position the same bits, a repeat
    the same bits; one launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(G * hd + S)
    B, KV = 4, 2
    q = torch.randn((B, 1, KV * G, hd), device=cuda_device,
                    generator=gen).to(dtype)
    kc = (torch.randn((B, S, KV, hd), device=cuda_device, generator=gen)
          * 2).to(torch.bfloat16)
    vc = torch.randn((B, S, KV, hd), device=cuda_device,
                     generator=gen).to(torch.bfloat16)
    kw = dict(window=window, logit_cap=cap, scale=1.0 / math.sqrt(hd))
    before = _decode_count("decode_attention")
    got = ops.decode_attention(q, kc, vc, pos=pos, **kw)
    again = ops.decode_attention(q, kc, vc,
                                 pos=torch.tensor(pos, device=cuda_device),
                                 **kw)
    want = ref.decode_attention_ref(q, kc, vc, pos=pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 2e-5 * want.abs().max()
    else:
        assert _excess(got, want, 1e-3) <= 1.0
    assert _decode_count("decode_attention") == before + 2


def _conv1_in_order(val, w, buf):
    """``ref._conv1`` with the taps summed k = 0..K-1 one rounded float32
    op at a time, the SSD kernel's order (the plain version's einsum leaves
    the order to the matmul library): check-only, so that the state can be
    held to 1e-5."""
    window = torch.cat([buf.to(val.dtype), val], dim=1)
    wf = w.float()
    y = window[:, 0].float() * wf[0]
    for k in range(1, w.shape[0]):
        y = y + window[:, k].float() * wf[k]
    return F.silu(y.to(val.dtype)[:, None]), window[:, 1:]


@pytest.mark.cuda
@pytest.mark.parametrize("nh,hd,ds", [(80, 64, 64), (64, 64, 128),
                                      (5, 16, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_decode_step_on_card(nh, hd, ds, dtype, cuda_device,
                                 monkeypatch):
    """One Mamba2 token for 4 slots against the plain version with the
    conv taps summed in the kernel's order: the conv buffers the same bits,
    the float32 state within 1e-5 of its largest element, y within one
    bf16 step (float32: 1e-5); one launch, twice in a row."""
    monkeypatch.setattr(ref, "_conv1", _conv1_in_order)
    gen = torch.Generator(device=cuda_device).manual_seed(nh * ds)
    B, K, di = 4, 4, nh * hd

    def rand(*s, scale=1.0, dt=dtype):
        return (torch.randn(s, device=cuda_device, generator=gen) * scale
                ).to(dt)

    p = dict(dt_bias=rand(nh, scale=0.5), A_log=rand(nh, scale=0.5),
             D=rand(nh), conv_x=rand(K, di, scale=0.5),
             conv_B=rand(K, ds, scale=0.5), conv_C=rand(K, ds, scale=0.5))
    h0 = rand(B, nh, ds, hd, dt=torch.float32)
    conv0 = {"x": rand(B, K - 1, di, dt=torch.bfloat16),
             "B": rand(B, K - 1, ds, dt=torch.bfloat16),
             "C": rand(B, K - 1, ds, dt=torch.bfloat16)}
    h, hw = h0.clone(), h0.clone()
    conv = {k: t.clone() for k, t in conv0.items()}
    convw = {k: t.clone() for k, t in conv0.items()}
    before = _decode_count("ssd_decode_step")
    for step in range(2):
        z, x = rand(B, 1, di), rand(B, 1, di)
        Bv, Cv, dt = rand(B, 1, ds), rand(B, 1, ds), rand(B, 1, nh)
        y = ops.ssd_decode_step(z, x, Bv, Cv, dt, p, h=h, conv=conv)
        yw = ref.ssd_decode_step_ref(z, x, Bv, Cv, dt, p, h=hw, conv=convw)
        torch.cuda.synchronize()
        for key in conv:
            assert torch.equal(conv[key], convw[key]), (step, key)
        assert (h - hw).abs().max() <= 1e-5 * hw.abs().max(), step
        if dtype == torch.float32:
            torch.testing.assert_close(y, yw, rtol=1e-5, atol=1e-5)
        else:
            assert _excess(y, yw, 1e-3) <= 1.0
        hw.copy_(h)                 # each step from the same state
    assert _decode_count("ssd_decode_step") == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-moe-3b-a800m",
                                  "gemma2-2b", "whisper-large-v3"])
def test_decode_step_takes_the_decode_kernels_on_card(arch, cuda_device):
    """A bf16 decode step of a smoke model: the four kernels' launches by
    formula, and the logits (the padded vocab tail left out: it is -2^30 on
    every run) within 2e-2 relative L2 of the same step with the plain
    versions on the card."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import decode_step as dec
    from repro_torch.models import LM, decode_step, init_cache, prefill
    cfg = get_smoke(arch)
    model = LM(cfg, device=cuda_device,
               generator=torch.Generator(device=cuda_device).manual_seed(0))
    B, S = 2, 40
    tokens = torch.randint(0, cfg.vocab, (B, 12), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(1))
    extras = {}
    if cfg.enc_dec:
        extras["frames"] = torch.randn(
            (B, cfg.enc_frames, cfg.d_model), device=cuda_device,
            generator=torch.Generator(device=cuda_device).manual_seed(2)
        ).to(torch.bfloat16)
    logits, cache = prefill(model, tokens, capacity=S, **extras)
    plain_cache = {k: v.clone() for k, v in cache.items()}
    tok = torch.argmax(logits, -1)
    names = ("rmsnorm", "rope_cache_write", "decode_attention",
             "ssd_decode_step")
    before = {n: _decode_count(n) for n in names}
    got, _ = decode_step(model, cache, tok, 12)
    L = cfg.n_layers
    n_attn = sum(cfg.is_attention_layer(i) for i in range(L))
    cross = L if cfg.enc_dec else 0
    want = {"rmsnorm": 2 * L + 1 + cross, "rope_cache_write": n_attn,
            "decode_attention": n_attn + cross,
            "ssd_decode_step": L - n_attn}
    assert {n: _decode_count(n) - before[n] for n in names} == want
    saved = {n: getattr(dec, n) for n in names}
    plain = {"rmsnorm": ref.rmsnorm_ref, "rope_cache_write": ref.rope_cache_ref,
             "decode_attention": ref.decode_attention_ref,
             "ssd_decode_step": ref.ssd_decode_step_ref}
    try:
        for n in names:
            setattr(dec, n, plain[n])
        wanted, _ = decode_step(model, plain_cache, tok, 12)
    finally:
        for n, fn in saved.items():
            setattr(dec, n, fn)
    torch.cuda.synchronize()
    got, wanted = (t[:, :cfg.vocab].float() for t in (got, wanted))
    rel = ((got - wanted).norm() / wanted.norm()).item()
    assert rel <= 2e-2, rel
