"""The port's runtime layer against the JAX package's, on the CPU: state
carried across (knowledge-base JSON), scheduler decisions, Algorithm 1,
the GPU occupancy model, the eager Loop, the no-fallback rule, and the
import boundary."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core import occupancy, platforms
from repro_torch.core.executor import from_numpy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# knowledge base: the JSON files are interchangeable
# ---------------------------------------------------------------------------

def _profiles(P):
    cfg = P.PlatformConfig(fission_level="L2", overlap=3,
                           wgs={"saxpy": 256})
    return [P.Profile(sct_id="map(kernel[saxpy])",
                      workload=P.Workload(dims), share_a=share,
                      config=cfg, best_time=t, origin=P.Origin.BUILT)
            for dims, share, t in [((10 ** 6,), 0.7, 0.5),
                                   ((10 ** 7,), 0.8, 2.0),
                                   ((5 * 10 ** 7,), 0.85, 9.0)]]


@pytest.mark.parametrize("writer,reader", [(R, T), (T, R)],
                         ids=["reference->port", "port->reference"])
def test_kb_json_round_trip(tmp_path, writer, reader):
    path = str(tmp_path / "kb.json")
    kb = writer.KnowledgeBase(path)
    for p in _profiles(writer):
        kb.store(p)
    back = reader.KnowledgeBase(path)
    assert len(back) == 3
    for w in [(10 ** 7,), (3 * 10 ** 6,), (2 * 10 ** 7,)]:
        a = kb.derive("map(kernel[saxpy])", writer.Workload(w))
        b = back.derive("map(kernel[saxpy])", reader.Workload(w))
        assert a.to_json() == b.to_json()
    exact = back.exact("map(kernel[saxpy])", reader.Workload((10 ** 7,)))
    assert exact.share_a == 0.8 and exact.config.overlap == 3
    # and the file the reader re-saves is the one the writer wrote
    back.save(str(tmp_path / "again.json"))
    assert json.loads(Path(path).read_text()) == \
        json.loads((tmp_path / "again.json").read_text())


# ---------------------------------------------------------------------------
# scheduler decisions under the simulator
# ---------------------------------------------------------------------------

def _sim_scheduler(P, seed):
    devs = [P.SimDevice("gpu0", "gpu", flops=2870e9, mem_bw=240e9,
                        pcie_bw=8e9, cores=28),
            P.SimDevice("cpu0", "cpu", flops=150e9, mem_bw=43e9,
                        pcie_bw=math.inf, cores=6)]
    return P.Scheduler(
        host=P.HostPlatform(P.DeviceInfo("cpu0", "cpu", compute_units=6),
                            topology={"L2": 3, "NO_FISSION": 1}),
        accel=P.AcceleratorPlatform([P.DeviceInfo("gpu0", "gpu")],
                                    max_overlap=2),
        executor=P.SimulatedExecutor(devs, seed=seed),
        kb=P.KnowledgeBase(), default_share_a=0.3)


def _saxpy(P):
    return P.Map(P.kernel(lambda a, x, y: a * x + y, name="saxpy",
                          inputs=[P.scalar("a"), P.vector("x"),
                                  P.vector("y")],
                          outputs=[P.vector("z")],
                          flops_per_item=2.0, bytes_per_item=12.0))


@pytest.mark.parametrize("seed", [0, 3])
def test_scheduler_decisions_match_the_reference(seed):
    x = np.zeros(10 ** 6, np.float32)
    trails = []
    for P in (R, T):
        s = _sim_scheduler(P, seed)
        sct = _saxpy(P)
        trail = []
        for _ in range(12):
            run = s.run(sct, {"a": 2.0, "x": x, "y": x})
            trail.append((run.action, run.profile.share_a,
                          tuple(sl.device for sl in s._last_slots),
                          tuple(run.stats.times)))
        trails.append(trail)
    assert trails[0] == trails[1]
    actions = [t[0] for t in trails[0]]
    assert actions[0] == "derived" and "adjusted" in actions


def test_algorithm1_matches_the_reference_but_for_block_sizes():
    """Algorithm 1's search is the same in both packages; only the
    work-group candidates differ: the reference scores TPU blocks
    (multiples of the 128-wide MXU), the port CUDA thread blocks
    (warp multiples up to 1024), so the ``wgs`` it picks differ."""
    results = []
    for P in (R, T):
        host = P.HostPlatform(P.DeviceInfo("cpu0", "cpu", compute_units=8),
                              topology={"L1": 8, "L2": 4, "NO_FISSION": 1})
        accel = P.AcceleratorPlatform([P.DeviceInfo("gpu0", "gpu")],
                                      max_overlap=3)

        def evaluate(cfg, dist):
            lv = {"L1": 1.3, "L2": 1.0, "NO_FISSION": 1.6}[cfg.fission_level]
            ta = dist.a * 4.0 / cfg.overlap ** 0.5
            tb = (1 - dist.a) * 10.0 * lv
            return max(ta, tb), ta, tb

        res = P.build_profile("map(kernel[saxpy])", P.Workload((1 << 20,)),
                              host=host, accel=accel, evaluate=evaluate,
                              sct=_saxpy(P))
        results.append(res)
    a, b = results
    assert [(e.fission_level, e.overlap, e.distribution, e.time)
            for e in a.trace] == \
        [(e.fission_level, e.overlap, e.distribution, e.time)
         for e in b.trace]
    assert a.profile.share_a == b.profile.share_a
    assert a.profile.config.fission_level == b.profile.config.fission_level
    assert b.profile.config.wgs["saxpy"] % 32 == 0
    assert a.profile.config.wgs["saxpy"] % 128 == 0


# ---------------------------------------------------------------------------
# GPU occupancy model and platforms
# ---------------------------------------------------------------------------

def test_occupancy_candidates_are_cuda_blocks():
    spec = T.KernelSpec("k", (), (), flops_per_item=2.0, bytes_per_item=12.0)
    cands = occupancy.candidates(spec, 1 << 20, cores=132,
                                 limits=occupancy.HOPPER_H100_SXM)
    assert cands and all(c.wgs % 32 == 0 and c.wgs <= 1024 for c in cands)
    occ = [c.occupancy for c in cands]
    assert occ == sorted(occ, reverse=True) and occ[0] == 1.0
    assert all(c.occupancy >= 0.8 for c in cands)


def test_occupancy_limits_by_shared_memory_and_registers():
    lim = occupancy.HOPPER_H100_SXM
    smem = T.KernelSpec("k", (), (), local_mem_per_item=1024.0)
    # 256 threads x 1 KiB = 256 KiB > the 227 KiB a block may opt into
    assert occupancy.occupancy(smem, 256, limits=lim).occupancy == 0.0
    # 64 threads x 1 KiB = 64 KiB: three blocks fit the SM's 228 KiB
    s = occupancy.occupancy(smem, 64, limits=lim)
    assert s.blocks_per_sm == 3 and s.occupancy == 3 * 2 / 64
    plain = T.KernelSpec("k", (), ())
    heavy = occupancy.occupancy(plain, 1024, limits=lim, regs_per_thread=128)
    assert heavy.blocks_per_sm == 0           # 1024 x 128 > 65536 registers
    assert occupancy.occupancy(plain, 1024, limits=lim).occupancy == 1.0


def test_platforms_carry_no_device_rates():
    d = T.DeviceInfo("gpu0", "gpu")
    assert d.peak_flops is None and d.hbm_bw is None
    accel = T.AcceleratorPlatform([T.DeviceInfo("gpu0", "gpu"),
                                   T.DeviceInfo("gpu1", "gpu")])
    assert accel.calibrate() == [0.5, 0.5]
    host = T.HostPlatform(T.DeviceInfo("cpu0", "cpu"))
    assert host.topology["L1"] == (os.cpu_count() or 1)
    assert platforms.cuda_index("gpu3") == 3


# ---------------------------------------------------------------------------
# Loop: an eager loop with a host-side condition and a shape probe
# ---------------------------------------------------------------------------

def _inc_loop(state):
    body = T.kernel(lambda x: (x + 1.0, x * 2.0), name="inc",
                    inputs=[T.vector("x")],
                    outputs=[T.vector("x"), T.vector("twice")])
    return T.Loop(body, state)


def test_while_loop_stops_on_a_host_condition():
    loop = _inc_loop(T.LoopState(cond=lambda e: e["x"].sum() < 10,
                                 max_iterations=100))
    out = loop.apply({"x": torch.zeros(2)})
    assert out["x"].tolist() == [5.0, 5.0]
    assert out["twice"].tolist() == [8.0, 8.0]


def test_zero_iteration_loop_still_produces_body_outputs():
    loop = _inc_loop(T.LoopState(cond=lambda e: False, max_iterations=4))
    out = loop.apply({"x": torch.ones(3, dtype=torch.float64)})
    assert out["twice"].dtype == torch.float64
    assert out["twice"].tolist() == [0.0, 0.0, 0.0]


def test_loop_body_is_not_probed_when_its_outputs_are_present():
    calls = []

    def body_fn(x):
        calls.append(x.device.type)
        return x + 1.0

    body = T.kernel(body_fn, name="inc", inputs=[T.vector("x")],
                    outputs=[T.vector("x")])
    T.Loop(body, T.LoopState(max_iterations=2)).apply({"x": torch.zeros(2)})
    assert calls == ["cpu", "cpu"]          # no meta probe


def test_for_loop_runs_its_trip_count():
    out = _inc_loop(T.LoopState(max_iterations=3)).apply(
        {"x": torch.zeros(1)})
    assert out["x"].item() == 3.0


# ---------------------------------------------------------------------------
# no fallback: CUDA paths raise without a card
# ---------------------------------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_executor_without_card_raises(no_cuda, device):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.ThreadedExecutor(device=device)


def test_calibration_workload_without_card_raises(no_cuda):
    accel = T.AcceleratorPlatform([T.DeviceInfo("gpu0", "gpu")])
    with pytest.raises(RuntimeError, match="CUDA"):
        accel.calibrate(lambda d: None)


def test_explicit_cpu_runs_accelerator_slots_on_the_host(no_cuda):
    ex = T.ThreadedExecutor(device="cpu")
    assert ex.device.type == "cpu" and not ex._on_card("gpu")


def test_from_numpy_shares_memory():
    a = np.arange(6, dtype=np.float32)
    env = from_numpy({"a": a, "s": 2.0})
    env["a"][0] = 42.0
    assert a[0] == 42.0 and env["s"] == 2.0


# ---------------------------------------------------------------------------
# the import boundary
# ---------------------------------------------------------------------------

def _modules_after(code):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
         "or m.startswith('jax.') or m == 'repro' "
         "or m.startswith('repro.'))))"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("code", [
    "import repro_torch, repro_torch.core, repro_torch.kernels.ops, "
    "repro_torch.suite",
    "import importlib.util\n"
    "spec = importlib.util.spec_from_file_location('chip_smoke', "
    "'chip_smoke.py')\n"
    "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
], ids=["package", "chip_smoke"])
def test_port_imports_neither_jax_nor_the_reference(code):
    assert _modules_after(code) == []
