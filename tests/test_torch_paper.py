"""The paper's experiments in the port (``repro_torch.bench``), on the CPU.

- ``--testbed sim`` against the JAX package's ``benchmarks``: each of the
  six modules' ``main(full=False)`` CSV lines equal the reference's,
  character for character (``fission_real``, wall clock, aside);
  ``tune_cell``'s whole dict at all 30 cells (5 SCTs x 3 classes x 1-2
  GPUs, ``hybrid --full``); Algorithm 1's trace entry by entry (fission,
  overlap, work-group sizes, share, time) for the five SCTs at their
  middle class and for ``profile_construction``'s FFT-256;
- the reference's own simulator tests (``tests/test_simulator_benchmarks.py``)
  on the port's ``sim``;
- ``--testbed host --device cpu --smoke``: ``hybrid`` (all five SCTs),
  ``profile_construction``, ``maxdev``, ``kb_derivation`` and
  ``load_fluctuation`` each finish, check their outputs against the
  plain versions and write their JSON; the load's child processes are
  gone afterwards; without ``--device cpu`` and without a card the
  harness raises;
- the host evaluator runs a level's host slots at ``cores // slots``
  threads and restores the count after;
- ``repro_torch.bench`` imports nothing of ``repro``, ``jax`` or
  ``benchmarks``.
"""
import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from benchmarks import fission as r_fission
from benchmarks import hybrid as r_hybrid
from benchmarks import kb_derivation as r_kb
from benchmarks import load_fluctuation as r_load
from benchmarks import maxdev as r_maxdev
from benchmarks import paper_suite as r_suite
from benchmarks import profile_construction as r_pc
from repro.core import TunerParams as RTunerParams
from repro.core import build_profile as r_build_profile
from repro.core.knowledge_base import Profile as RProfile
from repro_torch.bench import (fission, hybrid, kb_derivation,
                               load_fluctuation, maxdev, paper_suite,
                               profile_construction, run)
from repro_torch.core import (PlatformConfig, Workload, build_profile, kernel,
                              Map, vector)
from repro_torch.core.simulator import LOCALITY_FACTOR

ROOT = Path(__file__).resolve().parent.parent

MODULES = {"fission": (r_fission, fission),
           "profile_construction": (r_pc, profile_construction),
           "hybrid": (r_hybrid, hybrid), "maxdev": (r_maxdev, maxdev),
           "kb_derivation": (r_kb, kb_derivation),
           "load_fluctuation": (r_load, load_fluctuation)}
CELLS = [(name, size, gpus) for name, sizes in r_hybrid.CLASSES.items()
         for size in sizes for gpus in (1, 2)]


# ---------------------------------------------------------------------------
# sim: the reference's protocol, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", list(MODULES))
def test_sim_lines_equal_reference(module):
    ref_mod, port_mod = MODULES[module]
    want = [ln for ln in ref_mod.main(full=False)
            if not ln.startswith("fission_real")]
    got = [ln for ln in port_mod.main(full=False, testbed="sim")
           if not ln.startswith("fission_real")]
    assert got == want and got


@pytest.mark.parametrize("name,size,gpus", CELLS,
                         ids=[f"{n}-{s}-{g}gpu" for n, s, g in CELLS])
def test_sim_hybrid_cell_equals_reference(name, size, gpus):
    assert hybrid.tune_cell(name, size, gpus) == \
        r_hybrid.tune_cell(name, size, gpus)


def _reference_trace(name, size, params):
    sct = r_suite.BENCHMARKS[name][0](size)
    workload = r_suite.workload_for(name, size)
    sched, sim = r_hybrid.make_scheduler(name, size, 1)
    arrays = sim.synthesise_arrays(sct, workload)

    def evaluate(cfg, dist):
        prof = RProfile(sct_id=sct.unique_id(), workload=workload,
                        share_a=dist.a, config=cfg, best_time=math.inf)
        _, stats, _, _, _ = sched._dispatch(sct, arrays, prof)
        return stats.total, stats.time_a, stats.time_b

    res = r_build_profile(sct.unique_id(), workload, host=sched.host,
                          accel=sched.accel, evaluate=evaluate,
                          params=params)
    return [vars(t) for t in res.trace]


@pytest.mark.parametrize("name", list(r_hybrid.CLASSES))
def test_sim_search_trace_equals_reference(name):
    """Algorithm 1's every timed configuration, in order, at the middle
    class (the cell ``hybrid`` runs by default)."""
    size = r_hybrid.CLASSES[name][1]
    sct = paper_suite.BENCHMARKS[name][0](size)
    workload = paper_suite.workload_for(name, size)
    sched, sim = hybrid.make_scheduler(name, size, 1)
    arrays = sim.synthesise_arrays(sct, workload)
    res = build_profile(sct.unique_id(), workload, host=sched.host,
                        accel=sched.accel,
                        evaluate=hybrid.evaluator(sched, sct, workload,
                                                  arrays),
                        params=hybrid.PARAMS)
    want = _reference_trace(name, size, RTunerParams(number_executions=1,
                                                     precision=1e-4))
    assert hybrid.trace_rows(res) == want and len(want) > 10


def test_sim_profile_construction_trace_equals_reference():
    cell = profile_construction.collect(testbed="sim")["cell"]
    want = _reference_trace("fft", 256, RTunerParams(number_executions=1))
    assert cell["trace"] == want
    assert cell["evals"] == len(want) == 24


# ---------------------------------------------------------------------------
# the reference's simulator tests, on the port's sim
# ---------------------------------------------------------------------------

def test_sim_deterministic():
    a = fission.simulate_fission("saxpy", 10 ** 6)
    b = fission.simulate_fission("saxpy", 10 ** 6)
    assert a["times"] == b["times"]


def test_sim_fission_beats_no_fission():
    r = fission.simulate_fission("fft", 256)
    assert r["best_level"] != "NO_FISSION"
    assert r["speedup_vs_nofission"] > 1.3


def test_sim_locality_calibration_order():
    assert LOCALITY_FACTOR["L2"] > LOCALITY_FACTOR["L3"] \
        > LOCALITY_FACTOR["NO_FISSION"]


def test_sim_hybrid_beats_gpu_only_for_comm_bound():
    r = hybrid.tune_cell("saxpy", 10 ** 7, n_gpus=1)
    assert r["speedup"] > 1.2
    assert 0.0 < r["gpu_share"] < 1.0


def test_sim_nbody_stays_gpu_only():
    assert hybrid.tune_cell("nbody", 32768, n_gpus=1)["gpu_share"] > 0.9


def test_sim_cpu_share_shrinks_with_more_gpus():
    r1 = hybrid.tune_cell("segmentation", 512, n_gpus=1)
    r2 = hybrid.tune_cell("segmentation", 512, n_gpus=2)
    assert (1 - r2["gpu_share"]) <= (1 - r1["gpu_share"]) + 0.05


# ---------------------------------------------------------------------------
# host: the same protocol on live slots (accelerator slots on the CPU)
# ---------------------------------------------------------------------------

def _host_run(module, tmp_path):
    out = tmp_path / f"{module}.json"
    assert run.main(["--only", module, "--device", "cpu", "--smoke",
                     "--out", str(out)]) == 0
    record = json.loads(out.read_text())
    assert record["testbed"] == "host" and record["card"] is None
    assert record["host"]["cores"] == (os.cpu_count() or 1)
    return record["modules"][module]


def test_host_hybrid_smoke(tmp_path):
    res = _host_run("hybrid", tmp_path)
    cells = {c["benchmark"]: c for c in res["cells"]}
    assert sorted(cells) == sorted(hybrid.CLASSES)
    for name, c in cells.items():
        assert c["size"] == hybrid.SMOKE[name] and c["device"] == "cpu"
        assert c["evals"] == len(c["trace"]) > 0
        assert 0.0 <= c["gpu_share"] <= 1.0
        assert {c["fission"], "NO_FISSION"} <= set(c["threads"])
        assert c["speedup_turns"] > 0 and c["speedup"] > 0
        assert len(c["hybrid_walls"]) == len(c["gpu_only_walls"]) \
            == hybrid.TURNS
        assert set(c["max_abs_err"]) == {"hybrid", "gpu_only"}
        assert c["gpu_segments"] > 0
    assert len(res["lines"]) == len(cells) + 1


@pytest.mark.parametrize("module", ["profile_construction", "maxdev",
                                    "kb_derivation"])
def test_host_module_smoke(module, tmp_path):
    res = _host_run(module, tmp_path)
    assert res["lines"] and all(ln.startswith(module) for ln in res["lines"])
    if module == "profile_construction":
        c = res["cell"]
        assert c["evals"] == len(c["trace"]) > 0 and c["gpu_segments"] > 0
    elif module == "maxdev":
        assert [(c["benchmark"], c["runs"]) for c in res["cells"]] == \
            [(n, maxdev.SMOKE_RUNS) for n, _ in maxdev.CASES]
        assert all(0.0 <= c["min_deviation"] <= 1.0 for c in res["cells"])
    else:
        assert len(res["cells"]) == 4 and len(res["baselines"]) == 5


def test_host_load_fluctuation_smoke(tmp_path):
    c = _host_run("load_fluctuation", tmp_path)["cell"]
    at, off = load_fluctuation.SMOKE_LOAD
    assert len(c["share_trace"]) == len(c["walls"]) \
        == load_fluctuation.SMOKE_RUNS
    assert [x > 0 for x in c["cpu_load"]] == \
        [at <= r < off for r in range(load_fluctuation.SMOKE_RUNS)]
    assert len(c["load_pids"]) == (os.cpu_count() or 1)
    for pid in c["load_pids"]:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_busy_processes_stop_on_failure():
    with pytest.raises(RuntimeError):
        with load_fluctuation.busy_processes(2) as procs:
            raise RuntimeError("a failed run")
    assert all(p.returncode is not None for p in procs)


def test_host_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--only", "hybrid", "--out", str(tmp_path / "x.json")])


def test_evaluator_sets_and_restores_threads():
    seen = []

    def body(x):
        seen.append((threading.current_thread().name,
                     torch.get_num_threads()))
        return x * 2.0

    sct = Map(kernel(body, name="double", inputs=[vector("x", epu=1)],
                     outputs=[vector("y", epu=1)]))
    sched = hybrid.host_scheduler("cpu")
    before = torch.get_num_threads()
    try:
        x = torch.arange(64, dtype=torch.float32)
        ev = hybrid.HostEvaluator(sched, sct, Workload((64,)), {"x": x})
        cores = sched.host.device.compute_units
        for level in ("L2", "NO_FISSION"):
            seen.clear()
            outputs, stats, _, _ = ev.dispatch(
                PlatformConfig(fission_level=level, overlap=1), 0.5)
            torch.testing.assert_close(outputs["y"], x * 2.0)
            host = [n for name, n in seen if "cpu0" in name]
            want = max(1, cores // sched.host.topology[level])
            assert host and set(host) == {want}
            assert ev.threads[level] == want
            assert torch.get_num_threads() == before
            queues = sched.executor._acquire_queues(
                [f"cpu0/f{i}" for i in range(sched.host.topology["L1"])])
            assert {q.submit(torch.get_num_threads).result()
                    for q in queues.values()} == {before}
    finally:
        sched.close()
        torch.set_num_threads(before)


def test_bench_imports_nothing_of_the_reference():
    code = ("import sys, json\n"
            "import repro_torch.bench.run, repro_torch.bench.fission, "
            "repro_torch.bench.hybrid, repro_torch.bench.maxdev, "
            "repro_torch.bench.kb_derivation, "
            "repro_torch.bench.load_fluctuation, "
            "repro_torch.bench.profile_construction, "
            "repro_torch.bench.paper_suite\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.') or m == 'benchmarks' "
            "or m.startswith('benchmarks.'))))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
