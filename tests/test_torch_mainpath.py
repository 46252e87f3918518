"""The paper's main path in the port against the JAX package, on the CPU.

Each scenario follows one test (or several small ones of one class) of the
JAX package's own main-path suites
(``test_locality.py``, ``test_graph_plan_cache.py``, ``test_fusion.py``,
``test_admission.py``, ``test_telemetry.py``, ``test_faults.py``).  It
runs once per package on the same seeded numpy inputs (the port's
accelerator slots on host threads: ``ThreadedExecutor(device="cpu")``),
asserts that test's properties on each, and returns what it observed:
counters (``ExecutionStats`` fields, plan-cache and graph-cache hits,
misses and invalidations, decide/plan lock counts, fused actions,
retries, the metric names and the values that do not depend on a clock)
and outputs.  The port's observations must equal the reference's, and
its outputs be bit-identical (every body here is elementwise float32).

Among them, the seven properties of the main path: zero merge bytes on
resident chains, a plan-cache hit rate of at least 0.8 over a recurrent
run, graph-cache hits planned with zero decide and plan locks, fused
slices bit-identical to separate runs, FIFO admission, a valid Chrome
trace, and the same ``ExecutionStats`` counters as the reference.
"""
import itertools
import json
import logging
import math
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import load_balancer as R_lb
from repro.core import telemetry as R_tel
from repro_torch.core import load_balancer as T_lb
from repro_torch.core import telemetry as T_tel

torch.set_num_threads(1)

PKGS = {"reference": R, "port": T}
SUB = {R: {"lb": R_lb, "tel": R_tel}, T: {"lb": T_lb, "tel": T_tel}}


# ---------------------------------------------------------------------------
# building blocks, for either package
# ---------------------------------------------------------------------------

def policy(P, **kw):
    kw.setdefault("watchdog_multiple", 1e6)   # no spurious watchdog
    return P.FaultPolicy(**kw)


def executor(P, **kw):
    """A ``ThreadedExecutor`` of ``P``; the port's runs its accelerator
    slots on host threads."""
    kw.setdefault("policy", policy(P))
    if P is T:
        kw["device"] = "cpu"
    return P.ThreadedExecutor(**kw)


def saxpy_tree(P):
    return P.kernel(lambda a, x, y: a * x + y, name="saxpy",
                    inputs=[P.scalar("a"), P.vector("x"), P.vector("y")],
                    outputs=[P.vector("z")])


def chain_trees(P, steps=3):
    k2 = P.kernel(lambda a, z: z * a, name="scale",
                  inputs=[P.scalar("a"), P.vector("z")],
                  outputs=[P.vector("w")])
    k3 = P.kernel(lambda w, y: w + y, name="addy",
                  inputs=[P.vector("w"), P.vector("y")],
                  outputs=[P.vector("v")])
    return [saxpy_tree(P), k2, k3][:steps]


def saxpy_arrays(n=256, a=2.0):
    return {"a": np.float32(a),
            "x": np.arange(n, dtype=np.float32),
            "y": np.ones(n, dtype=np.float32)}


def make_scheduler(P, ex, **kw):
    host = P.HostPlatform(P.DeviceInfo("cpu0", "cpu", compute_units=4),
                          topology={"L2": 2, "NO_FISSION": 1})
    accel = P.AcceleratorPlatform([P.DeviceInfo("gpu0", "gpu")],
                                  max_overlap=2)
    kw.setdefault("balancer", P.LoadBalancer(max_dev=0.0))
    kw.setdefault("kb", P.KnowledgeBase())
    return P.Scheduler(host=host, accel=accel, executor=ex, **kw)


def three_slot_part(P, sct, n=256, shares=(0.5, 0.25, 0.25)):
    plan = P.build_plan(sct, {"x": (n,), "y": (n,)})
    slots = [P.ExecutionSlot("gpu0/q0", "gpu"),
             P.ExecutionSlot("cpu0/f0", "cpu"),
             P.ExecutionSlot("cpu0/f1", "cpu")]
    return plan.partition(slots, list(shares))


def make_profile(P, sct, n=256, share=0.5):
    return P.Profile(sct_id=sct.unique_id(), workload=P.Workload((n,)),
                     share_a=share, config=P.PlatformConfig(),
                     best_time=math.inf)


def sim_devices(P):
    return [P.SimDevice("gpu0", "gpu", flops=1e12),
            P.SimDevice("cpu0", "cpu", flops=1e11, cores=4)]


def make_sim(P, **kw):
    kw.setdefault("cost", P.CostModel(flops_per_unit=1e6,
                                      bytes_per_unit=0.0))
    kw.setdefault("compute_outputs", True)
    return P.SimulatedExecutor(sim_devices(P), noise=0.0, **kw)


def single_node_graph(P, sct=None):
    g = P.JobGraph()
    g.add(sct if sct is not None else saxpy_tree(P), name="s")
    return g


def chain_graph(P):
    g = P.JobGraph()
    prev = None
    for i, sct in enumerate(chain_trees(P)):
        prev = g.add(sct, name=f"n{i}",
                     after=(prev,) if prev is not None else ())
    return g


def arr(value) -> np.ndarray:
    """A host numpy copy of an output of either package."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    return np.array(value, copy=True)


def stats_obs(stats) -> dict:
    """The clock-free fields of an ``ExecutionStats``."""
    return {"share_a": stats.share_a, "retries": stats.retries,
            "merge_bytes": stats.merge_bytes,
            "plan_cache_hit": stats.plan_cache_hit,
            "resident": stats.resident, "ok": stats.ok,
            "slots": len(stats.times),
            "failures": [(f.device, f.kind, f.attempt)
                         for f in stats.failures]}


def run_obs(run) -> dict:
    return {"action": run.action, "stats": stats_obs(run.stats),
            "outputs": {k: arr(v) for k, v in sorted(run.outputs.items())}}


def counters_obs(sched) -> dict:
    """Scheduler counters that do not depend on a clock."""
    return {k: v for k, v in sched.counters().items()
            if not k.startswith("balancer.")}


def metrics_obs(snapshot) -> dict:
    """Metric names and the values that do not depend on a clock
    (histograms by count; busy seconds and the balancer's lbt by name)."""
    out = {}
    for k, v in snapshot.items():
        if k.startswith("device_busy_seconds_total") \
                or k.startswith("balancer_lbt"):
            out[k] = "clock"
        elif isinstance(v, dict):
            out[k] = {"count": v["count"]}
        else:
            out[k] = v
    return out


def assert_same(ref, port, path="obs"):
    if isinstance(ref, np.ndarray):
        assert isinstance(port, np.ndarray), path
        assert ref.dtype == port.dtype and ref.shape == port.shape, path
        assert np.array_equal(ref, port), f"{path}: outputs differ"
    elif isinstance(ref, dict):
        assert isinstance(port, dict) and sorted(ref) == sorted(port), \
            (path, sorted(ref), sorted(port))
        for k in ref:
            assert_same(ref[k], port[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(ref) == len(port), \
            (path, ref, port)
        for i, (a, b) in enumerate(zip(ref, port)):
            assert_same(a, b, f"{path}[{i}]")
    else:
        assert ref == port, (path, ref, port)


SCENARIOS = {}


def scenario(group):
    def register(fn):
        SCENARIOS.setdefault(group, {})[fn.__name__] = fn
        return fn
    return register


def parity(group, name, tmp_path):
    fn = SCENARIOS[group][name]
    ref = fn(R, tmp_path / "reference")
    port = fn(T, tmp_path / "port")
    assert_same(ref, port)


def names(group):
    return sorted(SCENARIOS[group])


# ---------------------------------------------------------------------------
# test_locality.py: plan cache, pools, in-place merge, residency
# ---------------------------------------------------------------------------

@scenario("plan_cache")
def recurrent_run_hits_cache(P, tmp):
    sched = make_scheduler(P, executor(P))
    sct, arrays = saxpy_tree(P), saxpy_arrays()
    runs = [run_obs(sched.run(sct, dict(arrays))) for _ in range(3)]
    assert [r["stats"]["plan_cache_hit"] for r in runs] == \
        [False, True, True]
    assert sched.plan_cache.hits == 2 and sched.plan_cache.misses == 1
    out = {"runs": runs, "counters": counters_obs(sched)}
    sched.close()
    return out


@scenario("plan_cache")
def recurrent_hit_rate_at_least_0_8(P, tmp):
    """The locality gate's recurrent phase at a small size: two warm-ups
    and five timed runs of one SCT."""
    sched = make_scheduler(P, executor(P))
    sct, arrays = saxpy_tree(P), saxpy_arrays(1024)
    for _ in range(7):
        sched.run(sct, dict(arrays))
    assert sched.plan_cache.hit_rate >= 0.8
    out = sched.plan_cache.counters()
    sched.close()
    return out


@scenario("plan_cache")
def workload_change_misses(P, tmp):
    sched = make_scheduler(P, executor(P))
    sct = saxpy_tree(P)
    sched.run(sct, saxpy_arrays(n=256))
    r = sched.run(sct, saxpy_arrays(n=128))
    assert not r.stats.plan_cache_hit
    out = run_obs(r)
    sched.close()
    return out


@scenario("plan_cache")
def bit_identical_to_uncached_path(P, tmp):
    sct, arrays = saxpy_tree(P), saxpy_arrays()
    legacy = make_scheduler(P, executor(P, persistent_pool=False,
                                        inplace_merge=False),
                            plan_cache=False)
    expected = arr(legacy.run(sct, dict(arrays)).outputs["z"])
    cached = make_scheduler(P, executor(P))
    got = [arr(cached.run(sct, dict(arrays)).outputs["z"])
           for _ in range(3)]
    for g in got:
        np.testing.assert_array_equal(expected, g)
    cached.close()
    return {"expected": expected, "got": got}


@scenario("plan_cache")
def bit_identical_under_fault_repartition(P, tmp):
    sct, arrays = saxpy_tree(P), saxpy_arrays()
    legacy = make_scheduler(P, executor(P, persistent_pool=False,
                                        inplace_merge=False),
                            plan_cache=False)
    expected = arr(legacy.run(sct, dict(arrays)).outputs["z"])
    inj = P.FaultInjector(crash_on_call={"gpu0": [2]})
    sched = make_scheduler(P, executor(P, injector=inj))
    sched.run(sct, dict(arrays))
    r = sched.run(sct, dict(arrays))
    assert r.stats.plan_cache_hit and r.stats.retries == 1
    np.testing.assert_array_equal(expected, arr(r.outputs["z"]))
    out = {"run": run_obs(r), "injected": inj.injected}
    sched.close()
    return out


@scenario("plan_cache")
def invalidated_on_quarantine_and_reinstatement(P, tmp):
    inj = P.FaultInjector(crash_on_call={"gpu0": [2, 3]})
    sched = make_scheduler(P, executor(P, injector=inj))
    sched.health.quarantine_after = 1
    sched.health.probe_after = 1
    sct, arrays = saxpy_tree(P), saxpy_arrays()
    seen = []
    for _ in range(5):
        r = sched.run(sct, dict(arrays))
        seen.append((run_obs(r), sched.plan_cache.invalidations,
                     sorted(s.device for s in sched._last_slots)))
    assert seen[2][1] == seen[1][1] + 1
    assert not seen[2][0]["stats"]["plan_cache_hit"]
    assert seen[4][1] >= seen[2][1] + 1
    sched.close()
    return seen


@scenario("plan_cache")
def invalidated_on_adjusted_shares(P, tmp):
    sched = make_scheduler(P, executor(P),
                           balancer=P.LoadBalancer(max_dev=1.5, weight=1.0))
    sct, arrays = saxpy_tree(P), saxpy_arrays()
    sched.run(sct, dict(arrays))
    before = sched.plan_cache.invalidations
    r = sched.run(sct, dict(arrays))
    assert r.action == "adjusted"
    assert sched.plan_cache.invalidations == before + 1
    out = {"action": r.action, "invalidations": before + 1,
           "z": arr(r.outputs["z"])}
    sched.close()
    return out


@scenario("plan_cache")
def disabled_cache_never_hits(P, tmp):
    sched = make_scheduler(P, executor(P), plan_cache=False)
    sct, arrays = saxpy_tree(P), saxpy_arrays()
    hits = [sched.run(sct, dict(arrays)).stats.plan_cache_hit
            for _ in range(3)]
    assert not any(hits) and sched.plan_cache.hits == 0
    out = sched.plan_cache.counters()
    sched.close()
    return out


@scenario("plan_cache")
def capacity_bound(P, tmp):
    cache = P.PlanCache(capacity=2)
    sct = saxpy_tree(P)
    slots = [P.ExecutionSlot("cpu0/f0", "cpu")]
    for n in (64, 128, 256):
        cache.partition(sct, {"x": (n,), "y": (n,)}, slots, [1.0])
    assert len(cache._parts) <= 2
    return {"parts": len(cache._parts), **cache.counters()}


@scenario("pools")
def pool_created_once_and_reused(P, tmp):
    ex = executor(P)
    sct = saxpy_tree(P)
    part = three_slot_part(P, sct)
    for _ in range(3):
        ex.execute(sct, part, saxpy_arrays(), make_profile(P, sct))
    assert ex.pools_created == 1 and ex.pool_reuses == 2
    ex.close()
    return {"created": ex.pools_created, "reuses": ex.pool_reuses}


@scenario("pools")
def legacy_flag_restores_per_run_pools(P, tmp):
    ex = executor(P, persistent_pool=False)
    sct = saxpy_tree(P)
    part = three_slot_part(P, sct)
    for _ in range(2):
        ex.execute(sct, part, saxpy_arrays(), make_profile(P, sct))
    assert ex.pools_created == 0 and ex._pool is None
    return {"created": ex.pools_created, "reuses": ex.pool_reuses}


@scenario("pools")
def session_shutdown_closes_executor(P, tmp):
    ex = executor(P)
    with P.Session(make_scheduler(P, ex)) as s:
        z = arr(s.run(saxpy_tree(P), **saxpy_arrays()).get().outputs["z"])
    assert ex._pool is None and ex._buffers == {}
    return {"z": z}


@scenario("inplace_merge")
def matches_legacy_concatenate_merge(P, tmp):
    sct = saxpy_tree(P)
    part = three_slot_part(P, sct)
    prof = make_profile(P, sct)
    legacy = executor(P, inplace_merge=False, persistent_pool=False)
    expected, _ = legacy.execute(sct, part, saxpy_arrays(), prof)
    ex = executor(P)
    got, _ = ex.execute(sct, part, saxpy_arrays(), prof)
    np.testing.assert_array_equal(arr(expected["z"]), arr(got["z"]))
    ex.close()
    return {"z": arr(got["z"]), "legacy_merge_bytes": legacy.last_merge_bytes}


@scenario("inplace_merge")
def zero_merge_bytes_once_shape_learned(P, tmp):
    ex = executor(P)
    sct = saxpy_tree(P)
    part = three_slot_part(P, sct)
    prof = make_profile(P, sct)
    ex.execute(sct, part, saxpy_arrays(), prof)
    first = (ex.last_merge_bytes, ex.last_direct_bytes)
    ex.execute(sct, part, saxpy_arrays(), prof)
    second = (ex.last_merge_bytes, ex.last_direct_bytes)
    assert first[0] > 0 and second == (0, 256 * 4)
    ex.close()
    return {"first": first, "second": second}


@scenario("inplace_merge")
def outputs_reuse_buffer_across_runs(P, tmp):
    ex = executor(P)
    sct = saxpy_tree(P)
    part = three_slot_part(P, sct)
    prof = make_profile(P, sct)
    o1, _ = ex.execute(sct, part, saxpy_arrays(a=2.0), prof)
    z1 = o1["z"]
    o2, _ = ex.execute(sct, part, saxpy_arrays(a=3.0), prof)
    assert o2["z"] is z1
    ex.close()
    return {"z": arr(o2["z"])}


@scenario("inplace_merge")
def user_merge_fn_precedence_over_partitionable(P, tmp):
    merges = {"z": lambda parts: sum(float(p.sum()) for p in parts)}
    ex = executor(P, merges=merges)
    sct = saxpy_tree(P)
    arrays = saxpy_arrays()
    out, _ = ex.execute(sct, three_slot_part(P, sct), dict(arrays),
                        make_profile(P, sct))
    expected = float(np.sum(2.0 * arrays["x"] + arrays["y"]))
    assert math.isclose(float(out["z"]), expected)
    ex.close()
    return {"z": float(out["z"])}


@scenario("inplace_merge")
def buffers_dropped_after_timeout(P, tmp):
    inj = P.FaultInjector(stall_on_call={"gpu0": [2]}, stall_seconds=1.0)
    ex = executor(P, injector=inj, policy=P.FaultPolicy(
        watchdog_multiple=1.0, min_deadline=0.2, default_deadline=0.2))
    sct = saxpy_tree(P)
    part = three_slot_part(P, sct)
    prof = make_profile(P, sct)
    ex.execute(sct, part, saxpy_arrays(), prof)
    learned = bool(ex._buffers)
    out, _ = ex.execute(sct, part, saxpy_arrays(), prof)
    kinds = [r.kind for r in ex.last_failures]
    assert learned and "timeout" in kinds and ex._buffers == {}
    ex.close()
    return {"kinds": kinds, "retries": ex.last_retries, "z": arr(out["z"])}


def expected_v(arrays):
    return (2.0 * (2.0 * arrays["x"] + arrays["y"])) + arrays["y"]


@scenario("residency")
def chain_matches_sequential_merge(P, tmp):
    arrays = saxpy_arrays()
    legacy = make_scheduler(P, executor(P, persistent_pool=False,
                                        inplace_merge=False),
                            plan_cache=False)
    env = dict(arrays)
    for sct in chain_trees(P):
        env.update({k: arr(v) for k, v in
                    legacy.run(sct, env).outputs.items()})
    sched = make_scheduler(P, executor(P))
    runs = sched.run_chain(chain_trees(P), dict(arrays))
    got = arr(runs[-1].outputs["v"])
    np.testing.assert_array_equal(env["v"], got)
    sched.close()
    return {"v": got, "runs": [stats_obs(r.stats) for r in runs]}


@scenario("residency")
def intermediate_steps_stay_resident(P, tmp):
    sched = make_scheduler(P, executor(P))
    runs = sched.run_chain(chain_trees(P), saxpy_arrays())
    assert [r.stats.resident for r in runs] == [True, True, False]
    assert all(r.stats.merge_bytes == 0 for r in runs[:-1])
    assert runs[0].outputs == {}
    out = [run_obs(r) for r in runs]
    sched.close()
    return out


@scenario("residency")
def resident_chain_copies_no_bytes_when_warm(P, tmp):
    """The locality gate's chain phase: once warm, every resident step of
    every chain copies zero bytes at merge."""
    sched = make_scheduler(P, executor(P))
    resident = []
    for _ in range(4):
        runs = sched.run_chain(chain_trees(P), saxpy_arrays(1024))
        resident += [r.stats.merge_bytes for r in runs if r.stats.resident]
    assert resident and max(resident) == 0
    np.testing.assert_array_equal(arr(runs[-1].outputs["v"]),
                                  expected_v(saxpy_arrays(1024)))
    out = {"resident_merge_bytes": resident,
           "last": [run_obs(r) for r in runs],
           "counters": counters_obs(sched)}
    sched.close()
    return out


@scenario("residency")
def fault_falls_back_to_full_merge(P, tmp):
    arrays = saxpy_arrays()
    inj = P.FaultInjector(crash_on_call={"gpu0": [1]})
    sched = make_scheduler(P, executor(P, injector=inj))
    runs = sched.run_chain(chain_trees(P), dict(arrays))
    assert runs[0].stats.retries == 1 and not runs[0].stats.resident
    np.testing.assert_array_equal(expected_v(arrays),
                                  arr(runs[-1].outputs["v"]))
    out = [run_obs(r) for r in runs]
    sched.close()
    return out


@scenario("residency")
def incompatible_partitioning_materializes(P, tmp):
    ex = executor(P)
    sct = saxpy_tree(P)
    ex.execute(sct, three_slot_part(P, sct), saxpy_arrays(),
               make_profile(P, sct), keep_resident=True)
    res = ex.last_resident
    other = three_slot_part(P, sct, shares=(0.25, 0.5, 0.25))
    assert res is not None and not res.compatible(other)
    merged = arr(res.materialize()["z"])
    np.testing.assert_array_equal(
        2.0 * saxpy_arrays()["x"] + saxpy_arrays()["y"], merged)
    ex.close()
    return {"z": merged}


@scenario("residency")
def simulator_has_no_residency(P, tmp):
    assert P.SimulatedExecutor.supports_residency is False
    return {"supports": P.ThreadedExecutor.supports_residency}


@scenario("residency")
def session_run_chain(P, tmp):
    arrays = saxpy_arrays()
    with P.Session(make_scheduler(P, executor(P))) as s:
        runs = s.run_chain(chain_trees(P), **arrays).get()
    got = arr(runs[-1].outputs["v"])
    np.testing.assert_array_equal(expected_v(arrays), got)
    return {"v": got, "runs": [stats_obs(r.stats) for r in runs]}


@scenario("timing")
def breakdown_populated(P, tmp):
    sched = make_scheduler(P, executor(P))
    s = sched.run(saxpy_tree(P), saxpy_arrays()).stats
    assert s.plan_seconds > 0 and s.compute_seconds > 0
    assert s.merge_seconds >= 0
    assert s.overhead_seconds == pytest.approx(
        s.plan_seconds + s.pool_seconds + s.dispatch_seconds
        + s.merge_seconds)
    sched.close()
    return stats_obs(s)


@scenario("timing")
def simulator_reports_timing(P, tmp):
    sched = make_scheduler(P, P.SimulatedExecutor(sim_devices(P)))
    r = sched.run(saxpy_tree(P), saxpy_arrays())
    assert r.stats.merge_bytes == 0 and r.stats.compute_seconds > 0
    return {"stats": stats_obs(r.stats), "times": list(r.stats.times)}


@scenario("zero_share")
def all_probing_with_zero_probe_share(P, tmp):
    sched = make_scheduler(P, executor(P))
    sched.health.probe_share = 0.0
    sched.health.quarantine_after = 1
    sched.health.probe_after = 0
    sched.health.record_failure("gpu0")
    sched.health.record_failure("cpu0")
    prof = make_profile(P, saxpy_tree(P))
    slots = sched._slots(prof)
    shares = sched._per_slot_shares(prof, slots)
    assert shares == pytest.approx([1.0 / len(slots)] * len(slots))
    sched.close()
    return {"slots": [s.device for s in slots], "shares": list(shares)}


@pytest.mark.parametrize("name", names("plan_cache"))
def test_locality_plan_cache(name, tmp_path):
    parity("plan_cache", name, tmp_path)


@pytest.mark.parametrize("name", names("pools"))
def test_locality_persistent_pool(name, tmp_path):
    parity("pools", name, tmp_path)


@pytest.mark.parametrize("name", names("inplace_merge"))
def test_locality_inplace_merge(name, tmp_path):
    parity("inplace_merge", name, tmp_path)


@pytest.mark.parametrize("name", names("residency"))
def test_locality_residency(name, tmp_path):
    parity("residency", name, tmp_path)


@pytest.mark.parametrize("name", names("timing"))
def test_locality_timing_breakdown(name, tmp_path):
    parity("timing", name, tmp_path)


@pytest.mark.parametrize("name", names("zero_share"))
def test_locality_zero_share_fallback(name, tmp_path):
    parity("zero_share", name, tmp_path)


# ---------------------------------------------------------------------------
# test_graph_plan_cache.py: the whole-graph plan cache
# ---------------------------------------------------------------------------

def lock_counts(sched):
    c = sched.counters()
    return (c["scheduler.decide_locks"], c["scheduler.plan_locks"])


@scenario("graph_plan_cache")
def second_submission_preplanned_zero_locks(P, tmp):
    sched = make_scheduler(P, executor(P))
    arrays = saxpy_arrays(512)
    r1 = sched.submit(single_node_graph(P), arrays).result(30)
    z1 = arr(r1.outputs["z"])
    locks0 = lock_counts(sched)
    r2 = sched.submit(single_node_graph(P), arrays).result(30)
    assert lock_counts(sched) == locks0
    assert [r.action for r in r2.runs.values()] == ["preplanned"]
    np.testing.assert_array_equal(z1, arr(r2.outputs["z"]))
    c = sched.plan_cache.counters()
    assert c["graph_hits"] == 1 and c["graph_misses"] == 1
    out = {"z": z1, "locks": locks0, "counters": counters_obs(sched)}
    sched.close()
    return out


@scenario("graph_plan_cache")
def chain_graph_preplanned_bit_identical(P, tmp):
    sched = make_scheduler(P, executor(P))
    arrays = saxpy_arrays(512)
    r1 = sched.submit(chain_graph(P), arrays).result(30)
    v1 = arr(r1.outputs["v"])
    locks0 = lock_counts(sched)
    r2 = sched.submit(chain_graph(P), arrays).result(30)
    assert lock_counts(sched) == locks0
    assert all(r.action == "preplanned" for r in r2.runs.values())
    np.testing.assert_array_equal(v1, arr(r2.outputs["v"]))
    out = {"v": v1, "counters": counters_obs(sched),
           "runs": {k: stats_obs(r.stats) for k, r in r2.runs.items()}}
    sched.close()
    return out


@scenario("graph_plan_cache")
def array_signature_in_key(P, tmp):
    sched = make_scheduler(P, executor(P))
    sched.submit(single_node_graph(P), saxpy_arrays(256)).result(30)
    r = sched.submit(single_node_graph(P), saxpy_arrays(512)).result(30)
    assert all(x.action != "preplanned" for x in r.runs.values())
    assert sched.plan_cache.counters()["graph_misses"] == 2
    out = counters_obs(sched)
    sched.close()
    return out


@scenario("graph_plan_cache")
def health_movement_drops_plan(P, tmp):
    sched = make_scheduler(P, executor(P))
    arrays = saxpy_arrays(512)
    z1 = arr(sched.submit(single_node_graph(P), arrays).result(30)
             .outputs["z"])
    for _ in range(sched.health.quarantine_after):
        sched.health.record_failure("gpu0")
    assert sched.health.version > 0
    r2 = sched.submit(single_node_graph(P), arrays).result(30)
    assert all(x.action != "preplanned" for x in r2.runs.values())
    np.testing.assert_array_equal(z1, arr(r2.outputs["z"]))
    out = {"actions": [x.action for x in r2.runs.values()],
           "counters": counters_obs(sched)}
    sched.close()
    return out


@scenario("graph_plan_cache")
def explicit_invalidation_forces_replan(P, tmp):
    sched = make_scheduler(P, executor(P))
    arrays = saxpy_arrays(512)
    sched.submit(single_node_graph(P), arrays).result(30)
    sched.plan_cache.invalidate("test")
    r = sched.submit(single_node_graph(P), arrays).result(30)
    assert all(x.action != "preplanned" for x in r.runs.values())
    assert sched.plan_cache.counters()["graph_misses"] == 2
    out = counters_obs(sched)
    sched.close()
    return out


@scenario("graph_plan_cache")
def faulted_graph_is_not_recorded(P, tmp):
    inj = P.FaultInjector(crash_on_call={"gpu0": [1]})
    sched = make_scheduler(P, executor(P, injector=inj))
    arrays = saxpy_arrays(512)
    r1 = sched.submit(single_node_graph(P), arrays).result(30)
    assert any(x.stats.retries for x in r1.runs.values())
    r2 = sched.submit(single_node_graph(P), arrays).result(30)
    assert all(x.action != "preplanned" for x in r2.runs.values())
    assert sched.plan_cache.counters()["graph_misses"] == 2
    out = {"first": run_obs(r1.runs["s"]), "second": run_obs(r2.runs["s"]),
           "counters": counters_obs(sched)}
    sched.close()
    return out


@scenario("graph_plan_cache")
def disabled_cache_never_preplans(P, tmp):
    sched = make_scheduler(P, executor(P), plan_cache=False)
    arrays = saxpy_arrays(512)
    actions = []
    for _ in range(2):
        r = sched.submit(single_node_graph(P), arrays).result(30)
        actions += [x.action for x in r.runs.values()]
    assert "preplanned" not in actions
    out = {"actions": actions, "counters": counters_obs(sched)}
    sched.close()
    return out


@scenario("graph_plan_cache")
def virtual_path_preplanned_and_deterministic(P, tmp):
    arrays = saxpy_arrays(4096)
    sched = make_scheduler(P, make_sim(P))
    r1 = sched.submit(single_node_graph(P), arrays).result(30)
    z1 = arr(r1.outputs["z"])
    r2 = sched.submit(single_node_graph(P), arrays).result(30)
    assert [x.action for x in r2.runs.values()] == ["preplanned"]
    np.testing.assert_array_equal(z1, arr(r2.outputs["z"]))
    out = {"z": z1, "times": list(r2.runs["s"].stats.times)}
    sched.close()
    return out


@scenario("graph_hit_rate")
def repeated_identical_single_node_hit_rate(P, tmp):
    sched = make_scheduler(P, executor(P))
    arrays = saxpy_arrays(1024)
    for _ in range(8):
        sched.submit(single_node_graph(P), arrays).result(30)
    pc = sched.plan_cache
    assert pc.misses == 1 and pc.hits >= 7 and pc.hit_rate >= 7 / 8
    out = counters_obs(sched)
    sched.close()
    return out


@pytest.mark.parametrize("name", names("graph_plan_cache"))
def test_graph_plan_cache(name, tmp_path):
    parity("graph_plan_cache", name, tmp_path)


@pytest.mark.parametrize("name", names("graph_hit_rate"))
def test_graph_plan_cache_hit_rate(name, tmp_path):
    parity("graph_hit_rate", name, tmp_path)


# ---------------------------------------------------------------------------
# test_fusion.py: cross-request fusion
# ---------------------------------------------------------------------------

def member_arrays(i, n=256):
    arrays = saxpy_arrays(n)
    arrays["x"] = arrays["x"] + np.float32(i)
    return arrays


def independent_outputs(P, k, n=256):
    sched = make_scheduler(P, executor(P))
    try:
        return [arr(sched.submit(single_node_graph(P), member_arrays(i, n))
                    .result(30).outputs["z"]) for i in range(k)]
    finally:
        sched.close()


def fused(P, k, *, injector=None, window=5.0, fusion_max=4):
    expected = independent_outputs(P, k)
    sched = make_scheduler(P, executor(P, injector=injector),
                           fusion_window=window, fusion_max=fusion_max)
    handles = [sched.submit(single_node_graph(P), member_arrays(i))
               for i in range(k)]
    results = [h.result(30) for h in handles]
    got = [arr(r.outputs["z"]) for r in results]
    for g, e in zip(got, expected):
        np.testing.assert_array_equal(g, e)
    out = {"z": got, "actions": [r.runs["s"].action for r in results],
           "retries": [r.runs["s"].stats.retries for r in results],
           "counters": counters_obs(sched)}
    sched.close()
    return out


@scenario("fusion")
def fused_batch_bit_identical(P, tmp):
    out = fused(P, 4)
    assert out["actions"] == ["fused"] * 4
    c = out["counters"]
    assert (c["scheduler.fused_requests"], c["scheduler.fused_batches"],
            c["scheduler.runs"]) == (4, 1, 1)
    return out


@scenario("fusion")
def fused_eight_of_eight_as_the_pipeline_gate(P, tmp):
    out = fused(P, 8, window=0.5, fusion_max=8)
    assert out["actions"] == ["fused"] * 8
    return out


@scenario("fusion")
def fused_bit_identical_under_fault_injection(P, tmp):
    out = fused(P, 4, injector=P.FaultInjector(crash_on_call={"gpu0": [1]}))
    assert out["actions"] == ["fused"] * 4 and any(out["retries"])
    assert out["counters"]["scheduler.fused_requests"] == 4
    return out


@scenario("fusion")
def fusion_max_flushes_early(P, tmp):
    sched = make_scheduler(P, executor(P), fusion_window=30.0, fusion_max=3)
    handles = [sched.submit(single_node_graph(P), member_arrays(i))
               for i in range(3)]
    got = [arr(h.result(10).outputs["z"]) for h in handles]
    assert sched.counters()["scheduler.fused_batches"] == 1
    out = {"z": got, "counters": counters_obs(sched)}
    sched.close()
    return out


@scenario("fusion")
def window_expiry_single_member_falls_back(P, tmp):
    sched = make_scheduler(P, executor(P), fusion_window=0.05, fusion_max=8)
    r = sched.submit(single_node_graph(P), member_arrays(0)).result(30)
    assert r.runs["s"].action != "fused"
    np.testing.assert_array_equal(
        arr(r.outputs["z"]), 2.0 * np.arange(256, dtype=np.float32) + 1.0)
    assert sched.counters()["scheduler.fused_requests"] == 0
    out = run_obs(r.runs["s"])
    sched.close()
    return out


@scenario("fusion")
def differing_scalar_values_do_not_fuse(P, tmp):
    sched = make_scheduler(P, executor(P, reuse_buffers=False),
                           fusion_window=0.05, fusion_max=2)
    h2 = sched.submit(single_node_graph(P), saxpy_arrays(256, a=2.0))
    h3 = sched.submit(single_node_graph(P), saxpy_arrays(256, a=3.0))
    x = np.arange(256, dtype=np.float32)
    z2, z3 = arr(h2.result(30).outputs["z"]), arr(h3.result(30).outputs["z"])
    np.testing.assert_array_equal(z2, 2.0 * x + 1.0)
    np.testing.assert_array_equal(z3, 3.0 * x + 1.0)
    assert sched.counters()["scheduler.fused_requests"] == 0
    sched.close()
    return {"z": [z2, z3]}


@scenario("fusion")
def partition_bound_trait_is_ineligible(P, tmp):
    sct = P.kernel(lambda x, n: x + np.float32(n), name="plusn",
                   inputs=[P.vector("x"), P.scalar("n", trait=P.Trait.SIZE)],
                   outputs=[P.vector("z")])
    sched = make_scheduler(P, executor(P), fusion_window=0.05, fusion_max=2)
    arrays = {"x": np.arange(256, dtype=np.float32)}
    handles = [sched.submit(single_node_graph(P, sct), dict(arrays))
               for _ in range(2)]
    actions = [h.result(30).runs["s"].action for h in handles]
    assert "fused" not in actions
    assert sched.counters()["scheduler.fused_requests"] == 0
    sched.close()
    return {"actions": actions}


@scenario("fusion")
def user_merge_is_ineligible(P, tmp):
    cat = (lambda parts: np.concatenate(parts)) if P is R else \
        (lambda parts: torch.cat(list(parts)))
    sched = make_scheduler(P, executor(P, merges={"z": cat}),
                           fusion_window=0.05, fusion_max=2)
    handles = [sched.submit(single_node_graph(P), member_arrays(i))
               for i in range(2)]
    actions = [h.result(30).runs["s"].action for h in handles]
    assert "fused" not in actions
    assert sched.counters()["scheduler.fused_requests"] == 0
    sched.close()
    return {"actions": actions}


@scenario("fusion")
def undeclared_arrays_are_ineligible(P, tmp):
    sched = make_scheduler(P, executor(P), fusion_window=0.05, fusion_max=2)
    handles = []
    for i in range(2):
        arrays = member_arrays(i)
        arrays["junk"] = np.zeros(4, dtype=np.float32)
        handles.append(sched.submit(single_node_graph(P), arrays))
    actions = [h.result(30).runs["s"].action for h in handles]
    assert "fused" not in actions
    assert sched.counters()["scheduler.fused_requests"] == 0
    sched.close()
    return {"actions": actions}


@scenario("fusion")
def drain_flushes_open_batches(P, tmp):
    sched = make_scheduler(P, executor(P), fusion_window=30.0, fusion_max=8)
    h = sched.submit(single_node_graph(P), member_arrays(0))
    assert sched.drain(20) and h.done()
    z = arr(h.result(0).outputs["z"])
    np.testing.assert_array_equal(
        z, 2.0 * np.arange(256, dtype=np.float32) + 1.0)
    sched.close()
    return {"z": z}


@pytest.mark.parametrize("name", names("fusion"))
def test_fusion(name, tmp_path):
    parity("fusion", name, tmp_path)


# ---------------------------------------------------------------------------
# test_admission.py: FIFO settlement, drain
# ---------------------------------------------------------------------------

def gated_graph(P, i, event):
    sct = P.kernel(lambda x, ev=event: ev.wait(20) and x + 1.0,
                   name=f"gate{i}", inputs=[P.vector("x")],
                   outputs=[P.vector(f"z{i}")])
    return single_node_graph(P, sct)


@scenario("admission")
def fifo_settlement_order_and_drain_terminal(P, tmp):
    events = [threading.Event() for _ in range(5)]
    order = []
    sched = make_scheduler(P, executor(P, max_workers=32), max_inflight=2)
    try:
        x = np.arange(128, dtype=np.float32)
        handles = []
        for i in range(5):
            h = sched.submit(gated_graph(P, i, events[i]), {"x": x})
            h.add_done_callback(lambda _h, i=i: order.append(i))
            handles.append(h)
        time.sleep(0.3)
        assert not any(h.done() for h in handles)
        pending = [set(h.status().values()) for h in handles[2:]]
        assert pending == [{"pending"}] * 3
        for i in range(5):
            events[i].set()
            assert handles[i].wait(20)
            if i + 2 < len(handles):
                assert not handles[i + 2].done()
        assert order == [0, 1, 2, 3, 4]
        assert sched.drain(20)
        outs = []
        for i, h in enumerate(handles):
            assert set(h.status().values()) == {"done"}
            outs.append(arr(h.result(0).outputs[f"z{i}"]))
            np.testing.assert_array_equal(outs[-1], x + 1.0)
        return {"order": order, "pending": pending, "z": outs}
    finally:
        for ev in events:
            ev.set()
        sched.close()


@scenario("admission")
def drain_with_unblocked_burst(P, tmp):
    sched = make_scheduler(P, executor(P), max_inflight=2)
    x = np.arange(256, dtype=np.float32)
    handles = []
    for i in range(5):
        sct = P.kernel(lambda x: x * 2.0, name=f"dbl{i}",
                       inputs=[P.vector("x")], outputs=[P.vector(f"z{i}")])
        handles.append(sched.submit(single_node_graph(P, sct), {"x": x}))
    assert sched.drain(30)
    outs = [arr(h.result(0).outputs[f"z{i}"]) for i, h in enumerate(handles)]
    for z in outs:
        np.testing.assert_array_equal(z, x * 2.0)
    sched.close()
    return {"z": outs}


@pytest.mark.parametrize("name", names("admission"))
def test_admission_fairness(name, tmp_path):
    parity("admission", name, tmp_path)


# ---------------------------------------------------------------------------
# test_telemetry.py: tracer, validation, metrics, events, the pipeline
# ---------------------------------------------------------------------------

def counting_clock(step: float = 1.0):
    c = itertools.count()
    return lambda: next(c) * step


class LogRecords(logging.Handler):
    """The records the telemetry's logger emits inside a ``with``."""

    def __init__(self, level):
        super().__init__(level)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def __enter__(self):
        self.logger = logging.getLogger(R_tel.LOGGER_NAME)
        self.old = self.logger.level
        self.logger.setLevel(self.level)
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)
        self.logger.setLevel(self.old)


@scenario("tracer")
def nested_spans_emit_matched_be_pairs(P, tmp):
    tr = P.Tracer(clock=counting_clock())
    with tr.span("outer"):
        with tr.span("inner"):
            pass
    evs = tr.events()
    assert [(e["name"], e["ph"]) for e in evs] == \
        [("outer", "B"), ("inner", "B"), ("inner", "E"), ("outer", "E")]
    return evs


@scenario("tracer")
def span_attrs_late_notes_and_exceptions(P, tmp):
    tr = P.Tracer(clock=counting_clock())
    with tr.span("plan", slots=3) as sp:
        sp.note(cache_hit=True)
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("x")
    evs = tr.events()
    assert evs[0]["args"] == {"slots": 3}
    assert evs[1]["args"] == {"cache_hit": True}
    assert evs[3]["args"]["error"] == "ValueError"
    assert P.validate_chrome_trace(tr.chrome_trace()) == []
    return evs


@scenario("tracer")
def instant_virtual_open_and_capacity(P, tmp):
    tr = P.Tracer(clock=counting_clock())
    tr.instant("marker", reason="test")
    tr.record("slot", 100.0, 50.0, tid=7, device="gpu0")
    sp = tr.span("dangling")
    sp.__enter__()
    trace = tr.chrome_trace()
    assert P.validate_chrome_trace(trace) == []
    assert trace["traceEvents"][-1]["args"]["unterminated"]
    small = P.Tracer(clock=counting_clock(), capacity=4)
    for _ in range(5):
        with small.span("s"):
            pass
    assert len(small.events()) == 4 and small.dropped == 6
    return {"trace": trace, "small": small.events()}


@scenario("tracer")
def threads_get_distinct_tids(P, tmp):
    tr = P.Tracer()

    def spin():
        with tr.span("t"):
            time.sleep(0.01)

    threads = [threading.Thread(target=spin) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tids = {e["tid"] for e in tr.events()}
    assert len(tids) == 3
    assert P.validate_chrome_trace(tr.chrome_trace()) == []
    return sorted(tids)


@scenario("validation")
def validation_errors(P, tmp):
    v = P.validate_chrome_trace
    unmatched = v({"traceEvents": [
        {"name": "a", "ph": "B", "ts": 0, "pid": 0, "tid": 0}]})
    nesting = v({"traceEvents": [
        {"name": "a", "ph": "B", "ts": 0, "pid": 0, "tid": 0},
        {"name": "b", "ph": "E", "ts": 1, "pid": 0, "tid": 0}]})
    keys = v({"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "pid": 0, "tid": 0},
        {"ph": "i", "ts": 0, "pid": 0, "tid": 0}]})
    assert any("unmatched B" in e for e in unmatched)
    assert any("mismatched" in e for e in nesting)
    assert any("dur" in e for e in keys)
    assert any("missing keys" in e for e in keys)
    assert v([]) == ["trace is not a JSON object"]
    assert v({}) == ["traceEvents missing or not a list"]
    return [unmatched, nesting, keys]


@scenario("metrics")
def counters_gauges_histograms_prometheus(P, tmp):
    reg = SUB[P]["tel"].MetricsRegistry()
    reg.counter("runs_total").inc()
    reg.counter("runs_total").inc(2)
    reg.counter("busy", device="gpu0").inc(1.5)
    reg.counter("busy", device="cpu0").inc(0.5)
    reg.counter("runs_total", status="ok").inc(4)
    reg.gauge("lbt").set(0.75)
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["runs_total"] == 3.0 and snap["busy{device=gpu0}"] == 1.5
    assert snap["lat"]["buckets"] == {"0.1": 1, "1.0": 2, "+Inf": 3}
    text = reg.to_prometheus()
    assert 'runs_total{status="ok"} 4.0' in text
    return {"snapshot": snap, "prometheus": text}


@scenario("events")
def ring_buffer_sinks_and_filters(P, tmp):
    EventLog = SUB[P]["tel"].EventLog
    log = EventLog(capacity=3, bridge=False)
    for i in range(5):
        log.emit("e", i=i)
    ring = [(e.fields["i"], e.seq) for e in log.records()]
    assert ring == [(2, 2), (3, 3), (4, 4)]
    seen = []
    log2 = EventLog(bridge=False, sink=seen.append)
    log2.add_sink(lambda e: 1 / 0)
    ev = log2.emit("fault", device="gpu0")
    assert seen == [ev] and ev.fields == {"device": "gpu0"}
    log3 = EventLog(bridge=False)
    for kind in ("health.quarantined", "health.reinstated", "fault"):
        log3.emit(kind)
    assert len(log3.records("health")) == 2
    return {"ring": ring, "kinds": [e.kind for e in log3.records("health")]}


@scenario("events")
def logging_bridge_and_disabled_log(P, tmp):
    with LogRecords(logging.INFO) as info:
        SUB[P]["tel"].EventLog().emit("balancer.trigger", level="info",
                                      lbt=0.95)
    assert any("balancer.trigger" in r.getMessage() for r in info.records)
    log = P.NULL_TELEMETRY.events
    with LogRecords(logging.WARNING) as warn:
        log.emit("health.quarantined", level="warning",
                 message="device gpu0 quarantined", device="gpu0")
        log.emit("plan_cache.invalidated")
    msgs = [r.getMessage() for r in warn.records]
    assert len(log) == 0 and any("gpu0 quarantined" in m for m in msgs)
    assert not any("plan_cache" in m for m in msgs)
    return {"info": [r.getMessage() for r in info.records], "warn": msgs}


@scenario("noop")
def null_span_singleton_and_disabled_pipeline(P, tmp):
    t = P.NULL_TELEMETRY.tracer
    assert t.span("a", x=1) is t.span("b")
    assert P.NULL_TELEMETRY.metrics.counter("c") is \
        P.NULL_TELEMETRY.metrics.gauge("g")
    sched = make_scheduler(P, executor(P))
    sched.run(saxpy_tree(P), saxpy_arrays())
    assert sched.telemetry is P.NULL_TELEMETRY
    assert sched.telemetry.tracer.events() == []
    assert sched.telemetry.metrics.snapshot() == {}
    sched.close()
    return {}


@scenario("noop")
def noop_span_microbench(P, tmp):
    tracer = P.NULL_TELEMETRY.tracer
    n = 50_000
    t0 = time.perf_counter()
    for _ in range(n):
        with tracer.span("slot", device="gpu0/q0", units=128):
            pass
    per_span = (time.perf_counter() - t0) / n
    assert per_span < 5e-6, f"no-op span costs {per_span * 1e6:.2f}µs"
    return {}


def span_names(trace):
    return sorted({e["name"] for e in trace["traceEvents"]})


@scenario("pipeline_tracing")
def run_trace_contains_span_model(P, tmp):
    tel = P.Telemetry()
    sched = make_scheduler(P, executor(P), telemetry=tel)
    sched.run(saxpy_tree(P), saxpy_arrays())
    tmp.mkdir(parents=True, exist_ok=True)
    trace = tel.export_trace(str(tmp / "trace.json"))
    assert P.validate_chrome_trace(trace) == []
    assert {"run", "plan", "dispatch", "attempt", "slot",
            "merge"} <= set(span_names(trace))
    out = {"names": span_names(trace),
           "metrics": metrics_obs(tel.metrics.snapshot())}
    sched.close()
    return out


@scenario("pipeline_tracing")
def fault_injected_chain_trace(P, tmp):
    tel = P.Telemetry()
    inj = P.FaultInjector(crash_on_call={"gpu0": [1]})
    sched = make_scheduler(P, executor(P, injector=inj), telemetry=tel)
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / "trace.json"
    with P.Session(sched) as s:
        runs = s.run_chain(chain_trees(P, 2), **saxpy_arrays()).get()
        s.export_trace(str(path))
    trace = json.loads(path.read_text())
    assert P.validate_chrome_trace(trace) == []
    retry = [e for e in trace["traceEvents"] if e["name"] == "attempt"
             and e.get("args", {}).get("attempt", 0) >= 1]
    assert retry and sum(r.stats.retries for r in runs) >= 1
    kinds = sorted({e.kind for e in tel.events.records()})
    assert {"fault", "retry.repartition"} <= set(kinds)
    return {"names": span_names(trace), "retry_spans": len(retry),
            "kinds": kinds, "runs": [run_obs(r) for r in runs],
            "metrics": metrics_obs(tel.metrics.snapshot())}


@scenario("pipeline_tracing")
def session_metrics_match_execution_stats(P, tmp):
    tel = P.Telemetry()
    inj = P.FaultInjector(crash_on_call={"gpu0": [2]})
    sched = make_scheduler(P, executor(P, injector=inj), telemetry=tel)
    stats = []
    with P.Session(sched) as s:
        for _ in range(3):
            stats.append(s.run(saxpy_tree(P), **saxpy_arrays()).get().stats)
        m = s.metrics()
    assert m["retries_total"] == sum(st.retries for st in stats)
    hits = m.get("plan_cache_hits_total", 0)
    misses = m.get("plan_cache_misses_total", 0)
    assert hits + misses == len(stats)
    assert hits / (hits + misses) == pytest.approx(sched.plan_cache.hit_rate)
    assert m["merge_bytes_total"] == sum(st.merge_bytes for st in stats)
    assert m["runs_total{status=ok}"] == sum(1 for st in stats if st.ok)
    return {"stats": [stats_obs(st) for st in stats],
            "metrics": metrics_obs(m)}


@scenario("pipeline_tracing")
def device_busy_seconds_accounted(P, tmp):
    tel = P.Telemetry()
    sched = make_scheduler(P, executor(P), telemetry=tel)
    sched.run(saxpy_tree(P), saxpy_arrays())
    m = tel.metrics.snapshot()
    assert m.get("device_busy_seconds_total{device=gpu0}", 0) > 0
    assert m.get("device_busy_seconds_total{device=cpu0}", 0) > 0
    sched.close()
    return metrics_obs(m)


@scenario("pipeline_tracing")
def plan_cache_invalidation_and_balancer_events(P, tmp):
    tel = P.Telemetry()
    sched = make_scheduler(P, executor(P), telemetry=tel,
                           balancer=P.LoadBalancer(max_dev=1.5, weight=1.0))
    sched.run(saxpy_tree(P), saxpy_arrays())
    r = sched.run(saxpy_tree(P), saxpy_arrays())
    assert r.action == "adjusted"
    evs = tel.events.records("plan_cache.invalidated")
    assert evs and evs[0].fields["reason"] == "share adjustment"
    assert tel.metrics.snapshot()["plan_cache_invalidations_total"] >= 1
    kinds = [e.kind for e in tel.events.records()]
    assert "balancer.trigger" in kinds and "balancer.adjust" in kinds
    adj = tel.events.records("balancer.adjust")[0]
    assert {"share_a_before", "share_a_after"} <= set(adj.fields)
    sched.close()
    return {"kinds": kinds, "reason": evs[0].fields["reason"]}


@scenario("counters")
def scheduler_counters_namespaced(P, tmp):
    inj = P.FaultInjector(crash_on_call={"gpu0": [2]})
    ex = executor(P, injector=inj)
    sched = make_scheduler(P, ex)
    for _ in range(3):
        sched.run(saxpy_tree(P), saxpy_arrays())
    c = sched.counters()
    assert c["plan_cache.hits"] == sched.plan_cache.hits
    assert c["scheduler.runs"] == 3 and c["scheduler.retries"] == 1
    assert c["executor.pools_created"] == ex.pools_created
    assert c["executor.pool_reuses"] == ex.pool_reuses
    assert "balancer.balance_ops" in c and "health.quarantined" in c
    sched.close()
    return {"counters": counters_obs(sched), "keys": sorted(c)}


@scenario("counters")
def session_reexports_counters_and_resident_handoffs(P, tmp):
    sched = make_scheduler(P, executor(P))
    with P.Session(sched) as s:
        s.run_chain(chain_trees(P, 2), **saxpy_arrays()).get()
        c = s.counters()
    assert c["scheduler.resident_handoffs"] == 1
    assert c["scheduler.runs"] == 2
    return {k: v for k, v in c.items() if not k.startswith("balancer.")}


@scenario("health_logging")
def quarantine_and_reinstatement_logged(P, tmp):
    DeviceHealth = P.DeviceHealth
    h = DeviceHealth(quarantine_after=2)
    with LogRecords(logging.WARNING) as logs:
        h.record_failure("gpu0")
        silent = len(logs.records)
        h.record_failure("gpu0")
        h.record_success("gpu0")
    msgs = [r.getMessage() for r in logs.records]
    assert silent == 0
    assert any("gpu0" in m and "2 consecutive failures" in m for m in msgs)
    assert any("gpu0" in m and "reinstated" in m for m in msgs)
    tel = P.Telemetry()
    h2 = DeviceHealth(quarantine_after=1)
    h2.telemetry = tel
    h2.record_failure("gpu0")
    h2.record_success("gpu0")
    kinds = [e.kind for e in tel.events.records()]
    assert kinds == ["health.quarantined", "health.reinstated"]
    return {"msgs": msgs, "kinds": kinds,
            "metrics": tel.metrics.snapshot()}


def sim_telemetry(P):
    tel = P.Telemetry(clock=counting_clock())
    inj = P.FaultInjector(crash_on_call={"gpu0": [1]})
    ex = P.SimulatedExecutor(sim_devices(P), seed=7, injector=inj)
    sched = make_scheduler(P, ex, telemetry=tel)
    for _ in range(3):
        sched.run(saxpy_tree(P), saxpy_arrays())
    return tel


@scenario("simulator_telemetry")
def trace_is_deterministic_on_the_virtual_timeline(P, tmp):
    t1, t2 = sim_telemetry(P), sim_telemetry(P)
    trace = t1.tracer.chrome_trace()
    assert trace["traceEvents"] == t2.tracer.chrome_trace()["traceEvents"]
    assert P.validate_chrome_trace(trace) == []
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert xs and all(e["name"] == "slot" for e in xs)
    assert any(e["args"].get("fault") == "crash" for e in xs)
    retry = [e for e in xs if e["args"]["attempt"] == 1]
    round0 = min(e["ts"] for e in xs)
    end0 = round0 + max(e["dur"] for e in xs if e["ts"] == round0)
    assert retry and min(e["ts"] for e in retry) >= end0
    return {"slots": xs,
            "metrics": {k: v for k, v in t1.metrics.snapshot().items()
                        if not k.startswith("overhead_seconds")},
            "kinds": [e.kind for e in t1.events.records()]}


@scenario("overhead")
def components_nonnegative_and_bounded(P, tmp):
    for plan_cache, persistent in itertools.product((True, False),
                                                    repeat=2):
        sched = make_scheduler(P, executor(P, persistent_pool=persistent),
                               plan_cache=plan_cache)
        for _ in range(2):
            t0 = time.perf_counter()
            s = sched.run(saxpy_tree(P), saxpy_arrays()).stats
            wall = time.perf_counter() - t0
            parts = (s.plan_seconds, s.pool_seconds, s.dispatch_seconds,
                     s.merge_seconds)
            assert all(c >= 0 for c in parts) and s.compute_seconds >= 0
            assert s.overhead_seconds == pytest.approx(sum(parts))
            assert s.overhead_seconds + s.compute_seconds <= wall + 5e-3
        sched.close()
    return {}


@scenario("overhead")
def stats_histogram_recorded(P, tmp):
    tel = P.Telemetry()
    sched = make_scheduler(P, executor(P), telemetry=tel)
    sched.run(saxpy_tree(P), saxpy_arrays())
    snap = tel.metrics.snapshot()
    counts = [snap[k]["count"] for k in
              ("overhead_seconds", "class_makespan_seconds{cls=a}",
               "class_makespan_seconds{cls=b}")]
    assert counts == [1, 1, 1]
    sched.close()
    return counts


@scenario("export")
def metrics_block_snapshot_and_trace_file(P, tmp):
    tel = P.Telemetry()
    tel.metrics.counter("runs_total").inc()
    block = P.metrics_block(tel)
    assert block == {"schema": "repro.metrics/v1", "enabled": True,
                     "metrics": {"runs_total": 1.0}}
    tel.events.emit("fault", level="warning", device="gpu0")
    tel.metrics.histogram("lat").observe(0.1)
    json.dumps(tel.snapshot())
    with tel.tracer.span("run"):
        pass
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / "t.json"
    tel.export_trace(str(path))
    trace = json.loads(path.read_text())
    assert P.validate_chrome_trace(trace) == []
    return {"block": block, "names": span_names(trace)}


@pytest.mark.parametrize("name", names("tracer"))
def test_telemetry_tracer(name, tmp_path):
    parity("tracer", name, tmp_path)


@pytest.mark.parametrize("name", names("validation"))
def test_telemetry_validation(name, tmp_path):
    parity("validation", name, tmp_path)


@pytest.mark.parametrize("name", names("metrics"))
def test_telemetry_metrics(name, tmp_path):
    parity("metrics", name, tmp_path)


@pytest.mark.parametrize("name", names("events"))
def test_telemetry_event_log(name, tmp_path):
    parity("events", name, tmp_path)


@pytest.mark.parametrize("name", names("noop"))
def test_telemetry_noop_cost(name, tmp_path):
    parity("noop", name, tmp_path)


@pytest.mark.parametrize("name", names("pipeline_tracing"))
def test_telemetry_pipeline_tracing(name, tmp_path):
    parity("pipeline_tracing", name, tmp_path)


@pytest.mark.parametrize("name", names("counters"))
def test_telemetry_counters(name, tmp_path):
    parity("counters", name, tmp_path)


@pytest.mark.parametrize("name", names("health_logging"))
def test_telemetry_health_logging(name, tmp_path):
    parity("health_logging", name, tmp_path)


@pytest.mark.parametrize("name", names("simulator_telemetry"))
def test_telemetry_simulator(name, tmp_path):
    parity("simulator_telemetry", name, tmp_path)


@pytest.mark.parametrize("name", names("overhead"))
def test_telemetry_overhead_invariants(name, tmp_path):
    parity("overhead", name, tmp_path)


@pytest.mark.parametrize("name", names("export"))
def test_telemetry_export(name, tmp_path):
    parity("export", name, tmp_path)


# ---------------------------------------------------------------------------
# test_faults.py: the injector, containment, retries, quarantine
# ---------------------------------------------------------------------------

@scenario("injector")
def seeded_sequence_is_deterministic(P, tmp):
    def drive(inj):
        return [inj.decide(d) for d in
                ["gpu0/q0", "cpu0/f0", "gpu0/q0", "cpu0/f1"] * 10]
    a = P.FaultInjector(seed=42, crash_prob=0.3, stall_prob=0.2)
    b = P.FaultInjector(seed=42, crash_prob=0.3, stall_prob=0.2)
    seq = drive(a)
    assert seq == drive(b) and a.injected == b.injected
    assert any(k == "crash" for k, _, _ in a.injected)
    return {"sequence": seq, "injected": a.injected}


@scenario("injector")
def nth_call_and_per_device_overrides(P, tmp):
    inj = P.FaultInjector(crash_on_call={"gpu0": [2]})
    calls = [inj.decide(d) for d in ("gpu0/q0", "cpu0/f0", "gpu0/q1",
                                     "gpu0/q0")]
    assert calls == [None, None, "crash", None]
    prob = P.FaultInjector(seed=0, device_crash_prob={"gpu0": 1.0})
    over = [prob.decide("gpu0/q0"), prob.decide("cpu0/f0")]
    assert over == ["crash", None]
    return {"calls": calls, "over": over}


def fault_arrays():
    return saxpy_arrays(n=64)


def fault_part(P, sct):
    return three_slot_part(P, sct, n=64)


@scenario("threaded_faults")
def crash_repartitions_and_matches_reference(P, tmp):
    sct = saxpy_tree(P)
    clean = executor(P)
    want = arr(clean.execute(sct, fault_part(P, sct), fault_arrays(),
                             make_profile(P, sct, 64))[0]["z"])
    inj = P.FaultInjector(crash_on_call={"gpu0": [1]})
    ex = executor(P, injector=inj)
    out, times = ex.execute(sct, fault_part(P, sct), fault_arrays(),
                            make_profile(P, sct, 64))
    np.testing.assert_array_equal(arr(out["z"]), want)
    assert ex.last_retries == 1 and len(ex.last_failures) == 1
    rec = ex.last_failures[0]
    assert rec.device_base == "gpu0" and rec.kind == "crash"
    assert len(times) == 3
    clean.close()
    ex.close()
    return {"z": arr(out["z"]), "failures": [
        (r.slot, r.device, r.kind, r.attempt) for r in ex.last_failures]}


@scenario("threaded_faults")
def user_kernel_exception_is_contained(P, tmp):
    boom = P.kernel(lambda x: (_ for _ in ()).throw(ValueError("boom")),
                    name="boom", inputs=[P.vector("x")],
                    outputs=[P.vector("y")])
    part = P.build_plan(boom, {"x": (8,)}).partition(
        [P.ExecutionSlot("cpu0/f0", "cpu"), P.ExecutionSlot("cpu0/f1", "cpu")],
        [0.5, 0.5])
    ex = executor(P, policy=P.FaultPolicy())
    with pytest.raises(P.ExecutionError) as ei:
        ex.execute(boom, part, {"x": np.ones(8, np.float32)},
                   make_profile(P, boom, 8))
    assert "ValueError: boom" in str(ei.value)
    assert all(r.kind == "crash" for r in ei.value.records)
    ex.close()
    return {"kinds": [(r.device, r.kind) for r in ei.value.records],
            "attempts": ei.value.attempts}


@scenario("threaded_faults")
def exhausted_retries_raises_with_records(P, tmp):
    sct = saxpy_tree(P)
    inj = P.FaultInjector(crash_on_call={"gpu0": [1], "cpu0": [3]})
    ex = executor(P, injector=inj, policy=P.FaultPolicy(max_attempts=2))
    with pytest.raises(P.ExecutionError, match="retries exhausted") as ei:
        ex.execute(sct, fault_part(P, sct), fault_arrays(),
                   make_profile(P, sct, 64))
    kinds = sorted((r.device_base, r.kind) for r in ei.value.records)
    assert ("gpu0", "crash") in kinds and ("cpu0", "crash") in kinds
    assert ei.value.attempts == 2
    ex.close()
    return {"kinds": kinds, "attempts": ei.value.attempts}


@scenario("threaded_faults")
def all_slots_dead_is_partition_lost(P, tmp):
    sct = saxpy_tree(P)
    ex = executor(P, injector=P.FaultInjector(crash_prob=1.0),
                  policy=P.FaultPolicy())
    with pytest.raises(P.ExecutionError, match="partition lost") as ei:
        ex.execute(sct, fault_part(P, sct), fault_arrays(),
                   make_profile(P, sct, 64))
    ex.close()
    return {"records": sorted((r.device, r.kind) for r in ei.value.records),
            "attempts": ei.value.attempts}


@scenario("threaded_faults")
def watchdog_fires_on_stalled_slot(P, tmp):
    sct = saxpy_tree(P)
    inj = P.FaultInjector(stall_on_call={"gpu0": [1]}, stall_seconds=1.0)
    ex = executor(P, injector=inj, policy=P.FaultPolicy(
        max_attempts=2, default_deadline=0.3))
    out, _ = ex.execute(sct, fault_part(P, sct), fault_arrays(),
                        make_profile(P, sct, 64))
    assert ex.last_failures and ex.last_failures[0].kind == "timeout"
    assert ex.last_retries == 1
    z = arr(out["z"])
    np.testing.assert_array_equal(z, 2.0 * fault_arrays()["x"] + 1.0)
    ex.close()
    return {"z": z, "kinds": [r.kind for r in ex.last_failures]}


@scenario("threaded_faults")
def deadline_derived_from_best_time(P, tmp):
    p = P.FaultPolicy(watchdog_multiple=8.0, min_deadline=0.25)
    got = [p.deadline(1.0), p.deadline(0.001), p.deadline(math.inf),
           P.FaultPolicy(default_deadline=2.0).deadline(math.inf)]
    assert got == [8.0, 0.25, None, 2.0]
    return got


@scenario("sim_faults")
def sim_crash_stall_and_total_loss(P, tmp):
    sct = saxpy_tree(P)

    def crash_run():
        inj = P.FaultInjector(crash_on_call={"gpu0": [1]})
        sim = P.SimulatedExecutor(sim_devices(P), seed=3, injector=inj)
        _, times = sim.execute(sct, fault_part(P, sct), fault_arrays(),
                               make_profile(P, sct, 64))
        return times, sim.last_retries, [r.kind for r in sim.last_failures]

    first, again = crash_run(), crash_run()
    assert first == again and first[1] == 1 and first[2] == ["crash"]
    inj = P.FaultInjector(stall_on_call={"gpu0": [1]}, stall_seconds=10.0)
    sim = P.SimulatedExecutor(sim_devices(P), injector=inj,
                              policy=P.FaultPolicy(default_deadline=1.0))
    _, times = sim.execute(sct, fault_part(P, sct), fault_arrays(),
                           make_profile(P, sct, 64))
    assert sim.last_failures[0].kind == "timeout"
    assert times[0] == pytest.approx(1.0)
    lost = P.SimulatedExecutor(sim_devices(P),
                               injector=P.FaultInjector(crash_prob=1.0))
    with pytest.raises(P.ExecutionError):
        lost.execute(sct, fault_part(P, sct), fault_arrays(),
                     make_profile(P, sct, 64))
    return {"crash": first, "stall_times": list(times)}


@scenario("scheduler_faults")
def scheduled_run_survives_accelerator_loss(P, tmp):
    sct = saxpy_tree(P)
    want = arr(make_scheduler(P, executor(P)).run(sct, fault_arrays())
               .outputs["z"])
    inj = P.FaultInjector(seed=7, crash_on_call={"gpu0": [1]})
    sched = make_scheduler(P, executor(P, injector=inj))
    run = sched.run(sct, fault_arrays())
    np.testing.assert_array_equal(arr(run.outputs["z"]), want)
    assert run.stats.retries >= 1 and not run.stats.ok
    assert run.stats.failures[0].device_base == "gpu0"
    out = run_obs(run)
    sched.close()
    return out


@scenario("scheduler_faults")
def quarantine_then_probation_then_reinstatement(P, tmp):
    sct = saxpy_tree(P)
    inj = P.FaultInjector(crash_on_call={"gpu0": [1, 2]})
    sched = make_scheduler(
        P, P.SimulatedExecutor(sim_devices(P), injector=inj),
        health=P.DeviceHealth(quarantine_after=2, probe_after=2))
    seen = []
    for _ in range(5):
        r = sched.run(sct, fault_arrays())
        seen.append((r.stats.ok, sched.health.is_quarantined("gpu0"),
                     any(s.device.startswith("gpu0")
                         for s in sched._last_slots)))
    assert seen == [(False, False, True), (False, True, True),
                    (True, True, False), (True, False, True),
                    (True, False, True)]
    return seen


@scenario("scheduler_faults")
def all_devices_quarantined_is_terminal(P, tmp):
    sct = saxpy_tree(P)
    sched = make_scheduler(
        P, P.SimulatedExecutor(sim_devices(P),
                               injector=P.FaultInjector(crash_prob=1.0),
                               policy=P.FaultPolicy(max_attempts=1)),
        health=P.DeviceHealth(quarantine_after=1, probe_after=100))
    with pytest.raises(P.ExecutionError):
        sched.run(sct, fault_arrays())
    with pytest.raises(P.ExecutionError, match="quarantined"):
        sched.run(sct, fault_arrays())
    return sorted(sched.health.quarantined())


@scenario("scheduler_faults")
def failed_runs_do_not_feed_balancer_or_kb(P, tmp):
    sct = saxpy_tree(P)
    inj = P.FaultInjector(crash_on_call={"gpu0": [1, 2, 3]})
    sched = make_scheduler(
        P, P.SimulatedExecutor(sim_devices(P), injector=inj),
        health=P.DeviceHealth(quarantine_after=99))
    oks = [sched.run(sct, fault_arrays()).stats.ok for _ in range(3)]
    assert oks == [False] * 3
    assert sched.balancer.lbt == 0.0 and sched.balancer.unbalanced_runs == 0
    stored = sched.kb.exact(sct.unique_id(), P.Workload((64,)))
    assert stored is not None and stored.best_time == math.inf
    return {"share_a": stored.share_a}


@scenario("scheduler_faults")
def per_class_makespans_recorded_on_stats(P, tmp):
    sched = make_scheduler(P, P.SimulatedExecutor(sim_devices(P)))
    run = sched.run(saxpy_tree(P), fault_arrays())
    n_a = sum(1 for s in sched._last_slots if s.device_type != "cpu")
    ta, tb = SUB[P]["lb"].class_times(run.stats.times, n_a)
    assert (run.stats.time_a, run.stats.time_b) == (ta, tb)
    assert ta > 0 and tb > 0
    return {"times": list(run.stats.times), "ta": ta, "tb": tb}


@scenario("balancer_faults")
def observe_ignores_failed_stats_and_kb_rejects_nan(P, tmp):
    lb = P.LoadBalancer()
    rec = P.FaultRecord(slot=0, device="gpu0/q0", device_type="gpu",
                        kind="crash", attempt=0)
    bad = P.ExecutionStats(times=[1.0, 0.1], share_a=0.5, failures=[rec])
    assert not any(lb.observe(bad) for _ in range(10)) and lb.lbt == 0.0
    good = P.ExecutionStats(times=[1.0, 0.1], share_a=0.5)
    triggered = [lb.observe(good) for _ in range(5)]
    assert any(triggered)
    with pytest.raises(ValueError):
        P.KnowledgeBase().store(P.Profile(
            sct_id="s", workload=P.Workload((8,)), share_a=0.5,
            config=P.PlatformConfig(), best_time=float("nan")))
    return {"triggered": triggered, "lbt": lb.lbt}


@scenario("session_faults")
def context_manager_and_retry_recovers(P, tmp):
    inj = P.FaultInjector(crash_on_call={"gpu0": [1]})
    sched = make_scheduler(P, executor(P, injector=inj,
                                       policy=P.FaultPolicy(max_attempts=1)))
    with P.Session(sched) as sess:
        out = sess.run(saxpy_tree(P), retries=2, **fault_arrays()).get(60)
    z = arr(out.outputs["z"])
    np.testing.assert_array_equal(z, 2.0 * fault_arrays()["x"] + 1.0)
    return {"z": z, "action": out.action}


@scenario("session_faults")
def future_reraises_with_device_identity(P, tmp):
    sched = make_scheduler(P, executor(
        P, injector=P.FaultInjector(crash_prob=1.0), policy=P.FaultPolicy()))
    with P.Session(sched) as sess:
        fut = sess.run(saxpy_tree(P), **fault_arrays())
        with pytest.raises(P.ExecutionError) as ei:
            fut.get(timeout=60)
    assert "gpu0" in str(ei.value) or "cpu0" in str(ei.value)
    assert ei.value.records
    return sorted((r.device, r.kind) for r in ei.value.records)


@scenario("session_faults")
def request_deadline(P, tmp):
    inj = P.FaultInjector(stall_on_call={"cpu0": [1]}, stall_seconds=1.0)
    sched = make_scheduler(P, executor(P, injector=inj, policy=P.FaultPolicy(
        max_attempts=1, default_deadline=None)))
    with P.Session(sched) as sess:
        fut = sess.run(saxpy_tree(P), deadline=0.4, **fault_arrays())
        with pytest.raises(P.ExecutionError, match="did not complete"):
            fut.get()
    return {}


@pytest.mark.parametrize("name", names("injector"))
def test_faults_injector(name, tmp_path):
    parity("injector", name, tmp_path)


@pytest.mark.parametrize("name", names("threaded_faults"))
def test_faults_threaded_executor(name, tmp_path):
    parity("threaded_faults", name, tmp_path)


@pytest.mark.parametrize("name", names("sim_faults"))
def test_faults_simulated_executor(name, tmp_path):
    parity("sim_faults", name, tmp_path)


@pytest.mark.parametrize("name", names("scheduler_faults"))
def test_faults_scheduler(name, tmp_path):
    parity("scheduler_faults", name, tmp_path)


@pytest.mark.parametrize("name", names("balancer_faults"))
def test_faults_balancer_isolation(name, tmp_path):
    parity("balancer_faults", name, tmp_path)


@pytest.mark.parametrize("name", names("session_faults"))
def test_faults_session(name, tmp_path):
    parity("session_faults", name, tmp_path)
