"""The port's gates, quickstart, FFT SCT and flash head-dim padding, on
the CPU.

- ``repro_torch.bench.{locality,pipeline,telemetry_smoke}`` at ``--smoke
  --device cpu``, into a temporary folder: every deterministic gate holds
  (the wall-clock gates are printed, not asserted), and the counters of
  locality and pipeline equal the JAX package's scripts' at the same
  sizes;
- ``repro_torch.examples.quickstart --device cpu`` ends ``quickstart OK``;
- ``suite.fft_sct`` against the JAX package's ``fft_sct`` at (4, 65536)
  float32 from seed 0, each through its own ``Scheduler`` on CPU slots
  under the same pinned profile: max |port - reference| <= 1e-5 x max
  |reference| (both compute in float32; the two differ by ~3e-7 of the
  max here), and against numpy's float64 FFT within the same bound;
- ``flash_attention.padded_call`` with the plain attention as ``launch``:
  at head dims the kernels are not instantiated for, the padded forward
  and its gradients (through a plain backward with the kernel's signature)
  equal the unpadded plain version within float32 rounding.
"""
import json
import math
import sys

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch import suite
from repro_torch.bench import locality, pipeline, telemetry_smoke
from repro_torch.examples import quickstart
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ref

torch.set_num_threads(1)

GATES = {"locality": locality, "pipeline": pipeline}


def run_main(module, argv):
    with pytest.raises(SystemExit) as ei:
        module.main(argv)
    return ei.value.code


@pytest.mark.parametrize("gate", ["locality", "pipeline"])
def test_gate_smoke_on_cpu(gate, tmp_path, capsys):
    """``--smoke --check --device cpu`` into tmp_path: every deterministic
    gate holds.  The script's own ``--check`` also applies the wall-clock
    gates, so its exit code is reported beside them, not asserted."""
    mod = GATES[gate]
    out = tmp_path / f"BENCH_{gate}_torch.json"
    code = run_main(mod, ["--smoke", "--check", "--device", "cpu",
                          "--out", str(out)])
    result = json.loads(out.read_text())
    assert result["device"] == "cpu" and result["smoke"] is True
    assert mod.deterministic_failures(result) == []
    wall = mod.wall_failures(result)
    assert code == (1 if wall else 0)
    print(f"{gate}: wall-clock gates {wall or 'held'}")


def reference_result(gate, tmp_path, monkeypatch):
    """The JAX package's script at ``--smoke`` (it reads ``sys.argv``)."""
    from benchmarks import locality as ref_locality
    from benchmarks import pipeline as ref_pipeline
    out = tmp_path / "ref.json"
    monkeypatch.setattr(sys, "argv", [f"{gate}.py", "--smoke", "--out",
                                      str(out)])
    {"locality": ref_locality, "pipeline": ref_pipeline}[gate].main()
    return json.loads(out.read_text())


def clock_free(gate, r):
    """A gate result's counters and gate values, without its clocks."""
    if gate == "locality":
        return {"gates": {k: r[k] for k in (
                    "plan_cache_hit_rate", "bit_identical",
                    "bit_identical_faulted", "faulted_retries")},
                "plan_cache": r["recurrent"]["plan_cache"],
                "pools": [r["recurrent"]["pools_created"],
                          r["recurrent"]["pool_reuses"]],
                "chain": [r["chain"]["resident_merge_bytes"],
                          r["chain"]["resident_steps_per_chain"]],
                "metrics": sorted(r["metrics"]["metrics"])}
    th = r["threaded"]
    return {"virtual": [r["virtual_throughput"], r["virtual_overlap"]],
            "threaded": [th["bit_identical"], th["bit_identical_faulted"],
                         th["node_retries"]],
            "graph_plan_cache": r["graph_plan_cache"],
            "fusion": r["fusion"]}


@pytest.mark.parametrize("gate", ["locality", "pipeline"])
def test_gate_counters_equal_the_reference_script(gate, tmp_path,
                                                  monkeypatch):
    """The reference script at the same smoke size: the same counters,
    virtual makespans, cache hits, lock counts, fused actions, retries
    and gate values."""
    want = reference_result(gate, tmp_path, monkeypatch)
    got = json.loads(json.dumps(GATES[gate].bench(True, want["n"], "cpu")))
    assert clock_free(gate, got) == clock_free(gate, want)


def test_telemetry_smoke_on_cpu(tmp_path, capsys):
    trace, res = tmp_path / "trace_torch.json", tmp_path / "tel.json"
    code = run_main(telemetry_smoke, ["--device", "cpu", "--out", str(trace),
                                      "--json", str(res)])
    result = json.loads(res.read_text())
    assert result["deterministic_failures"] == []
    assert code == (1 if result["wall_failures"] else 0)
    assert result["stats_retries"] >= 1 and result["retry_spans"] >= 1
    assert set(telemetry_smoke.REQUIRED_SPANS) <= set(result["span_names"])
    spans = telemetry_smoke.slot_spans(json.loads(trace.read_text()))
    # one faulted accelerator slot, then the retry; on the host no slot
    # carries device milliseconds
    assert sum(1 for s in spans if "fault" in s["args"]) == 1
    assert spans and all(s["us"] >= 0 and "device_ms" not in s["args"]
                         for s in spans)


def test_quickstart_on_cpu(capsys):
    quickstart.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "quickstart OK"
    assert lines[0] == "SCT: pipeline(kernel[scale],kernel[shift])"


# ---------------------------------------------------------------------------
# the FFT SCT
# ---------------------------------------------------------------------------

FFT_TOL = 1e-5          # max |err| <= FFT_TOL x max |reference|


def _fft_run(P, sct, x, share_a=0.5, **kw):
    host = P.HostPlatform(P.DeviceInfo("cpu0", "cpu", compute_units=4),
                          topology={"L2": 2, "NO_FISSION": 1})
    accel = P.AcceleratorPlatform([P.DeviceInfo("gpu0", "gpu")],
                                  max_overlap=2)
    sched = P.Scheduler(host=host, accel=accel,
                        executor=P.ThreadedExecutor(**kw),
                        kb=P.KnowledgeBase(),
                        balancer=P.LoadBalancer(max_dev=0.0))
    sched.kb.store(P.Profile(
        sct_id=sct.unique_id(), workload=P.Workload(x.shape),
        share_a=share_a, config=P.PlatformConfig(fission_level="L2"),
        best_time=math.inf))
    run = sched.run(sct, {"sig": x})
    out = np.array(run.outputs["sig_out"], copy=True)
    units = list(run.node_plan.part.units)
    sched.close()
    return out, units, run.action, [f.message for f in run.stats.failures]


@pytest.mark.parametrize("share_a", [0.5, 1.0],
                         ids=["hybrid", "host_slots_without_units"])
def test_fft_sct_matches_the_reference(share_a):
    """At share 1.0 the host slots get no units and run the bodies on
    empty slices, which must not fault (MKL's FFT refuses them)."""
    from benchmarks import paper_suite
    x = np.random.default_rng(0).standard_normal(
        (4, suite.FFT_ELEMS)).astype(np.float32)
    want, want_units, want_action, want_faults = _fft_run(
        R, paper_suite.fft_sct(), x, share_a)
    got, units, action, faults = _fft_run(T, suite.fft_sct(), x, share_a,
                                          device="cpu")
    assert (units, action, faults) == (want_units, want_action, want_faults)
    assert faults == [] and (0 in units) == (share_a == 1.0)
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.abs(got - want).max() <= FFT_TOL * np.abs(want).max()
    f64 = np.fft.ifft(np.fft.fft(x.astype(np.float64), axis=1).real,
                      axis=1).real
    assert np.abs(got - f64).max() <= FFT_TOL * np.abs(f64).max()
    assert suite.fft_sct().unique_id() == paper_suite.fft_sct().unique_id()
    assert suite.BENCHMARKS["fft"][1:] == paper_suite.BENCHMARKS["fft"][1:]
    assert suite.FFT_ELEMS == paper_suite.FFT_ELEMS == 65536
    for a, b in zip(suite.fft_sct().leaves(), paper_suite.fft_sct().leaves()):
        assert (a.spec.flops_per_item, a.spec.bytes_per_item) == \
            (b.spec.flops_per_item, b.spec.bytes_per_item)


# ---------------------------------------------------------------------------
# flash attention at head dims the kernels are not instantiated for
# ---------------------------------------------------------------------------

def plain_backward(q, k, v, o, do, lse, **kw):
    """The backward kernel's signature over the plain version's
    autograd."""
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    return torch.autograd.grad(ref.attention_ref(qs, ks, vs, **kw),
                               (qs, ks, vs), do)


@pytest.mark.parametrize("hd,padded", [(84, 128), (96, 128), (20, 32),
                                       (100, 128), (200, 256)])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=8, logit_cap=20.0),
                                dict(causal=False, scale=0.3)],
                         ids=["causal", "window_softcap", "scale"])
def test_flash_padding_keeps_the_numbers(hd, padded, kw):
    assert flash_mod.padded_dim(hd) == padded
    g = torch.Generator().manual_seed(hd)
    q, do = (torch.randn(2, 4, 33, hd, generator=g, dtype=torch.float32)
             for _ in range(2))
    k, v = (torch.randn(2, 2, 33, hd, generator=g, dtype=torch.float32)
            for _ in range(2))
    seen = []

    def launch(*args, **kws):
        seen.append((args[0].shape[-1], kws["scale"]))
        return ref.attention_ref(*args, **kws)

    got = flash_mod.padded_call(q, k, v, launch=launch, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    assert seen == [(padded, kw.get("scale", 1.0 / math.sqrt(hd)))]
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    o = want.detach()
    grads = flash_mod.padded_call(q, k, v, o, do, None,
                                  launch=plain_backward, **kw)
    wants = plain_backward(q, k, v, o, do, None, **kw)
    for g_, w_ in zip(grads, wants):
        assert g_.shape == w_.shape
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-6)


def test_flash_padding_passes_instantiated_dims_and_lse_through():
    q = torch.randn(1, 2, 5, 84)
    lse = torch.randn(1, 2, 5)
    calls = []

    def launch(*args, **kw):
        calls.append([tuple(t.shape) if t is not None else None
                      for t in args])
        return args[0], args[-1]

    o, back = flash_mod.padded_call(q, q[:, :1], q[:, :1], lse,
                                    launch=launch)
    assert calls == [[(1, 2, 5, 128), (1, 1, 5, 128), (1, 1, 5, 128),
                      (1, 2, 5)]]
    assert back is lse and torch.equal(o, q)
    for hd in flash_mod.HEAD_DIMS:
        t = torch.zeros(1, 1, 2, hd)
        assert flash_mod.padded_call(
            t, t, t, launch=lambda *a, **kw: a[0]) is t


@pytest.mark.parametrize("hd", [257, 320])
def test_flash_padding_refuses_dims_above_the_largest(hd):
    t = torch.zeros(1, 1, 2, hd)
    with pytest.raises(ValueError, match="above 256"):
        flash_mod.padded_call(t, t, t, launch=ref.attention_ref)
