"""The port's multi-card layer against the JAX package on four CPU ranks.

The reference runs in a subprocess on four forced host devices
(``tests/multirank_jax.py``: ``XLA_FLAGS`` must be set before JAX starts,
and ``tests/conftest.py`` keeps it out of this process), the port on four
gloo processes (``tests/multirank_torch.py``, ``file://`` rendezvous);
both from the same numpy inputs and parameters (``init_tree``'s scale
rules, drawn with numpy) in float32.
The cases, on the dry-run's shardings (``default_rules`` with FSDP, the
batch over ``data``):

  * the sharded MoE (granite's smoke config, (2, 2) mesh; the reference
    under ``moe_mesh``, the port whenever a layout is on):
    without drops (x (4, 8, 64), capacity factor 4) and with them (x (4,
    32, 64), capacity factor 0.5, where each data shard's capacity
    decides what drops): y, aux, and the gradients of sum(y r) + aux;
  * one training step of granite and gemma2 on (2, 2): loss, aux,
    gradient norm, updated parameters, and a prefill's logits;
  * sequence parallelism (``act_spec = P(dp, "model")``; the reference
    under ``attention_sp``, the port whenever the layout splits the
    sequence)
    at minicpm's smoke config on (2, 2) (heads split over the model axis)
    and with 6 heads on (1, 4) (heads replicated: each rank's queries
    against the whole sequence's keys);
  * gemma2 on (1, 4): 4 query heads split, its 2 kv heads replicated;
  * the int8 data-parallel step on two ranks against
    ``make_dp_train_step_int8`` on a 2-device host mesh.

Tolerances are ``tests/test_torch_train.py``'s, each for its reason there:
the loss rtol 1e-5, the gradient norm rtol 1e-4 (the reference's float32
gradients are ~1e-4 max |g| from exact), the int8 error feedback within 5%
of a quantisation step or one step apart on at most 1% of the elements.
Updated parameters: one AdamW step at eps 1e-3 (above the gradients'
float32 noise, as there), within 1e-5 of the reference (1% of the lr).
MoE outputs and gradients: 1e-5 of their largest magnitude (float32, the
expert products and the combine summed in another order).  Prefill
logits: 5e-5 of their largest unmasked magnitude (float32 through every
layer, in another order).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
from numpy.testing import assert_allclose

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORLD = 4
TRAIN = ("train_granite", "train_gemma2", "sp_minicpm", "sp_minicpm_6h",
         "gemma2_1x4")


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, env.get("PYTHONPATH")) if p)
    return env


#: the references, split over two subprocesses run side by side
JAX_GROUPS = (("moe_nodrop", "moe_drop", "train_granite", "sp_minicpm",
               "int8"),
              ("train_gemma2", "sp_minicpm_6h", "gemma2_1x4"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's (reference, port) results: the inputs written here
    (numpy), then the references and the port's four ranks side by side."""
    import multirank_jax
    d = str(tmp_path_factory.mktemp("multirank"))
    multirank_jax.write_inputs(d)
    assert sorted(sum(JAX_GROUPS, ())) == sorted(multirank_jax.CASES)
    jax_env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "multirank_jax.py"), d, *group],
        env=jax_env) for group in JAX_GROUPS]
    init = os.path.join(d, "pg")
    procs += [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "multirank_torch.py"), str(r),
         str(WORLD), d, init], env=_env(OMP_NUM_THREADS="1"))
        for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * len(procs), codes

    def load(name):
        return (np.load(os.path.join(d, f"{name}.npz")),
                np.load(os.path.join(d, f"{name}.port.npz")))
    return load


def _close(got, want, rel, what):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale + 1e-30, what


@pytest.mark.parametrize("case", ["moe_nodrop", "moe_drop"])
def test_sharded_moe_matches_the_reference(results, case):
    ref, port = results(case)
    _close(port["y"], ref["y"], 1e-5, "y")
    _close(port["gx"], ref["gx"], 1e-5, "dx")
    for k in ref.files:
        if k.startswith("grad/"):
            _close(port[k], ref[k], 1e-5, k)
    # the sharded aux: each data shard's, averaged, not the global batch's
    assert_allclose(port["aux"], ref["aux"], rtol=1e-6)
    assert abs(float(ref["aux"]) - float(ref["aux_local"])) > 1e-3
    # drops happen exactly in the case with drops (the no-drop oracle)
    dropped = np.abs(ref["y"] - ref["y_dense"]).max()
    assert (dropped > 1e-2) == (case == "moe_drop"), dropped


@pytest.mark.parametrize("case", TRAIN)
def test_sharded_train_step_matches_the_reference(results, case):
    ref, port = results(case)
    assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    assert_allclose(port["aux_loss"], ref["aux_loss"], rtol=1e-5,
                    atol=1e-7)
    assert_allclose(port["grad_norm"], ref["grad_norm"], rtol=1e-4)
    news = [k for k in ref.files if k.startswith("new/")]
    assert news and sorted(news) == sorted(
        k for k in port.files if k.startswith("new/"))
    for k in news:
        assert np.abs(port[k] - ref[k]).max() <= 1e-5, k


@pytest.mark.parametrize("case", TRAIN)
def test_sharded_prefill_matches_the_reference(results, case):
    ref, port = results(case)
    want, got = ref["prefill_logits"], port["prefill_logits"]
    live = want > -1e8                      # the padded vocabulary's -2^30
    assert np.array_equal(live, got > -1e8)
    _close(got[live], want[live], 5e-5, "logits")


def test_int8_dp_step_at_two_ranks_matches_the_reference(results):
    ref, port = results("int8")
    assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    assert_allclose(port["grad_norm"], ref["grad_norm"], rtol=1e-4)
    errs = [k for k in ref.files if k.startswith("error/")]
    assert errs
    for k in errs:
        w, got = ref[k], port[k]
        step_size = 2 * np.abs(w).max() + 1e-30    # |error| <= step / 2
        diff = np.abs(got - w)
        flipped = np.abs(diff - step_size) <= 0.05 * step_size
        assert np.all(flipped | (diff <= 0.05 * step_size)), k
        assert flipped.mean() <= 0.01, k
