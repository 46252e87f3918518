"""The port's checkpoint store: a bit-exact round trip of its train state,
checkpoints restored across the two packages in both directions (the same
on-disk layout and leaf names), keep-K garbage collection, corrupt and
partial directories skipped, one asynchronous save in flight.  Smoke
configs of both ported archs; parameters from ``repro.models.init_tree``
carried across by ``from_jax_params``.  Every comparison is equality."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke as jget_smoke
from repro.models import init_tree, model_defs
from repro.optim import AdamW as JAdamW
from repro.optim import AdamWConfig as JAdamWConfig
from repro.runtime import init_state as jinit_state
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    named_to_tree, save_pytree,
                                    state_from_tree, state_to_tree,
                                    tree_to_named)
from repro_torch.data import DataConfig, batch_at
from repro_torch.models import LM, from_jax_params
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import RuntimeConfig, init_state, make_train_step

torch.set_num_threads(1)

ARCHS = ("zamba2-2.7b", "granite-moe-3b-a800m", "mamba2-1.3b", "minicpm-2b",
         "gemma2-2b", "nemotron-4-15b", "internvl2-26b",
         "command-r-plus-104b", "mixtral-8x22b")


def flat(tree, prefix=""):
    """{path: numpy array} of a checkpoint tree (dicts and named tuples,
    None holding nothing), bfloat16 as its bits."""
    out = {}
    if tree is None:
        return out
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(flat(getattr(tree, f), f"{prefix}.{f}/"))
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        a = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    else:
        a = np.asarray(tree)
        if a.dtype.name == "bfloat16":
            a = a.view(np.int16)
    out[prefix.rstrip("/")] = a
    return out


def assert_same(got, want):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].shape == w[k].shape, k
        assert np.array_equal(g[k], w[k]), k


def trained_state(arch, dtype=torch.bfloat16, compress=True, steps=1):
    """A port train state of the smoke model after ``steps`` steps (so the
    moments and the error feedback are not zero)."""
    cfg = configs.get_smoke(arch)
    model = LM(cfg, dtype=dtype,
               generator=torch.Generator().manual_seed(0))
    opt = AdamW(AdamWConfig(lr=1e-3))
    state = init_state(model, opt, compress=compress)
    step = make_train_step(cfg, opt, RuntimeConfig(remat=None))
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2)
    for i in range(steps):
        state, _ = step(state, batch_at(dc, i))
    return state


def fresh_state(arch, dtype=torch.bfloat16, compress=True):
    cfg = configs.get_smoke(arch)
    model = LM(cfg, dtype=dtype, generator=torch.Generator().manual_seed(9))
    return init_state(model, AdamW(AdamWConfig()), compress=compress)


@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_is_bit_exact(arch, tmp_path):
    state = trained_state(arch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state_to_tree(state), payload={"data_step": 1})
    mgr.wait()
    other = fresh_state(arch)
    tree, meta = mgr.restore_latest(state_to_tree(other))
    assert meta.step == 1 and meta.payload == {"data_step": 1}
    restored = state_from_tree(other, tree)
    assert int(restored.opt.step) == 1
    assert_same(state_to_tree(restored), state_to_tree(state))
    assert next(restored.params.parameters()).dtype == torch.bfloat16


def test_named_to_tree_is_the_jax_layout_and_inverts():
    for arch in ARCHS:
        cfg = jget_smoke(arch)
        jparams = jax.device_get(init_tree(jax.random.PRNGKey(0),
                                           model_defs(cfg),
                                           dtype=jnp.float32))
        model = from_jax_params(configs.get_smoke(arch), jparams)
        named = dict(model.named_parameters())
        assert_same(named_to_tree(named), jparams)
        back = tree_to_named(jparams, named)
        assert all(torch.equal(back[k], v) for k, v in named.items())


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_restores_a_port_checkpoint(arch, tmp_path):
    cfg = jget_smoke(arch)
    jparams = init_tree(jax.random.PRNGKey(0), model_defs(cfg),
                        dtype=jnp.bfloat16)
    state = trained_state(arch)
    CheckpointManager(str(tmp_path)).save(3, state_to_tree(state),
                                          blocking=True)
    like = jax.device_get(jinit_state(jparams, JAdamW(JAdamWConfig()),
                                      compress=True))
    tree, meta = JCheckpointManager(str(tmp_path)).restore_latest(like)
    assert meta.step == 3
    assert_same(tree, state_to_tree(state))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_restores_a_jax_checkpoint(arch, tmp_path):
    cfg = jget_smoke(arch)
    jparams = init_tree(jax.random.PRNGKey(4), model_defs(cfg),
                        dtype=jnp.bfloat16)
    jstate = jinit_state(jparams, JAdamW(JAdamWConfig()), compress=True)
    rng = np.random.default_rng(0)
    noisy = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape), a.dtype), jstate)     # m, v, error not 0
    noisy = noisy._replace(opt=noisy.opt._replace(
        step=jnp.asarray(7, jnp.int32)))
    JCheckpointManager(str(tmp_path)).save(7, noisy, payload={"a": 1},
                                           blocking=True)
    state = fresh_state(arch)
    tree, meta = CheckpointManager(str(tmp_path)).restore_latest(
        state_to_tree(state))
    assert meta.step == 7 and meta.payload == {"a": 1}
    restored = state_from_tree(state, tree)
    assert int(restored.opt.step) == 7
    assert_same(state_to_tree(restored), jax.device_get(noisy))


def test_keep_k_and_async_saves(tmp_path):
    state = fresh_state("granite-moe-3b-a800m", compress=False)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 6):
        mgr.save(s, state_to_tree(state))        # asynchronous
    mgr.wait()
    assert mgr.steps() == [4, 5]
    assert sorted(os.listdir(tmp_path)) == ["step_000000000004",
                                            "step_000000000005"]
    assert JCheckpointManager(str(tmp_path), keep=2).steps() == [4, 5]


def test_corrupt_and_partial_directories_are_skipped(tmp_path):
    """What the reference skips (``restore_latest`` catches KeyError,
    ValueError, OSError and JSONDecodeError): a manifest that does not
    parse, a committed step without its arrays, a step without its commit
    marker."""
    good = trained_state("granite-moe-3b-a800m", compress=False)
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (1, 2, 3):
        mgr.save(s, state_to_tree(good), blocking=True)
    (tmp_path / "step_000000000003" / "meta.json").write_text("{not json")
    os.remove(tmp_path / "step_000000000002" / "proc00000" / "arrays.npz")
    os.makedirs(tmp_path / "step_000000000004" / "proc00000")
    assert mgr.steps() == [1, 2, 3]
    other = fresh_state("granite-moe-3b-a800m", compress=False)
    tree, meta = mgr.restore_latest(state_to_tree(other))
    assert meta.step == 1
    assert_same(state_to_tree(state_from_tree(other, tree)),
                state_to_tree(good))
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest(state_to_tree(other)) is None


def test_save_load_pytree_checks_shapes_and_leaves(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    save_pytree(tree, str(tmp_path))
    back = load_pytree(str(tmp_path), tree)
    assert_same(back, tree)
    with pytest.raises(ValueError, match="shape"):
        load_pytree(str(tmp_path), {"a": torch.zeros(3, 2),
                                    "b": {"c": torch.zeros(4)}})
    with pytest.raises(KeyError, match="missing"):
        load_pytree(str(tmp_path), {"x": torch.zeros(1)})
