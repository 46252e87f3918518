"""The JAX package's side of ``test_torch_multirank.py``.

    python tests/multirank_jax.py DIR CASE...   # <case>.npz: the results

runs each case's reference from ``DIR/<case>.in.npz`` on four forced host
devices: the caller sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
before JAX starts (the pytest process must not).  ``write_inputs(DIR)``
(numpy only, no device) writes every case's inputs first — tokens and
activations from numpy seeds, parameters drawn by ``init_tree``'s scale
rules with numpy — so that the port's ranks and the references start from
the same numbers at once.  The meshes and shardings are the dry-run's
(``default_rules``, ``sharding_tree``, ``act_spec``, ``moe_mesh``,
``attention_sp``), the steps jitted with them as ``run_cell`` jits.
"""
import contextlib
import dataclasses
import os
import sys

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_smoke
from repro.models import model_defs
from repro.models.layers import ParamDef
from repro.models.attention import attention_sp
from repro.models.lm import prefill
from repro.models.moe import (_moe_ffn_local, moe_defs, moe_ffn,
                              moe_ffn_dense, moe_mesh)
from repro.models.sharding import default_rules, sharding_for
from repro.models.layers import sharding_tree
from repro.optim import AdamW, AdamWConfig
from repro.runtime import (RuntimeConfig, TrainState, init_state,
                           make_dp_train_step_int8, make_train_step)

B, S = 4, 16
LR, EPS = 1e-3, 1e-3


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def mesh_of(shape):
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return jax.sharding.Mesh(devs, ("data", "model"))


def config(arch, **changes):
    cfg = get_smoke(arch)
    return dataclasses.replace(cfg, **changes) if changes else cfg


def data(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return tokens, labels


def init_np(defs, seed):
    """Parameters of a ParamDef tree by ``init_tree``'s rules (scale 0:
    zeros, -1: ones, else a normal of std scale / sqrt(fan_in)), drawn
    with numpy in float32, flattened by path."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, d in sorted(flat_defs(defs).items()):
        if d.scale == 0.0:
            out[key] = np.zeros(d.shape, np.float32)
        elif d.scale == -1.0:
            out[key] = np.ones(d.shape, np.float32)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            out[key] = (rng.standard_normal(d.shape) * d.scale
                        / np.sqrt(max(fan_in, 1))).astype(np.float32)
    return out


def flat_defs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, ParamDef):
            out[prefix + k] = v
        else:
            out.update(flat_defs(v, prefix + k + "/"))
    return out


def moe_inputs(capacity_factor, seq, seed=0):
    cfg = get_smoke("granite-moe-3b-a800m")
    rng = np.random.default_rng(seed)
    out = {"x": rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32),
           "r": rng.standard_normal((B, seq, cfg.d_model)).astype(np.float32),
           "capacity_factor": np.asarray(capacity_factor)}
    out.update({f"param/{k}": v for k, v in
                init_np(moe_defs(cfg), seed + 1).items()})
    return out


def moe_case(inp):
    cfg = get_smoke("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(inp["capacity_factor"])))
    p = jax.tree.map(jnp.asarray, unflat(inp, "param/"))
    x, r = jnp.asarray(inp["x"]), jnp.asarray(inp["r"])
    mesh = mesh_of((2, 2))

    def obj(x, p):
        y, aux = moe_ffn(x, p, cfg)
        return jnp.sum(y * r) + aux, (y, aux)

    with mesh, moe_mesh(mesh, ("data",), "model"):
        (_, (y, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
            obj, argnums=(0, 1), has_aux=True))(x, p)
    _, auxl = jax.jit(lambda x, p: _moe_ffn_local(x, p, cfg))(x, p)
    yd, _ = jax.jit(lambda x, p: moe_ffn_dense(x, p, cfg))(x, p)
    out = {"y": np.asarray(y), "aux": np.asarray(aux),
           "aux_local": np.asarray(auxl), "y_dense": np.asarray(yd),
           "gx": np.asarray(gx)}
    out.update({f"grad/{k}": v for k, v in flat(gp).items()})
    return out


def train_inputs(arch, seed=0, **changes):
    cfg = config(arch, **changes)
    tokens, labels = data(cfg, seed + 1)
    out = {"tokens": tokens, "labels": labels}
    out.update({f"param/{k}": v for k, v in
                init_np(model_defs(cfg), seed).items()})
    return out


def train_case(inp, arch, mesh_shape, *, act_seq_shard=False, **changes):
    """One train step and a prefill under the dry-run's shardings."""
    cfg = config(arch, **changes)
    mesh = mesh_of(mesh_shape)
    rules = default_rules(mesh, fsdp=True, seq_shard=False)
    defs = model_defs(cfg)
    params = jax.tree.map(jnp.asarray, unflat(inp, "param/"))
    pshard = sharding_tree(defs, mesh, rules)
    dp = ("data",)
    act_spec = P(dp, "model") if act_seq_shard else P(dp)
    rt = RuntimeConfig(microbatches=1, remat=None, loss_chunks=1,
                       data_axes=dp, act_spec=act_spec)
    opt = AdamW(AdamWConfig(lr=LR, eps=EPS))
    state = init_state(params, opt)
    rep = NamedSharding(mesh, P())
    sshard = TrainState(params=pshard,
                        opt=type(state.opt)(step=rep, m=pshard, v=pshard),
                        compression=None)
    bs = sharding_for((B, S), ("batch", None), mesh, rules)
    batch = {"tokens": jax.device_put(inp["tokens"], bs),
             "labels": jax.device_put(inp["labels"], bs)}
    ctx = contextlib.ExitStack()
    ctx.enter_context(mesh)
    if cfg.moe is not None:
        ctx.enter_context(moe_mesh(mesh, dp, "model"))
    if act_seq_shard:
        ctx.enter_context(attention_sp("model"))
    out = {}
    with ctx:
        logits, _ = jax.jit(
            lambda p, t: prefill(p, cfg, t, capacity=S, act_spec=act_spec),
            in_shardings=(pshard, bs))(params, batch["tokens"])
        out["prefill_logits"] = np.asarray(logits)
        step = jax.jit(make_train_step(cfg, opt, rt),
                       in_shardings=(sshard, {k: bs for k in batch}),
                       out_shardings=(sshard, None))
        state, m = step(jax.device_put(state, sshard), batch)
    out.update({"loss": np.asarray(m["loss"]),
                "aux_loss": np.asarray(m["aux_loss"]),
                "grad_norm": np.asarray(m["grad_norm"])})
    out.update({f"new/{k}": v for k, v in
                flat(jax.device_get(state.params)).items()})
    return out


def int8_case(inp):
    """The int8 data-parallel step on a 2-device host mesh."""
    cfg = get_smoke("granite-moe-3b-a800m")
    params = jax.tree.map(jnp.asarray, unflat(inp, "param/"))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    opt = AdamW(AdamWConfig(lr=LR))
    step = jax.jit(make_dp_train_step_int8(cfg, opt,
                                           RuntimeConfig(remat=None), mesh))
    state = init_state(params, opt, compress=True)
    state, m = step(state, {"tokens": jnp.asarray(inp["tokens"]),
                            "labels": jnp.asarray(inp["labels"])})
    out = {"loss": np.asarray(m["loss"]),
           "grad_norm": np.asarray(m["grad_norm"])}
    out.update({f"error/{k}": v for k, v in
                flat(jax.device_get(state.compression.error)).items()})
    return out


def unflat(d, prefix):
    """The nested dict of the "prefix/a/b" entries of an npz."""
    out = {}
    for k in d.files:
        if k.startswith(prefix):
            node = out
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = d[k]
    return out


SP6 = dict(n_heads=6, n_kv_heads=6, head_dim=16)

#: case -> (its inputs, its reference from them)
CASES = {
    "moe_nodrop": (lambda: moe_inputs(4.0, 8), moe_case),
    "moe_drop": (lambda: moe_inputs(0.5, 32), moe_case),
    "train_granite": (lambda: train_inputs("granite-moe-3b-a800m"),
                      lambda i: train_case(i, "granite-moe-3b-a800m",
                                           (2, 2))),
    "train_gemma2": (lambda: train_inputs("gemma2-2b"),
                     lambda i: train_case(i, "gemma2-2b", (2, 2))),
    "sp_minicpm": (lambda: train_inputs("minicpm-2b"),
                   lambda i: train_case(i, "minicpm-2b", (2, 2),
                                        act_seq_shard=True)),
    "sp_minicpm_6h": (lambda: train_inputs("minicpm-2b", **SP6),
                      lambda i: train_case(i, "minicpm-2b", (1, 4),
                                           act_seq_shard=True, **SP6)),
    "gemma2_1x4": (lambda: train_inputs("gemma2-2b"),
                   lambda i: train_case(i, "gemma2-2b", (1, 4))),
    "int8": (lambda: train_inputs("granite-moe-3b-a800m"), int8_case),
}


def write_inputs(out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name, (make, _) in CASES.items():
        np.savez(os.path.join(out_dir, f"{name}.in.npz"), **make())


def main(out_dir: str, names) -> int:
    assert len(jax.devices()) >= 4, jax.devices()
    for name in names:
        inp = np.load(os.path.join(out_dir, f"{name}.in.npz"))
        np.savez(os.path.join(out_dir, f"{name}.npz"), **CASES[name][1](inp))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1], sys.argv[2:]))
