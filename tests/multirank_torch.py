"""The port's side of ``test_torch_multirank.py``: four gloo ranks (one
process each, ``file://`` rendezvous) run every case of
``multirank_jax.py`` from the inputs it wrote (``<case>.in.npz``), and
rank 0 writes the port's results as ``<case>.port.npz``.  Imports no JAX.

    python tests/multirank_torch.py RANK WORLD DIR INIT_FILE
"""
import dataclasses
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke
from repro_torch.models import from_jax_params
from repro_torch.models import spmd
from repro_torch.models.layers import Params, place_params
from repro_torch.models.lm import init_cache, prefill
from repro_torch.models.moe import moe_defs, moe_ffn
from repro_torch.models.sharding import P, default_rules
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.runtime import (RuntimeConfig, init_state,
                                 make_dp_train_step_int8, make_train_step)

LR, EPS = 1e-3, 1e-3
SP6 = dict(n_heads=6, n_kv_heads=6, head_dim=16)


def unflat(d, prefix):
    """The nested dict of the "prefix/a/b" entries of an npz."""
    out = {}
    for k in d.files:
        if not k.startswith(prefix):
            continue
        node = out
        parts = k[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = d[k]
    return out


def named(model):
    """The port's parameters by their JAX path, stacked over the layers
    where the JAX package stacks them."""
    from repro_torch.checkpoint import named_to_tree
    full = {k: (v.full_tensor() if spmd.is_sharded(v) else v).detach()
            for k, v in model.named_parameters()}
    return flat_tree(named_to_tree(full))


def flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_tree(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def mesh_of(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def placed(t, mesh, rules, logical):
    from repro_torch.launch.dryrun import _placed
    return _placed(t, logical, mesh, rules)


def moe_case(ref, mesh):
    cfg = get_smoke("granite-moe-3b-a800m")
    cf = float(ref["capacity_factor"])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    p = Params(moe_defs(cfg), dtype=torch.float32)
    tree = unflat(ref, "param/")
    with torch.no_grad():
        for k, v in tree.items():
            p[k].copy_(torch.from_numpy(v))
    place_params(p, mesh, default_rules(mesh, fsdp=True))
    for q in p.parameters():
        q.requires_grad_(True)
    x_full = torch.from_numpy(ref["x"])
    x = placed(x_full, mesh, default_rules(mesh), ("batch", None, None))
    L = spmd.layout_for(x)
    xl = x.to_local().clone().requires_grad_(True)
    r = placed(torch.from_numpy(ref["r"]), mesh, default_rules(mesh),
               ("batch", None, None)).to_local()
    with spmd.on_layout(L):
        y, aux = moe_ffn(xl, p, cfg)
        obj = L.reduce_dp((y * r).sum()) + aux
    names = [k for k, _ in p.named_parameters()]
    grads = torch.autograd.grad(obj, [xl] + [p[k] for k in names])
    out = {"y": spmd.all_gather(y.detach(), mesh, "data", 0),
           "aux": aux.detach(),
           "gx": spmd.all_gather(grads[0], mesh, "data", 0)}
    for k, g in zip(names, grads[1:]):
        if spmd.is_sharded(g) and g.placements != p[k].placements:
            g = g.redistribute(mesh, p[k].placements)
        out[f"grad/{k}"] = g.full_tensor()
    return out


def train_case(ref, mesh, arch, *, act_seq_shard=False, **changes):
    cfg = get_smoke(arch)
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    rules = default_rules(mesh, fsdp=True, seq_shard=False)
    act_spec = P(("data",), "model") if act_seq_shard else P(("data",))
    model = from_jax_params(cfg, unflat(ref, "param/"))
    place_params(model, mesh, rules)
    tokens = torch.from_numpy(ref["tokens"]).long()
    labels = torch.from_numpy(ref["labels"]).long()
    tk = placed(tokens, mesh, rules, ("batch", None))
    lb = placed(labels, mesh, rules, ("batch", None))
    out = {}
    with torch.no_grad():
        cache = init_cache(cfg, tokens.shape[0], tokens.shape[1],
                           mesh=mesh, rules=rules)
        logits, _ = prefill(model, tk, capacity=tokens.shape[1],
                            act_spec=act_spec, cache=cache)
    out["prefill_logits"] = logits.full_tensor()
    opt = AdamW(AdamWConfig(lr=LR, eps=EPS))
    rt = RuntimeConfig(microbatches=1, remat=None, loss_chunks=1,
                       data_axes=("data",), act_spec=act_spec)
    state = init_state(model, opt)
    state, m = make_train_step(cfg, opt, rt)(
        state, {"tokens": tk, "labels": lb})
    out.update({k: m[k] for k in ("loss", "aux_loss", "grad_norm")})
    out.update({f"new/{k}": v for k, v in named(model).items()})
    return out


def int8_case(ref, group):
    cfg = get_smoke("granite-moe-3b-a800m")
    model = from_jax_params(cfg, unflat(ref, "param/"))
    opt = AdamW(AdamWConfig(lr=LR))
    state = init_state(model, opt, compress=True)
    step = make_dp_train_step_int8(cfg, opt, RuntimeConfig(remat=None),
                                   group=group)
    state, m = step(state, {"tokens": torch.from_numpy(ref["tokens"]).long(),
                            "labels": torch.from_numpy(ref["labels"]).long()})
    out = {"loss": m["loss"], "grad_norm": m["grad_norm"]}
    from repro_torch.checkpoint import named_to_tree
    out.update({f"error/{k}": v for k, v in flat_tree(named_to_tree(
        state.compression.error)).items()})
    return out


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def worker(rank, world, ref_dir, out_dir, init_file):
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    torch.manual_seed(0)
    try:
        m22, m14 = mesh_of((2, 2)), mesh_of((1, 4))
        pair = dist.new_group([0, 1])

        def load(name):
            return np.load(os.path.join(ref_dir, f"{name}.in.npz"))

        cases = {
            "moe_nodrop": lambda: moe_case(load("moe_nodrop"), m22),
            "moe_drop": lambda: moe_case(load("moe_drop"), m22),
            "train_granite": lambda: train_case(
                load("train_granite"), m22, "granite-moe-3b-a800m"),
            "train_gemma2": lambda: train_case(load("train_gemma2"), m22,
                                               "gemma2-2b"),
            "sp_minicpm": lambda: train_case(load("sp_minicpm"), m22,
                                             "minicpm-2b",
                                             act_seq_shard=True),
            "sp_minicpm_6h": lambda: train_case(
                load("sp_minicpm_6h"), m14, "minicpm-2b", act_seq_shard=True,
                **SP6),
            "gemma2_1x4": lambda: train_case(load("gemma2_1x4"), m14,
                                             "gemma2-2b"),
        }
        for name, run in cases.items():
            res = run()
            if rank == 0:
                np.savez(os.path.join(out_dir, f"{name}.port.npz"),
                         **{k: _np(v) for k, v in res.items()})
        if rank < 2:
            res = int8_case(load("int8"), pair)
            if rank == 0:
                np.savez(os.path.join(out_dir, "int8.port.npz"),
                         **{k: _np(v) for k, v in res.items()})
        dist.barrier()
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import sys
    r, w, d, init = sys.argv[1:5]
    worker(int(r), int(w), d, d, init)
