"""The port's logical-axis rules against the JAX package's (pure
functions, no devices): ``spec_for`` and ``default_rules`` for every
parameter and cache definition of the ten archs (full size) at the
dry-run's meshes, quad_2x2, pod_32x8 and multipod_2x32x8, with ``fsdp``
and ``seq_shard`` each on and off — equal entry for entry; every spec's
DTensor placements turned back into the spec; the meshes' shapes; and
``DecompositionPlan.shardings`` against the reference's on a 1-device mesh
in this process and on four forced host devices in a subprocess, the
indivisible domain's ``DecompositionError`` included.  Exact equality
throughout: the functions are the same integer arithmetic.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import arch_names, get_config as jget_config
from repro.core import Pipeline as JPipeline
from repro.core import build_plan as jbuild_plan
from repro.core import kernel as jkernel
from repro.core import vector as jvector
from repro.launch import mesh as jmesh
from repro.models import model_defs as jmodel_defs
from repro.models.layers import ParamDef as JParamDef
from repro.models.lm import cache_defs as jcache_defs
from repro.models.sharding import default_rules as jdefault_rules
from repro.models.sharding import spec_for as jspec_for
from repro_torch.configs import get_config
from repro_torch.core import DecompositionError, Pipeline, build_plan
from repro_torch.core import kernel, vector
from repro_torch.launch import mesh as tmesh
from repro_torch.models import LM
from repro_torch.models.layers import param_logical
from repro_torch.models.lm import cache_param_defs
from repro_torch.models.sharding import (P, default_rules, placements_for,
                                         spec_for, spec_of)

MESHES = ("quad_2x2", "pod_32x8", "multipod_2x32x8")
KNOBS = [(f, s) for f in (False, True) for s in (False, True)]
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


class FakeMesh:
    """Duck-typed mesh: the reference's spec_for reads only .shape."""

    def __init__(self, **axes):
        self.shape = dict(axes)


def _jleaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, JParamDef):
            yield prefix + k, v
        else:
            yield from _jleaves(v, prefix + k + "/")


def _port_defs(arch):
    """(JAX path, shape, logical) of every port parameter, one per
    stacked leaf (the port's per-layer parameter with the reference's
    leading layer dims)."""
    from repro_torch.optim.adamw import split_name
    cfg = get_config(arch)
    model = LM(cfg, device="meta")
    logical = param_logical(model)
    out = {}
    for name, p in model.named_parameters():
        path, index = split_name(name)
        key = "/".join(path)
        lead = len(index)
        out.setdefault(key, (lead, tuple(p.shape), logical[name]))
    return out


@pytest.mark.parametrize("arch", arch_names())
def test_param_and_cache_specs_equal_the_reference(arch):
    jcfg = jget_config(arch)
    jdefs = dict(_jleaves(jmodel_defs(jcfg)))
    tdefs = _port_defs(arch)
    assert sorted(jdefs) == sorted(tdefs)
    jcache = jcache_defs(jcfg, 128, 32768)
    tcache = cache_param_defs(get_config(arch), 128, 32768)
    assert sorted(jcache) == sorted(tcache)
    n = 0
    for name in MESHES:
        jm = FakeMesh(**tmesh.MeshShape.named(name).shape)
        tm = tmesh.MeshShape.named(name)
        for fsdp, seq in KNOBS:
            jr = jdefault_rules(jm, fsdp=fsdp, seq_shard=seq)
            tr = default_rules(tm, fsdp=fsdp, seq_shard=seq)
            assert {k: tuple(v) for k, v in jr.table.items()} == tr.table
            for key, d in jdefs.items():
                lead, shape, logical = tdefs[key]
                # the port holds one layer: the reference's stacked dims
                # are unsharded (None) and lead the shape
                assert tuple(d.shape[lead:]) == shape, key
                assert tuple(d.logical) == (None,) * lead + logical, key
                want = tuple(jspec_for(d.shape, d.logical, jm, jr))
                got = spec_for(d.shape, (None,) * lead + logical, tm, tr)
                assert got == want, (name, fsdp, seq, key)
                n += 1
            for key, d in jcache.items():
                td = tcache[key]
                assert (td.shape, td.logical) == (d.shape, d.logical), key
                want = tuple(jspec_for(d.shape, d.logical, jm, jr))
                assert spec_for(td.shape, td.logical, tm, tr) == want, key
                n += 1
    assert n > 0


def test_spec_for_rules_on_their_own():
    """The reference's own unit cases (tests/test_sharding.py)."""
    from repro_torch.models.sharding import Rules
    rules = Rules(table={"batch": (("pod", "data"),),
                         "embed": (("pod", "data"),), "heads": ("model",),
                         "vocab": ("model",), "mlp": ("model",)})
    m = tmesh.MeshShape(pod=2, data=16, model=16)
    assert spec_for((256, 4096), ("batch", None), m, rules) == P(
        ("pod", "data"))
    assert spec_for((49155, 64), ("vocab", None), m, rules) == P()
    assert spec_for((64, 32), ("heads", "mlp"), m, rules) == P("model")
    assert spec_for((8, 8), ("nope", None), tmesh.MeshShape(data=4, model=2),
                    rules) == P()
    with pytest.raises(ValueError, match="rank mismatch"):
        spec_for((8,), ("batch", None), m, rules)


@pytest.mark.parametrize("name", MESHES)
def test_placements_round_trip(name):
    from torch.distributed.tensor import Replicate, Shard
    m = tmesh.MeshShape.named(name)
    specs = set()
    for arch in arch_names():
        for _, shape, logical in _port_defs(arch).values():
            for fsdp, seq in KNOBS:
                specs.add((len(shape), spec_for(
                    shape, logical, m, default_rules(
                        m, fsdp=fsdp, seq_shard=seq))))
    assert len(specs) > 5
    for ndim, spec in specs:
        pl = placements_for(spec, m)
        assert len(pl) == len(m.shape)
        assert all(isinstance(p, (Shard, Replicate)) for p in pl)
        assert spec_of(pl, m, ndim) == spec


def test_meshes_have_the_reference_chip_counts():
    assert tmesh.mesh_chips(tmesh.MeshShape.named("pod_32x8")) == 256
    assert tmesh.mesh_chips(tmesh.MeshShape.named("multipod_2x32x8")) == 512
    assert tmesh.mesh_chips(tmesh.MeshShape.named("quad_2x2")) == 4
    assert np.prod(jmesh.SINGLE_POD) == 256
    assert np.prod(jmesh.MULTI_POD) == 512
    assert tmesh.MULTIPOD_AXES == jmesh.MULTI_POD_AXES
    assert tmesh.POD_AXES == jmesh.SINGLE_POD_AXES
    for name in MESHES:
        m = tmesh.MeshShape.named(name)
        assert tmesh.dp_axes(m) == jmesh.dp_axes(FakeMesh(**m.shape))


# ---------------------------------------------------------------------------
# DecompositionPlan.shardings
# ---------------------------------------------------------------------------

def _pipeline(mod_kernel, mod_vector, mod_pipeline, dim):
    k1 = mod_kernel(lambda x: x, name="k1",
                    inputs=[mod_vector("x", epu=4, partition_dim=dim)],
                    outputs=[mod_vector("mid", epu=4, partition_dim=dim)])
    k2 = mod_kernel(lambda m, w: m, name="k2",
                    inputs=[mod_vector("mid", epu=4, partition_dim=dim),
                            mod_vector("w", copy=True)],
                    outputs=[mod_vector("y", epu=4, partition_dim=dim)])
    return mod_pipeline(k1, k2)


def _shapes(extent, dim):
    shp = (extent,) if dim == 0 else (3, extent)
    return {"x": shp, "mid": shp, "y": shp, "w": (10,)}


PLANS = [(64, 0), (64, 1), (40, 0)]        # 16, 16 and 10 domain units


def _port_specs(extent, dim, n):
    plan = build_plan(_pipeline(kernel, vector, Pipeline, dim),
                      _shapes(extent, dim))
    try:
        out = plan.shardings(tmesh.MeshShape(data=n),
                             extra={"w": P("data")} if n == 1 else None)
    except DecompositionError as e:
        return "error", str(e)
    return {k: list(v.spec) for k, v in out.items()}


def test_decomposition_shardings_at_data_1_match_the_reference():
    from jax.sharding import PartitionSpec as JP
    mesh = jax.make_mesh((1,), ("data",))
    for extent, dim in PLANS:
        plan = jbuild_plan(_pipeline(jkernel, jvector, JPipeline, dim),
                           _shapes(extent, dim))
        want = {k: list(v.spec) for k, v in plan.shardings(
            mesh, extra={"w": JP("data")}).items()}
        assert _port_specs(extent, dim, 1) == want


_SUBPROCESS = r"""
import json, sys
import jax
sys.path.insert(0, sys.argv[1])
from test_torch_sharding import PLANS, _pipeline, _shapes
from repro.core import DecompositionError, Pipeline, build_plan, kernel, vector
mesh = jax.make_mesh((4,), ("data",))
out = []
for extent, dim in PLANS:
    plan = build_plan(_pipeline(kernel, vector, Pipeline, dim),
                      _shapes(extent, dim))
    try:
        out.append({k: list(v.spec) for k, v in plan.shardings(mesh).items()})
    except DecompositionError as e:
        out.append(["error", str(e)])
print(json.dumps(out))
"""


def test_decomposition_shardings_at_data_4_match_the_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, env.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-c", _SUBPROCESS, HERE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    got = [_port_specs(extent, dim, 4) for extent, dim in PLANS]
    assert [list(g) if isinstance(g, tuple) else g for g in got] == want
    assert want[2][0] == "error"           # 10 units over 4 ranks


def test_decomposition_shardings_give_dtensor_placements():
    """On a DeviceMesh of a fake process group of four ranks."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        plan = build_plan(_pipeline(kernel, vector, Pipeline, 1),
                          _shapes(64, 1))
        sh = plan.shardings(mesh)
        assert sh["x"].placements == [Shard(1)]
        assert sh["w"].placements == [Replicate()]
    assert not dist.is_initialized()


def test_sharding_and_shape_trees_of_a_block():
    """``sharding_tree`` and ``shape_tree`` over a nested ParamDef tree (an
    attention block of gemma2 at pod_32x8, FSDP on): the reference's spec
    of every leaf, and a meta tensor of its shape."""
    import torch
    from repro_torch.models.layers import shape_tree, sharding_tree
    from repro_torch.models.lm import attn_block_defs
    cfg = get_config("gemma2-2b")
    jcfg = jget_config("gemma2-2b")
    from repro.models.lm import attn_block_defs as jattn_block_defs
    m = tmesh.MeshShape.named("pod_32x8")
    jm = FakeMesh(**m.shape)
    defs = attn_block_defs(cfg)
    tree = sharding_tree(defs, m, default_rules(m, fsdp=True))
    shapes = shape_tree(defs)
    jr = jdefault_rules(jm, fsdp=True)
    for key, d in _jleaves(jattn_block_defs(jcfg)):
        node, snode = tree, shapes
        for part in key.split("/"):
            node, snode = node[part], snode[part]
        assert node.spec == tuple(jspec_for(d.shape, d.logical, jm, jr)), key
        assert snode.device.type == "meta" and tuple(snode.shape) == d.shape
        assert snode.dtype == torch.bfloat16
