"""Logical-axis sharding rules — sharding-stable SCT edges (paper Sec. 3.1).

The port's counterpart of the JAX package's ``models/sharding.py``, with
its rule tables and its rule: every tensor dimension carries a *logical
axis name*, rules map logical axes to mesh axes, and every tensor derives
its placement from the same rule set, so that no edge of the SCT needs a
resharding collective.  A rule is a priority list: the first mesh axis (or
tuple of axes) that divides the dimension wins, no mesh axis is used twice
in one tensor, and a dimension that nothing divides is replicated (the
paper's "relax the constraint, accept unbalance", Sec. 3.2.2).

The reference hands its ``PartitionSpec``\\ s to GSPMD.  Here a spec (a
tuple: one entry per tensor dimension, ``None``, a mesh axis name or a
tuple of names, trailing ``None``\\ s dropped — entry for entry the
reference's) becomes the ``Shard``/``Replicate`` placements of a DTensor
on a ``DeviceMesh`` (:func:`placements_for`): one placement per mesh
dimension, a tuple of axes sharding one tensor dimension over several mesh
dimensions in mesh order.  A mesh is read through :func:`axis_sizes`, so
the pure functions also take any object whose ``.shape`` is a dict of axis
sizes (the duck-typed meshes of the tests and of the dry-run's tables).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

AxisChoice = Union[str, Tuple[str, ...], None]


class P(tuple):
    """A partition spec: ``P("data", None, "model")``; entries as the
    reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a duck-typed mesh whose
    ``.shape`` is that dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis -> ordered candidate mesh axes."""

    table: Dict[str, Tuple[AxisChoice, ...]]

    def lookup(self, logical: Optional[str]) -> Tuple[AxisChoice, ...]:
        if logical is None:
            return (None,)
        return self.table.get(logical, (None,))


def default_rules(mesh, *, fsdp: bool = False,
                  seq_shard: bool = False) -> Rules:
    """Production rules for the (pod, data, model) / (data, model) meshes.

    ``fsdp``: also shard the non-model dim of big weights over the data
    axes (ZeRO-3: gathered layer by layer where they are used).
    ``seq_shard``: shard long sequence dims (the caches') over the model
    axis.
    """
    shape = axis_sizes(mesh)
    dp: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in shape)
    mdl = ("model",) if "model" in shape else ()
    t: Dict[str, Tuple[AxisChoice, ...]] = {
        "batch": (dp,),
        "seq": ((mdl[0],) if seq_shard and mdl else (None,)),
        "embed": ((dp,) if fsdp else (None,)),
        "heads": mdl or (None,),
        "kv_heads": mdl or (None,),
        "head_dim": (None,),
        "mlp": mdl or (None,),
        "vocab": mdl or (None,),
        "experts": mdl or (None,),
        "expert_mlp": mdl or (None,),
        "state": (None,),
        "conv": (None,),
        "cache_batch": (dp,),
        "cache_seq": ((mdl[0],) if seq_shard and mdl else (None,)),
        "frames": (None,),
    }
    return Rules(table=t)


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh, rules: Rules) -> P:
    """The spec of one tensor: first divisible candidate per dim, never
    reusing a mesh axis across dims."""
    if len(shape) != len(logical):
        raise ValueError(f"rank mismatch {shape} vs {logical}")
    sizes = axis_sizes(mesh)
    used: set = set()
    out: List[AxisChoice] = []
    for dim, name in zip(shape, logical):
        chosen: AxisChoice = None
        for cand in rules.lookup(name):
            if cand is None:
                continue
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a in used or a not in sizes for a in axes):
                continue
            sz = 1
            for a in axes:
                sz *= sizes[a]
            if sz > 0 and dim % sz == 0:
                chosen = axes if len(axes) > 1 else axes[0]
                used.update(axes)
                break
        out.append(chosen)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


# ---------------------------------------------------------------------------
# Specs <-> DTensor placements
# ---------------------------------------------------------------------------

def _entry_axes(entry: AxisChoice) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(spec: Sequence[AxisChoice], mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    every mesh dimension that shards tensor dim d, ``Replicate()`` on the
    others.  A tuple entry must name its axes in mesh order (DTensor splits
    a dim over several mesh dims left to right, as JAX splits it over a
    tuple's axes major to minor)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def spec_of(placements: Sequence, mesh, ndim: int) -> P:
    """The spec that :func:`placements_for` turns into ``placements``."""
    from torch.distributed.tensor import Shard
    names = list(axis_sizes(mesh))
    dims: List[List[str]] = [[] for _ in range(ndim)]
    for name, pl in zip(names, placements):
        if isinstance(pl, Shard):
            dims[pl.dim].append(name)
        elif not pl.is_replicate():
            raise ValueError(f"{pl} has no spec")
    out: List[AxisChoice] = [None if not a else a[0] if len(a) == 1
                             else tuple(a) for a in dims]
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(out))


def local_shape(shape: Sequence[int], spec: Sequence[AxisChoice],
                mesh) -> Tuple[int, ...]:
    """One rank's shard of a tensor of ``shape`` under ``spec`` (every
    sharded dim divides evenly: :func:`spec_for` shards nothing else)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if out[d] % sizes[a]:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"divide over {a}={sizes[a]}")
            out[d] //= sizes[a]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as the reference's ``NamedSharding``; its
    ``placements`` are the DTensor ones (a ``DeviceMesh`` or a duck-typed
    mesh)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> list:
        return placements_for(self.spec, self.mesh)


def sharding_for(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh, rules: Rules) -> NamedSharding:
    """One tensor's sharding by the rules."""
    return NamedSharding(mesh, spec_for(shape, logical, mesh, rules))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(tree_logical, tree_shapes, mesh, rules: Rules):
    """Map a nested dict of logical-axis tuples and one of shapes (the
    same keys) to the same nest of :class:`NamedSharding`\\ s."""
    if _is_logical(tree_logical):
        return sharding_for(tree_shapes, tree_logical, mesh, rules)
    return {k: tree_shardings(v, tree_shapes[k], mesh, rules)
            for k, v in tree_logical.items()}


def constrain(x, logical: Sequence[Optional[str]], mesh, rules: Rules):
    """Redistribute a DTensor to the placements its logical names give on
    ``mesh`` (a no-op where it already has them); a plain tensor — off
    any mesh — is returned as it is, as the reference's
    ``with_sharding_constraint`` is a no-op off-mesh."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    pl = sharding_for(tuple(x.shape), logical, mesh, rules).placements
    if list(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)
