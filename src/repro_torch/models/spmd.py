"""Running a model on a ``DeviceMesh``: the layout of one step and the
collectives it needs, with their gradients.

The reference jits its steps with GSPMD shardings and lets XLA place the
collectives; its MoE runs inside ``shard_map``.  Here every step on a mesh
runs as the MoE does there: each rank computes on its own shards (plain
tensors: the kernels see local shapes) and calls the collectives itself.
The parameters are DTensors placed by the logical rules
(:mod:`repro_torch.models.sharding`); :meth:`Layout.param` hands a block
the local tensor it computes with — the FSDP (data-axis) dims gathered,
the model-axis dim kept where the block runs tensor-parallel — and its
backward gives the gradient back in the parameter's placements
(reduce-scatter over the gathered data dims, all-reduce where the
gradient is a per-rank partial).

A :class:`Layout` says where the step's activations live: the batch over
the data axes (``batch``: when the batch divides them), and with
``seq`` the residual stream's sequence over the model axis (sequence
parallelism, the reference's ``act_spec = P(dp, "model")``).  A
tensor-parallel region (:meth:`Layout.enter_tp` / :meth:`Layout.exit_tp`)
gathers that sequence first and slices it again after the all-reduce
over the model axis that ends the region.

The collectives are ``torch.distributed``'s functional ones
(``_c10d_functional``) on the mesh's groups, so a ``TorchDispatchMode``
sees each (the dry-run counts their bytes).  A group of one rank is
skipped.  Off a mesh (no layout) nothing here runs.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

_c10d = None


def _ops():
    global _c10d
    if _c10d is None:
        import torch.distributed  # noqa: F401  (registers the ops)
        _c10d = torch.ops._c10d_functional
    return _c10d


def _group(mesh, axis: str) -> Tuple[int, str]:
    g = mesh.get_group(axis)
    return mesh.size(list(mesh.mesh_dim_names).index(axis)), g.group_name


def _sizes(mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= _group(mesh, a)[0]
    return n


# ---------------------------------------------------------------------------
# Raw collectives over mesh axes (no autograd)
# ---------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, mesh, axes: Sequence[str],
               op: str = "sum") -> torch.Tensor:
    """Sum (or max/min) over every rank of ``axes``."""
    for a in axes:
        n, name = _group(mesh, a)
        if n > 1:
            x = _ops().wait_tensor(_ops().all_reduce(x.contiguous(), op,
                                                     name))
    return x


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    n, name = _group(mesh, axis)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = _ops().wait_tensor(_ops().all_gather_into_tensor(xt, n, name))
    return out.movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """The sum over the ranks, each keeping its chunk along ``dim``."""
    n, name = _group(mesh, axis)
    if n == 1:
        return x
    xt = x.movedim(dim, 0).contiguous()
    out = _ops().wait_tensor(_ops().reduce_scatter_tensor(xt, "sum", n,
                                                          name))
    return out.movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               cat_dim: int) -> torch.Tensor:
    """Chunk j of ``split_dim`` goes to rank j; the chunks received are
    concatenated along ``cat_dim`` in rank order."""
    n, name = _group(mesh, axis)
    if n == 1:
        return x
    chunks = x.movedim(split_dim, 0)
    sz = chunks.shape[0] // n
    xt = chunks.reshape((n, sz) + chunks.shape[1:]).contiguous()
    out = _ops().wait_tensor(_ops().all_to_all_single(
        xt.reshape((n * sz,) + chunks.shape[1:]), [sz] * n, [sz] * n, name))
    out = out.reshape((n, sz) + chunks.shape[1:]).movedim(1, split_dim + 1)
    # (n, ...) with the received chunks first: concatenate along cat_dim
    parts = list(out.unbind(0))
    return torch.cat(parts, dim=cat_dim)


def _chunk(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _group(mesh, axis)[0]
    if n == 1:
        return x
    r = mesh.get_local_rank(axis)
    return x.chunk(n, dim=dim)[r].contiguous()


# ---------------------------------------------------------------------------
# Collectives with their gradients
# ---------------------------------------------------------------------------

class _ReduceFrom(torch.autograd.Function):
    """Forward: sum (or mean) over ``axes``; backward: the gradient as it
    is (divided likewise for the mean) — the value is consumed identically
    on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, axes, mean):
        ctx.scale = 1.0 / _sizes(mesh, axes) if mean else 1.0
        y = all_reduce(x, mesh, axes)
        return y * ctx.scale if mean else y

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None, None


class _CopyTo(torch.autograd.Function):
    """Forward: identity; backward: sum over ``axes`` — each rank's use of
    the value contributes a part of its gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _AllReduceSum(torch.autograd.Function):
    """Forward and backward: sum over ``axes`` (each rank consumes the sum
    in its own way)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class _GatherFrom(torch.autograd.Function):
    """Forward: all-gather along ``dim``; backward: reduce-scatter (each
    rank's use of the whole is a part of every chunk's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, \
            None


class _GatherSlice(torch.autograd.Function):
    """Forward: all-gather along ``dim``; backward: this rank's chunk of
    the gradient (the whole is consumed identically on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _SliceTo(torch.autograd.Function):
    """Forward: this rank's chunk along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _chunk(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


# ---------------------------------------------------------------------------
# The layout of one step
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a step's activations live on ``mesh``."""

    mesh: object
    dp: Tuple[str, ...]          # data axes of the mesh
    tp: Optional[str]            # the model axis, if the mesh has one
    batch: bool                  # batch dim sharded over ``dp``
    seq: bool = False            # residual stream's seq over ``tp``
    seq_len: int = 1             # the stream's positions in all

    @property
    def tp_size(self) -> int:
        return _group(self.mesh, self.tp)[0] if self.tp else 1

    @property
    def tp_rank(self) -> int:
        return self.mesh.get_local_rank(self.tp) if self.tp else 0

    @property
    def grad_axes(self) -> Tuple[str, ...]:
        """Axes over which a replicated parameter's gradient is a per-rank
        part: the data axes when the batch is split over them, and the
        model axis when the sequence is."""
        out = self.dp if self.batch else ()
        return out + ((self.tp,) if self.seq and self.tp else ())

    def with_seq(self, seq: bool) -> "Layout":
        return dataclasses.replace(self, seq=seq)

    # -- parameters ---------------------------------------------------------

    def tp_dim(self, p) -> Optional[int]:
        """The tensor dim a DTensor parameter shards over the model axis
        (None: replicated over it, or no model axis)."""
        from torch.distributed.tensor import DTensor, Shard
        if not self.tp or not isinstance(p, DTensor):
            return None
        pl = p.placements[list(self.mesh.mesh_dim_names).index(self.tp)]
        return pl.dim if isinstance(pl, Shard) else None

    def param(self, p, keep: Optional[Dict[str, int]] = None,
              tp_partial: bool = False) -> torch.Tensor:
        """The local tensor a block computes with: every sharded mesh dim
        gathered but those in ``keep`` (axis -> tensor dim kept sharded;
        a dim the parameter is not sharded on is split locally).  Its
        gradient is a per-rank part over :attr:`grad_axes`, and over the
        model axis too with ``tp_partial`` (the parameter is replicated
        there but each rank's use covers its own shard of the work)."""
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        if not isinstance(p, DTensor):
            return p
        keep = keep or {}
        names = list(self.mesh.mesh_dim_names)
        partial = set(self.grad_axes)
        if tp_partial and self.tp:
            partial.add(self.tp)
        tgt = [Shard(keep[a]) if a in keep else Replicate() for a in names]
        gpl = [Partial() if (a in partial and a not in keep) else t
               for a, t in zip(names, tgt)]
        d = p if list(p.placements) == tgt else p.redistribute(
            self.mesh, tgt)
        return d.to_local(grad_placements=gpl)

    # -- activations --------------------------------------------------------

    def copy_to_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyTo.apply(x, self.mesh, (self.tp,)) if self.tp else x

    def reduce_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFrom.apply(x, self.mesh, (self.tp,), False) \
            if self.tp else x

    def all_reduce_tp(self, x: torch.Tensor) -> torch.Tensor:
        return _AllReduceSum.apply(x, self.mesh, (self.tp,)) \
            if self.tp else x

    def enter_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Into a tensor-parallel region: the whole sequence (under
        ``seq``), its gradient summed over the model axis."""
        if self.seq:
            x = _GatherSlice.apply(x, self.mesh, self.tp, 1)
        return self.copy_to_tp(x)

    def exit_tp(self, y: torch.Tensor) -> torch.Tensor:
        """Out of a tensor-parallel region: the partial sums added over the
        model axis, then (under ``seq``) this rank's part of the
        sequence."""
        y = self.reduce_tp(y)
        return self.slice_seq(y)

    def gather_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence from its model-axis shards (gradient
        reduce-scattered)."""
        return _GatherFrom.apply(x, self.mesh, self.tp, dim) \
            if self.seq else x

    def gather_seq_same(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole sequence, consumed identically by every rank."""
        return _GatherSlice.apply(x, self.mesh, self.tp, dim) \
            if self.seq else x

    def slice_seq(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return _SliceTo.apply(x, self.mesh, self.tp, dim) if self.seq else x

    def seq_offset(self, S_local: int) -> int:
        return self.tp_rank * S_local if self.seq else 0

    def reduce_dp(self, x: torch.Tensor, mean: bool = False) -> torch.Tensor:
        """Sum (mean) over the data shards of the batch."""
        if not self.batch or not self.dp:
            return x
        return _ReduceFrom.apply(x, self.mesh, self.dp, mean)


def layout_for(tokens, act_spec=None) -> Layout:
    """The layout of a step whose input ``tokens`` is a DTensor (batch
    first, placed by the rules): its mesh, whether its batch is split over
    the data axes, and with ``act_spec`` naming the model axis on the
    sequence (``P(dp, "model")``), sequence parallelism where the
    sequence divides that axis."""
    from torch.distributed.tensor import Shard
    mesh = tokens.device_mesh
    names = list(mesh.mesh_dim_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model" if "model" in names else None
    batch = any(isinstance(pl, Shard) and pl.dim == 0
                for pl in tokens.placements)
    S = tokens.shape[1] if tokens.ndim > 1 else 1
    want_seq = (act_spec is not None and len(act_spec) > 1
                and act_spec[1] is not None and tp is not None)
    seq = bool(want_seq and S % _group(mesh, tp)[0] == 0
               and _group(mesh, tp)[0] > 1)
    return Layout(mesh=mesh, dp=dp, tp=tp, batch=batch, seq=seq,
                  seq_len=S)


def dp_size(L: Layout) -> int:
    return _sizes(L.mesh, L.dp)


def batch_dtensor(x: torch.Tensor, L: Layout):
    """This rank's rows of a batch-first result as a DTensor: split over
    the data axes where the step's batch is, replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    names = list(L.mesh.mesh_dim_names)
    pl = [Shard(0) if (L.batch and a in L.dp) else Replicate()
          for a in names]
    shape = (x.shape[0] * (dp_size(L) if L.batch else 1),) + tuple(
        x.shape[1:])
    from repro_torch.models.sharding import contiguous_stride
    return DTensor.from_local(x, L.mesh, pl, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def block(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (a plain tensor as it is)."""
    return t.to_local() if is_sharded(t) else t


def local(p) -> torch.Tensor:
    """A replicated parameter's whole local tensor under the current
    layout (a plain tensor as it is)."""
    if not is_sharded(p):
        return p
    L = current()
    if L is None:
        raise RuntimeError("a DTensor parameter outside a step on its mesh")
    return L.param(p)


_LAYOUT: contextvars.ContextVar = contextvars.ContextVar("layout",
                                                         default=None)


def current() -> Optional[Layout]:
    return _LAYOUT.get()


@contextlib.contextmanager
def on_layout(layout: Optional[Layout]) -> Iterator[Optional[Layout]]:
    tok = _LAYOUT.set(layout)
    try:
        yield layout
    finally:
        _LAYOUT.reset(tok)


def is_sharded(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
