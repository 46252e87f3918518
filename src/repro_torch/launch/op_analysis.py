"""Operation-level analysis of one step on the ``meta`` device — the
roofline terms and the peak memory of the dry-run.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``,
which walks compiled HLO.  Here the step runs eagerly, one dispatched
operation at a time, on ``meta`` tensors (shapes and dtypes, no storage),
under a ``TorchDispatchMode`` that sees every operation below autograd,
the backward's included:

  * FLOPs        — matrix products and convolutions by the formulas
                   ``torch.utils.flop_counter`` registers (2 per
                   multiply-add); 1 per output element of an elementwise
                   arithmetic operation (``ELEMENTWISE``), as the reference
                   counts its elementwise HLO ops;
  * HBM bytes    — per dispatched operation: operand + result bytes.  An
                   eager step runs each operation as its own kernel, the
                   counterpart of the reference's "per top-level op" rule;
                   views (and the allocation of an uninitialised tensor)
                   move nothing;
  * peak bytes   — the storages alive at once, each counted from the
                   operation that makes it until its last reference dies
                   (the counterpart of ``compiled.memory_analysis()``);
                   what the step is given (``track``) is alive from the
                   start;
  * kernel calls — the hand-written kernels' calls by entry point, each
                   with the FLOPs and bytes of its formula
                   (:mod:`repro_torch.launch.roofline`), reported by their
                   meta stand-ins (:mod:`repro_torch.kernels.meta`) and
                   added to the totals.

  * collective bytes — the operand bytes of every collective by kind
                   (all-gather, all-reduce, reduce-scatter, all-to-all,
                   broadcast), with their calls: the functional
                   ``_c10d_functional`` ops that the steps on a mesh and
                   DTensor's redistributions issue, and the in-place
                   ``c10d`` ops of ``torch.distributed``'s calls.  A step on
                   a mesh is traced as one rank sees it (rank 0 of a fake
                   process group of the mesh's size), so every count is a
                   card's.

On a mesh the step's parameters, cache and inputs are DTensors.  The mode
leaves an operation on DTensors to DTensor (it returns ``NotImplemented``),
which runs it as local operations and collectives that come back through
the mode; so a card's peak and bytes are its local tensors', and no
DTensor and its local tensor are counted twice.  The reference's CPU
legalisation bytes have no counterpart.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import meta as _meta
from repro_torch.models import spmd

aten = torch.ops.aten

#: elementwise arithmetic counted at 1 FLOP per output element (the
#: reference's HLO list, with the activations and their gradients, which
#: XLA spells in those ops)
ELEMENTWISE = frozenset(
    getattr(aten, name) for name in (
        "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
        "pow", "pow_", "exp", "exp_", "expm1", "log", "log1p", "rsqrt",
        "sqrt", "tanh", "sigmoid", "maximum", "minimum", "clamp", "clamp_",
        "clamp_min", "clamp_max", "atan2", "erf", "cos", "sin", "relu",
        "silu", "gelu", "softplus", "addcmul", "addcdiv", "lerp",
        "_softmax", "_log_softmax", "silu_backward", "gelu_backward",
        "tanh_backward", "sigmoid_backward", "threshold_backward",
        "softplus_backward", "_softmax_backward_data",
        "_log_softmax_backward_data"))

#: collective ops by kind: the functional ops and the in-place c10d ops
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d")
_OUT_FIRST = frozenset(("allgather_", "_allgather_base_", "reduce_scatter_",
                        "_reduce_scatter_base_", "alltoall_",
                        "alltoall_base_",
                        "allgather_into_tensor_coalesced_"))

#: operations that allocate without writing
_UNWRITTEN = frozenset((aten.empty, aten.empty_strided, aten.empty_like,
                        aten.new_empty, aten.new_empty_strided))


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_DTENSOR = []


def _is_dtensor_type(t) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor
        _DTENSOR.append(DTensor)
    return isinstance(t, type) and issubclass(t, _DTENSOR[0])


@dataclasses.dataclass
class Analysis:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    #: the FLOPs of the dispatched products (the registered formulas) and
    #: of the elementwise arithmetic, both in ``flops``
    matmul_flops: float = 0.0
    elementwise_flops: float = 0.0
    #: the hand-written kernels' calls, FLOPs and bytes by entry point
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: collective operand bytes and calls by kind
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_count: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    #: the most bytes alive at once, and those of what the step was given
    peak_bytes: int = 0
    argument_bytes: int = 0
    ops: int = 0
    warnings: List[str] = dataclasses.field(default_factory=list)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def to_json(self) -> Dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_count": dict(self.collective_count),
                "total_collective_bytes": self.total_collective_bytes,
                "matmul_flops": self.matmul_flops,
                "elementwise_flops": self.elementwise_flops,
                "kernel_calls": dict(self.kernel_calls),
                "kernel_flops": dict(self.kernel_flops),
                "kernel_bytes": dict(self.kernel_bytes),
                "peak_bytes": self.peak_bytes,
                "argument_bytes": self.argument_bytes, "ops": self.ops,
                "warnings": list(self.warnings)}


class OpAnalysis(TorchDispatchMode):
    """Counts what runs while it is entered into ``self.analysis``::

        with OpAnalysis() as oa:
            oa.track(model, batch)       # alive from the start
            step(model, batch)
        oa.analysis.to_json()
    """

    def __init__(self):
        super().__init__()
        self.analysis = Analysis()
        self._live = 0
        self._seen = WeakIdKeyDictionary()

    # -- live storages ----------------------------------------------------

    def _free(self, nbytes: int) -> None:
        self._live -= nbytes

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        nbytes = st.nbytes()
        self._seen[st] = nbytes
        weakref.finalize(st, self._free, nbytes)
        self._live += nbytes
        self.analysis.peak_bytes = max(self.analysis.peak_bytes, self._live)

    def track(self, *trees: Iterable) -> None:
        """Count what ``trees`` hold (tensors, modules' parameters and
        buffers, nested containers) as alive from now on."""
        for leaf in tree_flatten(trees)[0]:
            ts = ([*leaf.parameters(), *leaf.buffers()]
                  if isinstance(leaf, torch.nn.Module) else _tensors(leaf))
            for t in ts:
                before = self._live
                self._hold(spmd.block(t))
                self.analysis.argument_bytes += self._live - before

    # -- kernels ----------------------------------------------------------

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        a = self.analysis
        a.kernel_calls[name] = a.kernel_calls.get(name, 0) + 1
        a.kernel_flops[name] = a.kernel_flops.get(name, 0.0) + flops
        a.kernel_bytes[name] = a.kernel_bytes.get(name, 0.0) + nbytes
        a.flops += flops
        a.hbm_bytes += nbytes

    def __enter__(self):
        _meta.SINKS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        _meta.SINKS.remove(self._kernel)
        return super().__exit__(*exc)

    # -- operations -------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        a = self.analysis
        a.ops += 1
        outs = _tensors(out)
        packet = func.overloadpacket
        kind = (COLLECTIVES.get(packet.__name__)
                if func.namespace in _COLLECTIVE_NS else None)
        if kind is not None:
            # the c10d ops with an output argument take their input second
            src = (args[1] if func.namespace == "c10d"
                   and packet.__name__ in _OUT_FIRST else (args, kwargs))
            nbytes = sum(_nbytes(t) for t in _tensors(src))
            a.collective_bytes[kind] = a.collective_bytes.get(kind, 0.0) \
                + nbytes
            a.collective_count[kind] = a.collective_count.get(kind, 0) + 1
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            a.matmul_flops += f
            a.flops += f
        elif packet in ELEMENTWISE:
            f = sum(t.numel() for t in outs)
            a.elementwise_flops += f
            a.flops += f
        ins = _tensors((args, kwargs))
        if not (func.is_view or packet in _UNWRITTEN
                or self._aliases(func, ins, outs)):
            a.hbm_bytes += (sum(_nbytes(t) for t in ins)
                            + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._hold(t)
        return out

    @staticmethod
    def _aliases(func, ins, outs) -> bool:
        """Whether every output is a view of an input, written by nothing
        (``_unsafe_view`` and the like; an in-place op writes its input)."""
        if not outs or any(arg.alias_info is not None
                           and arg.alias_info.is_write
                           for arg in func._schema.arguments):
            return False
        stores = [t.untyped_storage() for t in ins]
        return all(any(o.untyped_storage() is s for s in stores)
                   for o in outs)
