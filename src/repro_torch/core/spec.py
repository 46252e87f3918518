"""Kernel interface specification — the Marrow `IDataType` layer.

The paper (Sec. 2.1, 3.4) requires every kernel wrapped in an SCT to declare
its interface: which arguments are vectors vs scalars, which are immutable,
which may be partitioned across devices (and with which *elementary
partitioning unit*, ``epu``), and which must be replicated (``COPY``
transfer mode).  Scalar parameters may carry partition-bound traits
(``Size`` / ``Offset``).

These declarations drive the locality-aware domain decomposition
(:mod:`repro_torch.core.decomposition`).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Any, Callable, Optional, Sequence, Tuple


class Trait(enum.Enum):
    """Partition-bound scalar traits (paper Sec. 3.4)."""

    NONE = "none"
    SIZE = "size"      # instantiated with the size of the current partition
    OFFSET = "offset"  # instantiated with the partition's offset in the domain


class Transfer(enum.Enum):
    """Data-transfer mode for vector arguments."""

    PARTITION = "partition"  # locality-aware partitioning (default)
    COPY = "copy"            # replicate integrally to all devices


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """Specification of one kernel argument.

    Attributes:
      name: argument name (used to identify shared edges between kernels).
      kind: "vector" or "scalar".
      mutable: whether the kernel writes the argument.
      transfer: PARTITION or COPY (vectors only).
      partition_dim: tensor dimension along which partitioning happens.
      epu: elementary partitioning unit, in elements along ``partition_dim``
        (paper: image line, FFT block, plane of a 3-D volume, ...).
      trait: SIZE/OFFSET for partition-bound scalars.
    """

    name: str
    kind: str = "vector"
    mutable: bool = False
    transfer: Transfer = Transfer.PARTITION
    partition_dim: int = 0
    epu: int = 1
    trait: Trait = Trait.NONE

    def __post_init__(self) -> None:
        if self.kind not in ("vector", "scalar"):
            raise ValueError(f"bad ArgSpec.kind: {self.kind}")
        if self.epu < 1:
            raise ValueError("epu must be >= 1")

    @property
    def partitionable(self) -> bool:
        return self.kind == "vector" and self.transfer is Transfer.PARTITION


def vector(name: str, *, mutable: bool = False, partition_dim: int = 0,
           epu: int = 1, copy: bool = False) -> ArgSpec:
    return ArgSpec(name=name, kind="vector", mutable=mutable,
                   transfer=Transfer.COPY if copy else Transfer.PARTITION,
                   partition_dim=partition_dim, epu=epu)


def scalar(name: str, *, trait: Trait = Trait.NONE) -> ArgSpec:
    return ArgSpec(name=name, kind="scalar", trait=trait)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Interface of a computational kernel (paper Sec. 2.1).

    ``work_per_thread`` is the paper's ``nu(V, K)``: how many elements of
    the partition dimension one work-item computes.  ``work_group_size``
    is an optional hard work-group requirement; when ``None`` the tuner is
    free to choose one (from the occupancy-ordered candidate list).

    ``flops_per_item`` / ``bytes_per_item`` feed the occupancy and roofline
    models; ``local_mem_per_item`` is the VMEM (TPU) analogue of OpenCL
    local memory, in bytes per element of a work-group's tile.
    """

    name: str
    inputs: Tuple[ArgSpec, ...]
    outputs: Tuple[ArgSpec, ...]
    work_group_size: Optional[int] = None
    work_per_thread: int = 1
    flops_per_item: float = 1.0
    bytes_per_item: float = 4.0
    local_mem_per_item: float = 0.0

    def arg(self, name: str) -> ArgSpec:
        for a in self.inputs + self.outputs:
            if a.name == name:
                return a
        raise KeyError(name)

    @property
    def vectors(self) -> Tuple[ArgSpec, ...]:
        return tuple(a for a in self.inputs + self.outputs if a.kind == "vector")

    def nu(self, arg_name: str) -> int:
        """Paper's nu(V, K): elements of V computed per work-item."""
        _ = self.arg(arg_name)
        return self.work_per_thread


@dataclasses.dataclass(frozen=True)
class Workload:
    """Characterisation of a workload (paper Sec. 3.2.1).

    ``dims``: number of elements per dimension of the work space.
    ``double_precision``: whether the data is fp64 (paper) — we generalise
    to an ``itemsize`` in bytes.
    """

    dims: Tuple[int, ...]
    itemsize: int = 4

    @property
    def ndim(self) -> int:
        return len(self.dims)

    @property
    def size(self) -> int:
        return int(math.prod(self.dims))

    def as_features(self) -> Tuple[float, ...]:
        """Feature vector for KB interpolation (dims + precision flag)."""
        return tuple(float(d) for d in self.dims) + (float(self.itemsize),)

    def key(self) -> str:
        return "x".join(str(d) for d in self.dims) + f"@{self.itemsize}"


MergeFn = Callable[[Sequence[Any]], Any]

#: Predefined merging functions (paper Sec. 3.4): addition, subtraction,
#: multiplication and division over the partial results of partitions.
#:
#: Fault-tolerance note: under repartition-retry (repro_torch.core.faults) a
#: failed partition's partial result is replaced by *several* partial
#: results from the sub-ranges adopted by surviving slots, so a MergeFn
#: must tolerate a variable number of parts.  ADD/MUL are fully safe
#: (associative + commutative); the left-fold SUB/DIV semantics
#: ``p0 - p1 - ... = p0 - (p1 + ...)`` survive re-splits of any
#: partition except the first — custom non-associative merges should be
#: paired with ``FaultPolicy(max_attempts=1)``.
MERGE_ADD: MergeFn = lambda parts: _fold(parts, lambda a, b: a + b)
MERGE_SUB: MergeFn = lambda parts: _fold(parts, lambda a, b: a - b)
MERGE_MUL: MergeFn = lambda parts: _fold(parts, lambda a, b: a * b)
MERGE_DIV: MergeFn = lambda parts: _fold(parts, lambda a, b: a / b)


def _fold(parts: Sequence[Any], op: Callable[[Any, Any], Any]) -> Any:
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc
