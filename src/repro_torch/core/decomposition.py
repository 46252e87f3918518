"""Locality-aware domain decomposition (paper Sec. 3.1).

The dataset of an SCT is partitioned **once**, with a global vision of the
whole tree, so that consecutive kernels communicate by simply *persisting*
data in device memory — never by moving it between devices.  Two kernels
that share a vector must observe identical partitionings (same number of
partitions, same sizes), regardless of their individual work-group size
restrictions.

Paper constraint system, for vector V shared by kernels K with partitions
``V^j`` (one per parallel execution j):

    V = U_j V^j
    epu(V) mod nu(V, K) == 0
    #V^j  mod (epu(V) / nu(V, K)) == 0
    #V^j  mod wgs_j(K) == 0

Implementation: all partitionable vectors of an SCT are decomposed over a
common *domain* expressed in elementary partitioning units.  Vector V with
extent ``e`` along its partition dim contributes ``e / epu(V)`` domain
units, and every partitionable vector must agree on that unit count.
Execution j receives ``u_j`` units, where ``u_j`` must be a multiple of the
execution's *unit quantum* ``q_j = lcm_K( lcm(wgs_j(K), epu) / epu )``.

The plan drives explicit per-partition execution (host fission slots,
CUDA-stream overlap slots, the simulator), where partitions may be
**uneven** (heterogeneous devices).  ``shardings()`` exports the even
partition of a mesh axis instead: one spec per SCT edge, as the JAX
package's does, with DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.skeletons import SCT
from repro_torch.core.spec import ArgSpec, KernelSpec, Transfer
from repro_torch.models.sharding import NamedSharding, P, axis_sizes


class DecompositionError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class VectorPlan:
    name: str
    partition_dim: int
    epu: int
    copy: bool                      # COPY transfer mode -> replicate
    extent: int                     # size along partition_dim
    units: int                      # extent / epu (0 for COPY vectors)


@dataclasses.dataclass
class ExecutionSlot:
    """One parallel execution (paper Fig. 3): a (device, queue) pair.

    ``wgs``: work-group size chosen for each kernel on this slot's device
    (kernel name -> wgs).  ``device_type``: 'cpu' / 'gpu' / 'tpu' class
    used by the workload-distribution generator.
    """

    device: str
    device_type: str
    wgs: Dict[str, int] = dataclasses.field(default_factory=dict)

    def quantum(self, vectors: Sequence[VectorPlan],
                specs: Sequence[KernelSpec]) -> int:
        """Unit quantum of this execution: u_j must be a multiple of it."""
        q = 1
        for spec in specs:
            wgs = self.wgs.get(spec.name, 1)
            for a in spec.vectors:
                if a.transfer is Transfer.COPY or not a.partitionable:
                    continue
                # paper: epu(V) mod nu(V,K) == 0
                if a.epu % spec.nu(a.name) != 0:
                    raise DecompositionError(
                        f"kernel {spec.name}, vector {a.name}: "
                        f"epu={a.epu} not a multiple of nu={spec.nu(a.name)}")
                # #V^j mod wgs == 0  ->  u_j mod lcm(wgs, epu)/epu == 0
                q = math.lcm(q, math.lcm(wgs, a.epu) // a.epu)
        return q


@dataclasses.dataclass
class DecompositionPlan:
    """Partitioning plan for one (SCT, workload) pair."""

    sct_id: str
    domain_units: int
    vectors: Dict[str, VectorPlan]
    specs: List[KernelSpec]

    # ---- explicit (possibly uneven) partitioning -------------------------
    def partition(self, slots: Sequence[ExecutionSlot],
                  shares: Sequence[float]) -> "ConcretePartitioning":
        """Quantised largest-remainder allocation of domain units to slots.

        ``shares`` come from the workload-distribution generator; they are
        quantised to each slot's unit quantum.  If an exact allocation is
        impossible the most-loaded slot's quantum is relaxed to 1 (paper:
        when constraints cannot hold, the best-occupancy work-group size is
        used instead — the solution may be inherently unbalanced).
        """
        if len(slots) != len(shares):
            raise DecompositionError("one share per execution slot required")
        if abs(sum(shares) - 1.0) > 1e-6:
            raise DecompositionError(f"shares must sum to 1, got {sum(shares)}")
        U = self.domain_units
        quanta = [s.quantum(list(self.vectors.values()), self.specs)
                  for s in slots]
        alloc = [int(f * U) // q * q for f, q in zip(shares, quanta)]
        rem = U - sum(alloc)
        # greedy fill by largest fractional remainder, in quantum steps
        order = sorted(range(len(slots)),
                       key=lambda i: (shares[i] * U - alloc[i]), reverse=True)
        progress = True
        while rem > 0 and progress:
            progress = False
            for i in order:
                if quanta[i] <= rem:
                    alloc[i] += quanta[i]
                    rem -= quanta[i]
                    progress = True
        relaxed = False
        if rem > 0:  # relax the largest slot's quantum (paper fallback)
            j = max(range(len(slots)), key=lambda i: alloc[i])
            alloc[j] += rem
            rem = 0
            relaxed = True
        return ConcretePartitioning(plan=self, slots=list(slots),
                                    units=alloc, relaxed=relaxed)

    # ---- even sharding over a mesh axis ----------------------------------
    def shardings(self, mesh, *, data_axis: str = "data",
                  extra: Optional[Dict[str, P]] = None
                  ) -> Dict[str, NamedSharding]:
        """Even sharding per SCT edge: one :class:`NamedSharding` per
        vector (its ``placements`` are the DTensor ones on a
        ``DeviceMesh``).

        COPY vectors are replicated; partitionable vectors are sharded
        along their partition dim over ``data_axis``.  Raises if the even
        per-device partition would violate the quantum constraints.
        """
        n = axis_sizes(mesh)[data_axis]
        out: Dict[str, NamedSharding] = {}
        if self.domain_units % n != 0:
            raise DecompositionError(
                f"domain has {self.domain_units} units, not divisible by "
                f"mesh axis '{data_axis}'={n}")
        for name, v in self.vectors.items():
            if v.copy:
                spec = P()
            else:
                axes: List[Optional[str]] = [None] * (v.partition_dim + 1)
                axes[v.partition_dim] = data_axis
                spec = P(*axes)
            if extra and name in extra:
                spec = extra[name]
            out[name] = NamedSharding(mesh, spec)
        return out


@dataclasses.dataclass
class ConcretePartitioning:
    plan: DecompositionPlan
    slots: List[ExecutionSlot]
    units: List[int]            # domain units per execution slot
    relaxed: bool = False

    def sizes(self, vector: str) -> List[int]:
        v = self.plan.vectors[vector]
        if v.copy:
            return [v.extent] * len(self.slots)
        return [u * v.epu for u in self.units]

    def offsets(self, vector: str) -> List[int]:
        v = self.plan.vectors[vector]
        if v.copy:
            return [0] * len(self.slots)
        offs, acc = [], 0
        for u in self.units:
            offs.append(acc)
            acc += u * v.epu
        return offs

    def slices(self, vector: str, array):
        """Materialise the per-slot slices of a host array."""
        v = self.plan.vectors[vector]
        if v.copy:
            return [array] * len(self.slots)
        out = []
        for off, size in zip(self.offsets(vector), self.sizes(vector)):
            idx = [slice(None)] * array.ndim
            idx[v.partition_dim] = slice(off, off + size)
            out.append(array[tuple(idx)])
        return out

    def shares(self) -> List[float]:
        U = max(1, self.plan.domain_units)
        return [u / U for u in self.units]

    def layout(self) -> Tuple[Tuple[int, int], ...]:
        """Planned ``(start, units)`` domain range per slot, in order.

        This is the canonical segment layout of a fault-free run; the
        executor compares it against a :class:`ResidentPartition`'s
        realised layout to decide whether slot-local outputs can be
        handed straight to the next SCT (zero-copy chaining) or must be
        merged first.
        """
        out: List[Tuple[int, int]] = []
        acc = 0
        for u in self.units:
            out.append((acc, u))
            acc += u
        return tuple(out)

    def same_layout(self, other: "ConcretePartitioning") -> bool:
        """True when both partitionings tile the same domain identically."""
        return (self.plan.domain_units == other.plan.domain_units
                and list(self.units) == list(other.units))


def build_plan(sct: SCT, shapes: Dict[str, Tuple[int, ...]]) -> DecompositionPlan:
    """Derive the locality-aware decomposition plan for an SCT.

    ``shapes`` maps every free input (and, where they differ from inputs,
    produced vectors) to its global shape.  Output shapes not given are
    inferred to inherit their producing kernel's partition behaviour.
    """
    specs = sct.kernel_specs()
    vectors: Dict[str, VectorPlan] = {}
    units: Optional[int] = None
    unit_witness = ""
    for spec in specs:
        for a in spec.vectors:
            shape = shapes.get(a.name)
            if shape is None:
                continue
            copy = a.transfer is Transfer.COPY
            extent = int(shape[a.partition_dim]) if not copy else int(
                shape[a.partition_dim])
            if not copy:
                if extent % a.epu != 0:
                    raise DecompositionError(
                        f"vector {a.name}: extent {extent} not a multiple of "
                        f"epu {a.epu}")
                u = extent // a.epu
                if units is None:
                    units, unit_witness = u, a.name
                elif u != units:
                    raise DecompositionError(
                        "locality violation: vectors "
                        f"'{unit_witness}' ({units} units) and '{a.name}' "
                        f"({u} units) disagree on the partition domain")
            prev = vectors.get(a.name)
            if prev is not None:
                if (prev.partition_dim != a.partition_dim
                        or prev.copy != copy
                        or (not copy and prev.epu != a.epu)):
                    raise DecompositionError(
                        f"vector {a.name}: conflicting partition specs "
                        "between kernels sharing the edge")
                continue
            vectors[a.name] = VectorPlan(
                name=a.name, partition_dim=a.partition_dim, epu=a.epu,
                copy=copy, extent=extent,
                units=0 if copy else extent // a.epu)
    if units is None:
        raise DecompositionError("SCT has no partitionable vector with a "
                                 "known shape")
    return DecompositionPlan(sct_id=sct.unique_id(), domain_units=units,
                             vectors=vectors, specs=specs)


def validate(plan: DecompositionPlan, part: ConcretePartitioning) -> None:
    """Check the paper's constraint system on a concrete partitioning."""
    for name, v in plan.vectors.items():
        if v.copy:
            continue
        sizes = part.sizes(name)
        if sum(sizes) != v.extent:
            raise DecompositionError(f"{name}: partitions do not cover domain")
        for j, (slot, size) in enumerate(zip(part.slots, sizes)):
            for spec in plan.specs:
                try:
                    a = spec.arg(name)
                except KeyError:
                    continue
                nu = spec.nu(name)
                if a.epu % nu != 0:
                    raise DecompositionError(
                        f"{name}/K={spec.name}: epu%nu != 0")
                if size % (a.epu // nu) != 0:
                    raise DecompositionError(
                        f"{name}/K={spec.name}/exec{j}: size {size} not a "
                        f"multiple of epu/nu={a.epu // nu}")
                wgs = slot.wgs.get(spec.name)
                if wgs and not part.relaxed and size % wgs != 0:
                    raise DecompositionError(
                        f"{name}/K={spec.name}/exec{j}: size {size} not a "
                        f"multiple of wgs={wgs}")
