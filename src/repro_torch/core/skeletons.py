"""Skeleton Computational Trees (SCTs) — the Marrow library layer in PyTorch.

A Marrow computation is a tree of skeleton constructions (paper Fig. 1):
``Pipeline``, ``Loop``, ``Map`` and ``MapReduce`` nodes, whose leaves are
``KernelNode`` objects wrapping actual compute kernels.  Per-device
evaluation is depth-first and sequential (paper Sec. 2); across devices
the tree executes under an extended SPMD model where every work partition
runs the whole tree over its slice of the data (paper Sec. 3.1).

PyTorch adaptation: a *kernel* is any function on tensors (possibly one
that launches a hand-written CUDA kernel on the current stream); ``Loop``
is an eager Python loop whose stoppage condition is evaluated on the
host; ``Map`` declares independent-partition semantics (one body
instance per partition in the executor); ``MapReduce`` composes a Map
with a device- or host-placed reduction.  Data flows between kernels
through a named environment — two kernels naming the same vector share an
SCT *edge*, which the locality-aware decomposition keeps resident on the
device.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.spec import ArgSpec, KernelSpec, Trait, Transfer

Env = Dict[str, Any]

_node_counter = itertools.count()


@dataclasses.dataclass
class PartitionInfo:
    """Partition-bound information for Size/Offset traits (paper Sec. 3.4)."""

    size: Any  # elements of the partition along the partition dim
    offset: Any  # offset of the partition w.r.t. the whole domain


class SCT:
    """Base class for every Marrow tree element."""

    name: str

    def apply(self, env: Env) -> Env:
        raise NotImplementedError

    def children(self) -> Sequence["SCT"]:
        return ()

    # -- introspection used by the decomposition / scheduler ---------------
    def kernel_specs(self) -> List[KernelSpec]:
        specs: List[KernelSpec] = []
        for c in self.children():
            specs.extend(c.kernel_specs())
        return specs

    def leaves(self) -> List["KernelNode"]:
        out: List[KernelNode] = []
        for c in self.children():
            out.extend(c.leaves())
        return out

    def free_inputs(self) -> List[ArgSpec]:
        """Vector/scalar args read by the tree before any kernel produces them."""
        produced: set = set()
        free: Dict[str, ArgSpec] = {}
        for leaf in self.leaves():
            for a in leaf.spec.inputs:
                if a.name not in produced and a.name not in free \
                        and a.trait is Trait.NONE:
                    free[a.name] = a
            for a in leaf.spec.outputs:
                produced.add(a.name)
        return list(free.values())

    def output_names(self) -> List[str]:
        names: List[str] = []
        for leaf in self.leaves():
            for a in leaf.spec.outputs:
                if a.name not in names:
                    names.append(a.name)
        return names

    def unique_id(self) -> str:
        """Structural identifier of the SCT (KB key; paper Sec. 3.2.1)."""
        return self._structure()

    def _structure(self) -> str:
        inner = ",".join(c._structure() for c in self.children())
        return f"{type(self).__name__.lower()}({inner})"

    # -- convenience --------------------------------------------------------
    def as_function(self) -> Callable[..., Env]:
        """Pure function env -> env."""
        def fn(env: Env) -> Env:
            return self.apply(dict(env))
        return fn

    def run(self, executor, **arrays):
        """Asynchronous execution request (paper Table 1). Returns a Future."""
        return executor.run(self, **arrays)


class KernelNode(SCT):
    """Leaf node: one computational kernel with a declared interface.

    ``fn`` is a pure function taking the input arguments positionally, in
    ``spec.inputs`` order, and returning one array (or a tuple matching
    ``spec.outputs``).
    """

    def __init__(self, fn: Callable[..., Any], spec: KernelSpec):
        self.fn = fn
        self.spec = spec
        self.name = f"{spec.name}#{next(_node_counter)}"

    def children(self) -> Sequence[SCT]:
        return ()

    def kernel_specs(self) -> List[KernelSpec]:
        return [self.spec]

    def leaves(self) -> List["KernelNode"]:
        return [self]

    def _structure(self) -> str:
        return f"kernel[{self.spec.name}]"

    def apply(self, env: Env) -> Env:
        args = []
        for a in self.spec.inputs:
            if a.trait is Trait.SIZE:
                info: Optional[PartitionInfo] = env.get("__partition__")
                args.append(info.size if info is not None
                            else _domain_size(env, self.spec))
            elif a.trait is Trait.OFFSET:
                info = env.get("__partition__")
                args.append(info.offset if info is not None else 0)
            else:
                if a.name not in env:
                    raise KeyError(
                        f"kernel {self.spec.name}: missing input '{a.name}'")
                args.append(env[a.name])
        out = self.fn(*args)
        if len(self.spec.outputs) == 1:
            out = (out,)
        if len(out) != len(self.spec.outputs):
            raise ValueError(
                f"kernel {self.spec.name} returned {len(out)} outputs, "
                f"spec declares {len(self.spec.outputs)}")
        for a, val in zip(self.spec.outputs, out):
            env[a.name] = val
        return env


def _domain_size(env: Env, spec: KernelSpec):
    for a in spec.inputs:
        if a.partitionable and a.name in env:
            return env[a.name].shape[a.partition_dim]
    return 0


class Pipeline(SCT):
    """Pipeline of control- and data-dependent SCTs (depth-first order)."""

    def __init__(self, *stages: SCT):
        if len(stages) < 1:
            raise ValueError("Pipeline needs at least one stage")
        self.stages = list(stages)
        self.name = f"pipeline#{next(_node_counter)}"

    def children(self) -> Sequence[SCT]:
        return self.stages

    def apply(self, env: Env) -> Env:
        for s in self.stages:
            env = s.apply(env)
        return env


@dataclasses.dataclass
class LoopState:
    """State of a Marrow Loop (paper Sec. 2.1 / 3.1).

    ``init``: extra state variables (name -> tensor) carried across
    iterations.  ``cond``: stoppage condition over the environment,
    evaluated on the host before every iteration (stage 1, as in the
    paper).  ``update``: state-update applied after each body execution
    (stage 3).  ``global_sync``: whether the update requires all-device
    synchronisation (a cross-partition barrier; keeps the Loop's edges
    replicated).  ``max_iterations``: when set and ``cond is None`` the
    loop is a *for* loop with a static trip count.
    """

    init: Dict[str, Any] = dataclasses.field(default_factory=dict)
    cond: Optional[Callable[[Env], Any]] = None
    update: Optional[Callable[[Env], Env]] = None
    global_sync: bool = False
    max_iterations: Optional[int] = None


class Loop(SCT):
    """*while* / *for* loop over an SCT body."""

    def __init__(self, body: SCT, state: LoopState):
        if state.cond is None and state.max_iterations is None:
            raise ValueError("Loop needs a cond or a max_iterations")
        self.body = body
        self.state = state
        self.name = f"loop#{next(_node_counter)}"

    def children(self) -> Sequence[SCT]:
        return (self.body,)

    def apply(self, env: Env) -> Env:
        env = dict(env)
        env.update(self.state.init)
        env = _ensure_body_outputs(self.body, env, self.state)

        def one_iter(e: Env) -> Env:
            e = self.body.apply(dict(e))
            if self.state.update is not None:
                e = self.state.update(e)
            return e

        if self.state.cond is None:
            # static trip-count for loop
            for _ in range(self.state.max_iterations):
                env = one_iter(env)
            return env

        # while loop: the condition is read back to the host each round
        iters = 0
        while bool(self.state.cond(env)):
            if self.state.max_iterations is not None and \
                    iters >= self.state.max_iterations:
                break
            env = one_iter(env)
            iters += 1
        return env


def _ensure_body_outputs(body: SCT, env: Env, state: LoopState) -> Env:
    """Pre-materialise body outputs, so a loop that runs zero iterations
    still returns every name its body produces (as zeros).

    The shapes come from a probe: the body runs once on ``meta`` tensors
    (shape and dtype only, no data, no kernel launch).  A body whose
    outputs are known without running it, and are all in ``env`` already,
    needs no probe."""
    known = _static_outputs(body)
    if known is not None and all(k in env for k in known):
        return env
    probe = {k: torch.empty_like(v, device="meta")
             if isinstance(v, torch.Tensor) else v for k, v in env.items()}
    device = next((v.device for v in env.values()
                   if isinstance(v, torch.Tensor)), torch.device("cpu"))
    shapes = body.apply(dict(probe))
    for k, sd in shapes.items():
        if k not in env and isinstance(sd, torch.Tensor):
            env[k] = torch.zeros(sd.shape, dtype=sd.dtype, device=device)
    return env


def _static_outputs(sct: SCT) -> Optional[List[str]]:
    """The names ``sct.apply`` adds to an environment, when they follow
    from the specs alone: no nested Loop (whose state and update add
    names) and no MapReduce (whose reduction does)."""
    stack: List[SCT] = [sct]
    while stack:
        n = stack.pop()
        if isinstance(n, (Loop, MapReduce)):
            return None
        stack.extend(n.children())
    return sct.output_names()


class Map(SCT):
    """Application of an SCT upon independent partitions of the input.

    Semantically a marker: the wrapped tree may be partitioned along every
    argument's partition dimension with no cross-partition dependencies.
    The executor runs one body instance per partition.
    """

    def __init__(self, tree: SCT):
        self.tree = tree
        self.name = f"map#{next(_node_counter)}"

    def children(self) -> Sequence[SCT]:
        return (self.tree,)

    def apply(self, env: Env) -> Env:
        return self.tree.apply(env)


class MapReduce(SCT):
    """Map extended with a reduction stage (paper Sec. 2.1).

    The reduction is either another SCT (device-side) or a plain Python /
    torch function (host-side in the paper; flagged so the decomposition
    knows the reduce edge crosses partitions).  ``axis``:
    the reduced tensor dimension of the map output.
    """

    def __init__(self, map_stage: SCT,
                 reduction: Union[SCT, Callable[[Any], Any]],
                 *, out_name: Optional[str] = None, axis: int = 0):
        self.map_stage = Map(map_stage) if not isinstance(map_stage, Map) else map_stage
        self.reduction = reduction
        self.axis = axis
        self.out_name = out_name
        self.name = f"mapreduce#{next(_node_counter)}"

    def children(self) -> Sequence[SCT]:
        if isinstance(self.reduction, SCT):
            return (self.map_stage, self.reduction)
        return (self.map_stage,)

    @property
    def host_side_reduction(self) -> bool:
        return not isinstance(self.reduction, SCT)

    def apply(self, env: Env) -> Env:
        env = self.map_stage.apply(env)
        if isinstance(self.reduction, SCT):
            return self.reduction.apply(env)
        # function reduction over the (single) map output
        names = self.map_stage.output_names()
        if len(names) != 1:
            raise ValueError("function-reduction MapReduce requires a single "
                             f"map output, got {names}")
        src = names[0]
        dst = self.out_name or f"{src}_reduced"
        env[dst] = self.reduction(env[src])
        return env


def kernel(fn: Callable[..., Any], *, name: str,
           inputs: Sequence[ArgSpec], outputs: Sequence[ArgSpec],
           work_group_size: Optional[int] = None, work_per_thread: int = 1,
           flops_per_item: float = 1.0, bytes_per_item: float = 4.0,
           local_mem_per_item: float = 0.0) -> KernelNode:
    """Convenience constructor mirroring the paper's ``OpenCLKernel``."""
    spec = KernelSpec(name=name, inputs=tuple(inputs), outputs=tuple(outputs),
                      work_group_size=work_group_size,
                      work_per_thread=work_per_thread,
                      flops_per_item=flops_per_item,
                      bytes_per_item=bytes_per_item,
                      local_mem_per_item=local_mem_per_item)
    return KernelNode(fn, spec)
