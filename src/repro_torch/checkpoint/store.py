"""Checkpoint store — atomic, asynchronous, keep-K, restorable by both
packages.

The port's counterpart of the JAX package's ``checkpoint/store.py``, with
the same on-disk layout: ``<root>/step_<12 digits>/`` holds ``meta.json``
(step, payload, process count), a ``COMMITTED`` marker and
``proc<5 digits>/`` with ``arrays.npz`` (one array per leaf, its path with
"|" for "/"; bfloat16 stored as its uint16 bits) and ``structure.json``
(the leaf paths and the bfloat16 leaves' dtype).  A leaf's path is the
JAX package's: dict keys, ``.field`` for a named tuple's field, indices
for a list; ``None`` holds no leaf.  A step directory is written under a
``.tmp`` name and ``os.replace``d into place after every file is written;
at most one asynchronous save is in flight; steps beyond ``keep`` are
deleted after a commit; restore skips corrupt or partial directories.

:func:`state_to_tree` and :func:`state_from_tree` map the port's
:class:`~repro_torch.runtime.train.TrainState` to the JAX package's train
state tree (parameters stacked by layer under the JAX names, as
``repro.runtime.train.TrainState`` holds them) and back, so each package
restores the other's checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import OptState, split_name


@dataclasses.dataclass
class CheckpointMeta:
    step: int
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Flat (de)serialisation of trees
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()
            ) -> List[Tuple[str, Any]]:
    """(path, leaf) in the JAX package's flattening order: dict keys
    sorted, named-tuple fields in order (``.name``), list items by index."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _leaves(getattr(tree, f), prefix + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """A tensor leaf as a numpy array, bfloat16 as its uint16 bits, and the
    name of the dtype those bits hold (None for a numpy dtype)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def save_pytree(tree: Any, directory: str) -> None:
    """Write one tree as an .npz + structure manifest (not atomic alone)."""
    os.makedirs(directory, exist_ok=True)
    payload, dtypes, keys = {}, {}, []
    for k, leaf in _leaves(tree):
        arr, dtype = _to_numpy(leaf)
        if dtype:
            dtypes[k] = dtype
        payload[k.replace("/", "|")] = arr
        keys.append(k)
    np.savez(os.path.join(directory, "arrays.npz"), **payload)
    with open(os.path.join(directory, "structure.json"), "w") as f:
        json.dump({"keys": keys, "dtypes": dtypes}, f)


def _rebuild(like: Any, prefix: Tuple[str, ...], flat: Dict[str, Any]):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, prefix + (str(k),), flat)
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), prefix + (f".{f}",),
                                     flat) for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, prefix + (str(i),), flat)
                          for i, v in enumerate(like))
    return flat["/".join(prefix)]


def load_pytree(directory: str, like: Any) -> Any:
    """Load into the structure of ``like`` (a tree of tensors): each leaf a
    CPU tensor of the ``like`` leaf's dtype."""
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        stored = {k.replace("|", "/"): z[k] for k in z.files}
    with open(os.path.join(directory, "structure.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    flat = {}
    for key, leaf in _leaves(like):
        if key not in stored:
            raise KeyError(f"checkpoint missing leaf '{key}'")
        arr = stored[key]
        want = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf '{key}': checkpoint shape {arr.shape} "
                             f"!= expected {want}")
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if dtypes.get(key) == "bfloat16" else torch.from_numpy(arr))
        flat[key] = t.to(leaf.dtype)
    return _rebuild(like, (), flat)


# ---------------------------------------------------------------------------
# The port's train state <-> the JAX package's tree
# ---------------------------------------------------------------------------

def named_to_tree(named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors by port parameter name -> the JAX package's nested dict of
    CPU tensors, each layer leaf stacked over its layer indices."""
    groups: Dict[Tuple[str, ...], List] = defaultdict(list)
    for name, t in named.items():
        path, index = split_name(name)
        groups[path].append((index, t.detach().cpu()))
    tree: Dict[str, Any] = {}
    for path, items in groups.items():
        items.sort(key=lambda it: it[0])
        leaf = items[0][1]
        if items[0][0]:
            shape = tuple(max(i[d] for i, _ in items) + 1
                          for d in range(len(items[0][0])))
            leaf = torch.stack([t for _, t in items]).reshape(
                shape + tuple(items[0][1].shape))
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return tree


def tree_to_named(tree: Dict[str, Any], names) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`named_to_tree` for the parameter ``names``:
    each name's slice of its stacked leaf (a tensor or an array)."""
    out = {}
    for name in names:
        path, index = split_name(name)
        node = tree
        for p in path:
            node = node[p]
        leaf = node if isinstance(node, torch.Tensor) else \
            torch.from_numpy(np.array(node))
        out[name] = leaf[index] if index else leaf
    return out


def state_to_tree(state) -> Any:
    """The port's ``TrainState`` as the JAX package's train state: a named
    tuple ``(params, opt=(step, m, v), compression=(error,) or None)`` of
    nested dicts under the JAX names, layer leaves stacked."""
    named = dict(state.params.named_parameters())
    comp = None if state.compression is None else \
        _JaxCompression(error=named_to_tree(state.compression.error))
    return _JaxTrainState(
        params=named_to_tree(named),
        opt=_JaxOptState(step=state.opt.step.detach().to(torch.int32),
                         m=named_to_tree(state.opt.m),
                         v=named_to_tree(state.opt.v)),
        compression=comp)


@torch.no_grad()
def state_from_tree(state, tree: Any):
    """Write the JAX-layout train state ``tree`` (as :func:`load_pytree`
    gives it, like :func:`state_to_tree`) into the port's ``state`` in
    place, each
    leaf cast to its dtype and moved to its device; returns the new
    ``TrainState`` (the step comes from the tree)."""
    model = state.params
    named = dict(model.named_parameters())

    def copy(dst: Dict[str, torch.Tensor], src_tree):
        for k, v in tree_to_named(src_tree, dst).items():
            dst[k].copy_(v.to(dst[k].dtype))

    copy(named, tree.params)
    copy(state.opt.m, tree.opt.m)
    copy(state.opt.v, tree.opt.v)
    if state.compression is not None and tree.compression is not None:
        copy(state.compression.error, tree.compression.error)
    step = torch.as_tensor(np.asarray(tree.opt.step), dtype=torch.int32)
    return type(state)(model, OptState(step=step, m=state.opt.m,
                                       v=state.opt.v), state.compression)


class _JaxOptState(NamedTuple):
    step: Any
    m: Any
    v: Any


class _JaxCompression(NamedTuple):
    error: Any


class _JaxTrainState(NamedTuple):
    params: Any
    opt: Any
    compression: Any = None


# ---------------------------------------------------------------------------
# Manager
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Atomic, asynchronous, keep-K checkpoints of one process's trees
    under ``root`` (the JAX package's layout)."""

    def __init__(self, root: str, *, keep: int = 3, process_index: int = 0):
        self.root = root
        self.keep = keep
        self.process = process_index
        os.makedirs(root, exist_ok=True)
        self._inflight: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:012d}")

    def _commit_marker(self, step_dir: str) -> str:
        return os.path.join(step_dir, "COMMITTED")

    def save(self, step: int, tree: Any, *, payload: Optional[Dict] = None,
             blocking: bool = False) -> None:
        """Snapshot ``tree`` to host memory, then write it on a background
        thread (or here, with ``blocking``).  ``payload``: small JSON
        metadata (data cursor, ...)."""
        self.wait()                                  # <=1 outstanding save
        host_tree = _rebuild(tree, (), {k: v.detach().to("cpu", copy=True)
                                        for k, v in _leaves(tree)})
        meta = CheckpointMeta(step=step, payload=payload or {})

        def work():
            self._write(step, host_tree, meta)

        if blocking:
            work()
        else:
            t = threading.Thread(target=work, daemon=True,
                                 name=f"ckpt-save-{step}")
            t.start()
            with self._lock:
                self._inflight = t

    def wait(self) -> None:
        with self._lock:
            t = self._inflight
            self._inflight = None
        if t is not None:
            t.join()

    def _write(self, step: int, host_tree: Any, meta: CheckpointMeta) -> None:
        final = self._step_dir(step)
        tmp = tempfile.mkdtemp(dir=os.path.dirname(final),
                               prefix=f".tmp_step{step}_")
        try:
            save_pytree(host_tree, os.path.join(tmp,
                                                f"proc{self.process:05d}"))
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": meta.step, "payload": meta.payload,
                           "process_count": 1}, f)
                f.flush()
                os.fsync(f.fileno())
            open(self._commit_marker(tmp), "w").close()
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and os.path.exists(
                    self._commit_marker(os.path.join(self.root, name))):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def restore_latest(self, like: Any
                       ) -> Optional[Tuple[Any, CheckpointMeta]]:
        """Newest committed checkpoint, or None.  Corrupt dirs are skipped."""
        for step in reversed(self.steps()):
            try:
                return self.restore(step, like)
            except (KeyError, ValueError, OSError, json.JSONDecodeError):
                continue
        return None

    def restore(self, step: int, like: Any) -> Tuple[Any, CheckpointMeta]:
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            m = json.load(f)
        tree = load_pytree(os.path.join(d, f"proc{self.process:05d}"), like)
        return tree, CheckpointMeta(step=m["step"], payload=m["payload"])

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
