"""Build and load the hand-written CUDA kernels under ``csrc/``.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) with
``nvcc``, one process per source, all started together, and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build happens at the first launch, into
``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name that hashes the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import: a machine without ``nvcc`` or a card can
import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: C entry point -> argument types (each returns its cudaError_t as int)
SIGNATURES: Dict[str, List] = {
    "saxpy_f32": [_P, _P, _P, _F, _L, _I, _P],
    "segmentation_f32": [_P, _P, _L, _F, _F, _I, _P],
    "filter_pipeline_f32": [_P, _P, _I, _I, _I, _F, _F, _I, _P],
    "nbody_acc_f32": [_P, _I, _P, _P, _I, _P, _F, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build printed (``-Xptxas -v``: registers, shared memory)
build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def build() -> Path:
    """Compile the sources (if not built yet); returns the library path."""
    global build_log
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"librepro_torch_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(f"== {s.name}\n{log}"
                            for s, log in zip(sources, logs))
        failed = [s.name for s, p in zip(sources, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        part = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(part), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        os.replace(part, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


class LaunchCounter:
    """Launches of one kernel: a plain integer, safe across slot threads."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.value += 1

    def reset(self) -> None:
        with self._lock:
            self.value = 0


def check_launch(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and ``torch.cuda.synchronize`` would not report it)."""
    if err:
        raise RuntimeError(f"CUDA error {err} launching {kernel}")


def require(t: torch.Tensor, name: str, *, ndim: Optional[int] = None,
            device: Optional[torch.device] = None) -> None:
    """Wrapper-side checks: a contiguous float32 CUDA tensor (of ``ndim``
    dimensions, on ``device``)."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, "
                         f"got shape {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
