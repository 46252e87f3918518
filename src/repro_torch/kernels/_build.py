"""Build and load the hand-written CUDA kernels under ``csrc/``.

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) with
``nvcc``, one process per source, all started together, and the objects
are linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build happens at the first launch, into
``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), under a name that hashes the sources, the ``*.cuh``
headers beside them and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.

Nothing here runs at import: a machine without ``nvcc`` or a card can
import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

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
    # pos_i, n_i, pos_j, mass_j, n_j, acc, softening, scratch, splits,
    # split_len, device, stream
    "nbody_acc_f32": [_P, _I, _P, _P, _I, _P, _F, _P, _I, _I, _I, _P],
    # q, k, v, o, dtype, B, H, KV, Sq, Sk, hd, (b, h, s) strides of q, k,
    # v, o, scale, softcap, causal, window, kv_len, device, stream
    "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            *[_L] * 12, _F, _F, _I, _I, _I, _I, _P],
    # the same with the (B, H, Sq) float32 log-sum-exp (or NULL) after o
    "flash_attention_fwd_lse": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, *[_L] * 12, _F, _F, _I, _I, _I, _I, _P],
    # q, k, v, o, dO, lse, dq, dk, dv, D scratch, dtype, B, H, KV, Sq, Sk,
    # hd, (b, h, s) strides of q (= o, dO, dq) and of k (= v, dk, dv),
    # scale, softcap, causal, window, device, stream
    "flash_attention_bwd": [*[_P] * 10, *[_I] * 7, *[_L] * 6, _F, _F, _I,
                            _I, _I, _P],
    # x, dt, B, C, A, h0 (or NULL), y, h_out, scratch states, cb, cum,
    # dtype, batch, S, nh, hd, ds, chunk, device, stream
    "ssd_scan_fwd": [*[_P] * 11, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, dt, B, C, A, states, cum, dy, dh_final (or NULL), dx, ddt, dB,
    # dC, dA, dh0 (or NULL), scratch cb, g, cum64 (double), dCBp, dBsp,
    # dCsp, daK, daQ, T, rowp, hgp, dAp, batch, S, nh, hd, ds, chunk,
    # groups, device, stream
    "ssd_scan_bwd": [*[_P] * 27, *[_I] * 8, _P],
    # x, w, y, dtype, E, C, d, f, device, stream
    "grouped_matmul_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, w, y, E, C, d, f, device, stream (bfloat16)
    "grouped_matmul_wmma_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dy, w, dx, E, C, d, f, device, stream (bfloat16)
    "grouped_matmul_dx": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, dy, dw, E, C, d, f, device, stream (bfloat16)
    "grouped_matmul_dw": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # device table, tensors, chunk, chunks, partials, out, device, stream
    "adamw_sumsq": [_P, _I, _L, _L, _P, _P, _I, _P],
    # x, n, out, device, stream
    "adamw_sum": [_P, _I, _P, _I, _P],
    # device table, tensors, chunk, chunks, scale, lr, b1, 1 - b1, b2,
    # 1 - b2, b1c, b2c, eps, wd, device, stream
    "adamw_update": [_P, _I, _L, _L, _P, *[_F] * 9, _I, _P],
    # device table, tensors, chunk, chunks, mode, scale, device, stream
    "grad_accum": [_P, _I, _L, _L, _I, _F, _I, _P],
    # x, residual (or NULL), scale, y, sum (or NULL), dtype, scale dtype,
    # rows, d, eps, device, stream
    "rmsnorm_fwd": [*[_P] * 5, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, q_out, k_cache, v_cache, freqs (or NULL), position (or
    # NULL), position, dtype, cache dtype, B, H, KV, S, hd, rolling,
    # device, stream
    "rope_cache_write": [*[_P] * 8, _L, *[_I] * 8, _I, _P],
    # q, k_cache, v_cache, o, split outputs, split (max, sum) (both NULL
    # on the tensor cores), position (or NULL), position, dtype, cache
    # dtype, B, H, KV, S, hd, rows a split (0 on the tensor cores),
    # splits, window, scale, softcap, device, stream
    "decode_attention_fwd": [*[_P] * 7, _L, *[_I] * 10, _F, _F, _I, _P],
    # z, x, B, C, dt, dt_bias, A_log, D, conv_x, conv_B, conv_C, buffers
    # x, B, C, h, y, slot counters, dtype, buffer dtype, B, nh, hd, ds, K,
    # device, stream
    "ssd_decode_step": [*[_P] * 17, *[_I] * 7, _I, _P],
}
#: dtype code a C entry point takes for its tensors' element type
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the build of the library last built or loaded printed
#: (``-Xptxas -v``: registers, spills, shared memory)
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


def library_name(csrc: Path = CSRC) -> str:
    """The file name of ``csrc``'s library: a hash of the flags, the
    ``*.cu`` sources and the ``*.cuh`` headers beside them."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return f"librepro_torch_kernels-{digest.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC, build_dir: Path = BUILD_DIR) -> Path:
    """Compile the ``*.cu`` files of ``csrc`` (if not built yet) into
    ``build_dir``; returns the library path."""
    global build_log
    sources = sorted(csrc.glob("*.cu"))
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / library_name(csrc)
    log_path = lib.with_suffix(".log")
    if lib.exists():
        build_log = log_path.read_text() if log_path.exists() else ""
        return lib
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(f"== {s.name}\n{out}" for s, out in zip(sources, logs))
        failed = [s.name for s, p in zip(sources, procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        part = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(part), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        log_path.write_text(log)
        os.replace(part, lib)
    build_log = log
    return lib


def load(path: Path, names=tuple(SIGNATURES)) -> ctypes.CDLL:
    """Load a built kernel library and declare the argument types of its
    entry points ``names``."""
    lib = ctypes.CDLL(str(path))
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each compiled kernel, by mangled name,
    from an ``-Xptxas -v`` build log."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


class LaunchCounter:
    """Launches of one kernel: a plain integer, safe across slot threads.

    A wrapper adds one where it launches its kernel.  Under CUDA graph
    capture that launch is recorded, not run, and the graph's replays run
    it without the wrapper: the graph's owner takes the capture's counts
    back (:func:`counted_since`, :func:`add_counts` with ``sign=-1``) and
    adds them again at each replay, so a count is always of launches that
    ran (:class:`repro_torch.runtime.graphs.DecodeGraph`)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()
        _COUNTERS.append(self)

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0


#: every launch counter of the package, in the order they were made
_COUNTERS: List[LaunchCounter] = []


def launch_counts() -> Dict[LaunchCounter, int]:
    """Every counter's value now."""
    return {c: c.value for c in _COUNTERS}


def counted_since(before: Dict[LaunchCounter, int]
                  ) -> Dict[LaunchCounter, int]:
    """What each counter gained since :func:`launch_counts` gave
    ``before`` (counters that gained nothing left out)."""
    return {c: c.value - before.get(c, 0) for c in _COUNTERS
            if c.value != before.get(c, 0)}


def add_counts(counts: Dict[LaunchCounter, int], sign: int = 1) -> None:
    """Add (``sign`` 1) or take back (-1) a set of launches."""
    for c, n in counts.items():
        c.add(sign * n)


def check_launch(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and ``torch.cuda.synchronize`` would not report it)."""
    if err:
        raise RuntimeError(f"CUDA error {err} launching {kernel}")


def require(t: torch.Tensor, name: str, *, ndim: Optional[int] = None,
            device: Optional[torch.device] = None,
            dtypes: Tuple[torch.dtype, ...] = (torch.float32,),
            contiguous: bool = True) -> None:
    """Wrapper-side checks: a CUDA tensor of one of ``dtypes`` (float32
    unless the caller allows more), contiguous unless the caller takes
    strides (of ``ndim`` dimensions, on ``device``)."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be "
                         f"{' or '.join(str(d) for d in dtypes)}, "
                         f"got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, "
                         f"got shape {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
