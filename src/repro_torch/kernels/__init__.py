"""Hand-written CUDA kernels for the paper's benchmark suite (Sec. 4).

Layout:
  saxpy.py, filter_pipeline.py, segmentation.py, nbody.py
                 wrappers that launch ``csrc/*.cu`` on the current stream
                 and count their launches
  ops.py         entry points: a CUDA tensor -> the kernel, else the
                 plain version
  ref.py         plain PyTorch versions of the same functions
  _build.py      nvcc build of ``csrc/`` into one ctypes library
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
