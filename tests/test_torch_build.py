"""The kernel build's host-side helpers, on the CPU: the library's name,
which hashes the sources and their headers; the ptxas report that
``chip_smoke.py`` checks for spills; and the alignment check that sends
bf16 grouped GEMMs to the TMA kernel or to the WMMA kernel."""
import pytest
import torch

from repro_torch.kernels import _build, moe_gemm

LOG = """== flash_attention.cu
ptxas info    : Compiling entry function '_Z5flashILi80EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z5flashILi80EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 206 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z4gemmv' for 'sm_90a'
ptxas info    : Function properties for _Z4gemmv
    24 bytes stack frame, 40 bytes spill stores, 56 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 392 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    assert _build.ptxas_report(LOG) == {
        "_Z5flashILi80EEvv": {"registers": 206, "spill_stores": 0,
                              "spill_loads": 0},
        "_Z4gemmv": {"registers": 168, "spill_stores": 40,
                     "spill_loads": 56}}
    assert _build.ptxas_report("") == {}


@pytest.mark.parametrize("d,f,offset,tma", [
    (1536, 512, 0, True),     # the model's shapes
    (512, 1536, 0, True),
    (65, 41, 0, False),       # rows not a multiple of 16 bytes
    (136, 41, 0, False),
    (136, 200, 1, False),     # a view one element into its storage
    (0, 8, 0, False),         # nothing to contract
])
def test_tma_rows_by_alignment(d, f, offset, tma):
    base = torch.zeros(2 * 3 * d + 8, dtype=torch.bfloat16)
    x = base[offset:offset + 2 * 3 * d].view(2, 3, d)
    w = torch.zeros(2, d, f, dtype=torch.bfloat16)
    assert moe_gemm.tma_rows(x, w) is tma


def test_library_name_hashes_sources_and_headers(tmp_path):
    """An edited header (csrc/flash_mma.cuh is shared by the flash
    kernels) gives a new library name, so the kernels are rebuilt; an
    untouched tree keeps its name, so its library is loaded as built."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.library_name(tmp_path)
    assert _build.library_name(tmp_path) == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_name(tmp_path) != first
    assert _build.library_name().startswith("librepro_torch_kernels-")


def c_entries():
    """Each ``extern "C"`` entry of csrc/*.cu -> its parameters' C types
    (pointer or not), from the source."""
    import re
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{', text,
                             re.S):
            params = [p.strip() for p in m.group(2).split(",")]
            out[m.group(1)] = ["*" in p or p.startswith("cudaStream_t")
                               for p in params]
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_the_c_entry(name):
    """ctypes passes what SIGNATURES declares: each C entry's parameters,
    one for one, a pointer (or the stream) where the source takes one."""
    entries = c_entries()
    assert set(entries) == set(_build.SIGNATURES)
    pointer = [t is _build.ctypes.c_void_p for t in _build.SIGNATURES[name]]
    assert pointer == entries[name]
