"""The kernel loader's host side: ptxas report parsing, input checks,
and a clean failure where nvcc is missing (no silent fallback)."""

import os
import shutil
import subprocess

import pytest
import torch

from cometbft_tpu_torch import kernels

PTXAS_LOG = """\
ptxas info    : 0 bytes gmem, 480 bytes cmem[3]
ptxas info    : Compiling entry function '_Z13ladder_kernelILb1EEvPKh' for 'sm_90a'
ptxas info    : Function properties for _Z13ladder_kernelILb1EEvPKh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, 448 bytes cmem[0]
ptxas info    : Function properties for _Z6fe_mul2FeS_
    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_Z13ladder_kernelILb0EEvPKh' for 'sm_90a'
ptxas info    : Function properties for _Z13ladder_kernelILb0EEvPKh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 162 registers, 3072 bytes smem, 448 bytes cmem[0]
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _Z17decompress_kernelPKhiiPiiPh
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                      /* 0x00000a00ff017b82 */
        /*0010*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ;              /* 0x0000000504027225 */
        /*0020*/              @!P0 IMAD.WIDE R6, R4, R5, R2 ;                  /* 0x0000000504068225 */
        /*0030*/                   IMAD R8, R4, R5, RZ ;                       /* 0x0000000504087224 */
        /*0040*/                   STL.64 [R1], R2 ;                           /* 0x0000000201007387 */
        /*0050*/                   CALL.REL.NOINC 0x100 ;                      /* 0x0000000000007944 */
        /*0060*/                   EXIT ;                                      /* 0x000000000000794d */
\t\t..........

\t\tFunction : _Z13ladder_kernelILb1EEvPKh
        /*0000*/                   LDS.128 R4, [R2] ;                          /* 0x0000000002047984 */
        /*0010*/                   STS.128 [R2+0x30], R8 ;                     /* 0x0000300802007388 */
        /*0020*/                   WARPSYNC R3 ;                               /* 0x0000000300007348 */
        /*0030*/                   LDSM.16.M88.4 R12, [R2] ;                   /* 0x000000000204783b */
        /*0040*/                   SHFL.IDX PT, R5, R4, R7, 0x1f ;             /* 0x00001f0704057589 */
        /*0050*/                   LDG.E.U8 R9, desc[UR4][R2.64] ;             /* 0x0000000402097981 */
        /*0060*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;               /* 0x0000000000007b1d */
"""


def test_ptxas_summary_per_function():
    got = kernels._ptxas_summary(PTXAS_LOG)
    assert got == [
        {"function": "_Z13ladder_kernelILb1EEvPKh", "stack_frame": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 168, "smem": 0},
        {"function": "_Z6fe_mul2FeS_", "stack_frame": 16, "spill_stores": 8,
         "spill_loads": 4},
        {"function": "_Z13ladder_kernelILb0EEvPKh", "stack_frame": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 162, "smem": 3072},
    ]


def test_sass_counts_per_function():
    got = kernels.sass_counts(SASS)
    assert got == {
        "_Z17decompress_kernelPKhiiPiiPh": {
            "IMAD.WIDE": 2, "SHFL": 0, "LDS": 0, "STS": 0, "LDG": 0, "BAR": 0,
            "LDL": 0, "STL": 1, "CALL": 1, "total": 7},
        "_Z13ladder_kernelILb1EEvPKh": {
            "IMAD.WIDE": 0, "SHFL": 1, "LDS": 1, "STS": 1, "LDG": 1, "BAR": 1,
            "LDL": 0, "STL": 0, "CALL": 0, "total": 7},
    }


def test_cuobjdump_absent_is_reported(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kernels.importlib.util, "find_spec", lambda name: None)
    assert kernels._cuobjdump() is None
    assert kernels.sass("ladder") == "cuobjdump not found"


def test_cuobjdump_timeout_is_reported(monkeypatch):
    def hang(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(kernels, "_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(kernels.subprocess, "run", hang)
    assert kernels.sass("ladder", timeout=3) == "cuobjdump timed out after 3 s"


def test_a_library_is_stale_only_after_its_own_sources(monkeypatch, tmp_path):
    """A kernel is rebuilt when its source or the shared field layer is
    newer than its library, and not for another kernel's source."""
    csrc, build = tmp_path / "csrc", tmp_path / "kernels"
    csrc.mkdir(), build.mkdir()
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    for src in (*kernels.SOURCES.values(), "fe25519.cuh"):
        (csrc / src).write_text("")
        os.utime(csrc / src, (100, 100))
    assert kernels._stale("ladder")  # not built
    (build / "libladder.so").write_text("")
    os.utime(build / "libladder.so", (200, 200))
    assert not kernels._stale("ladder")
    os.utime(csrc / "hash_digits.cu", (300, 300))
    assert not kernels._stale("ladder")
    os.utime(csrc / "fe25519.cuh", (300, 300))
    assert kernels._stale("ladder")
    os.utime(csrc / "fe25519.cuh", (100, 100))
    os.utime(csrc / "ladder.cu", (300, 300))
    assert kernels._stale("ladder")


def test_require_rejects_what_a_kernel_does_not_take():
    t = torch.zeros((64, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="on cuda"):
        kernels.require(t, torch.uint8, (64, 8))  # a CPU tensor
    kernels.require_rows(t, 8)
    with pytest.raises(ValueError, match="rows 16 apart"):
        kernels.require_rows(t, 16)
    with pytest.raises(ValueError, match="lanes contiguous"):
        kernels.require_rows(t.t(), 64)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_all(force=True)
    assert not (tmp_path / "kernels").exists()
