"""The kernel loader's host side: ptxas report parsing, input checks,
and a clean failure where nvcc is missing (no silent fallback)."""

import shutil

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
ptxas info    : Used 162 registers, 448 bytes cmem[0]
"""


def test_ptxas_summary_per_function():
    got = kernels._ptxas_summary(PTXAS_LOG)
    assert got == [
        {"function": "_Z13ladder_kernelILb1EEvPKh", "spill_stores": 0,
         "spill_loads": 0, "registers": 168},
        {"function": "_Z6fe_mul2FeS_", "spill_stores": 8, "spill_loads": 4},
        {"function": "_Z13ladder_kernelILb0EEvPKh", "spill_stores": 0,
         "spill_loads": 0, "registers": 162},
    ]


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
