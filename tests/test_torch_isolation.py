"""The port stands alone, and its entry points refuse a missing GPU.

- A fresh interpreter imports every module of cometbft_tpu_torch and
  finds neither ``jax`` nor any ``cometbft_tpu.`` module loaded.
- With no CUDA device (this test lane), calling an entry point without
  ``device="cpu"`` raises instead of falling back to the CPU.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cometbft_tpu_torch import device as port_device
from cometbft_tpu_torch.crypto import batch
from cometbft_tpu_torch.ops import ed25519 as ed
from cometbft_tpu_torch.types import validation as V

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import cometbft_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "cometbft_tpu" or m.startswith("cometbft_tpu."))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_reference_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 15, proc.stdout


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    item = [(b"m", bytes(32), bytes(64))]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ed.verify_batch(item)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.create_batch_verifier()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        V.verify_commits_coalesced("c", [(None, None, 1, None)])
    assert port_device.resolve("cpu") == torch.device("cpu")
    # zero key and zero R are small-order points: valid under ZIP-215
    assert ed.verify_batch(item, device="cpu").tolist() == [True]
