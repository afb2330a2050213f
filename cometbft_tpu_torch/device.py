"""Device resolution: the port runs on the GPU unless told otherwise."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device with no GPU present raises:
    nothing falls back to the CPU silently. ``device="cpu"`` selects
    the plain PyTorch versions of every kernel."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; cometbft_tpu_torch runs on the "
            "GPU by default — pass device='cpu' for the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
