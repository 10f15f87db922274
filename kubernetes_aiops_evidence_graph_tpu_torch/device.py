"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``. The default is the CUDA
device; a caller who wants the CPU (the tests, the plain versions of the
kernels) asks for it by name. There is no fallback: without CUDA the
default raises instead of quietly scoring on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` → the CPU; anything else as given.
    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
