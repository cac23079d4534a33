"""Device resolution shared by the port's entry points.

Every entry point takes ``device="cuda"`` by default.  A CUDA request on
a host without a usable card raises instead of silently running the
plain PyTorch path; callers that want the CPU ask for ``"cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but "
                f"torch.cuda.is_available() is False; pass device='cpu' "
                f"to run the plain PyTorch path")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: expected "
                         f"'cuda' or 'cpu'")
    return dev
