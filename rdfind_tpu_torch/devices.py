"""Where the port runs: CUDA unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point computes on.

    ``None`` means the CUDA card, and raises when there is none: the port never
    carries on quietly on the CPU.  ``"cpu"`` runs every kernel's plain PyTorch
    version (the tests' configuration).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           f"available")
    return dev
