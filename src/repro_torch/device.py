"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``"cuda"`` unless the caller asks for another device. Raises when a
    CUDA device is asked for and none is present: there is no silent move
    to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device unless told otherwise and none "
            "is available; pass device='cpu' to run the plain versions of the "
            "kernels on the CPU")
    return dev
