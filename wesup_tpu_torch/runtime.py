"""Device and dtype resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it raises when no CUDA device is present rather
    than carrying on quietly on the CPU.  Pass ``device="cpu"`` to run the
    plain versions of the kernels on the host (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the host")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


def compute_dtype(config) -> torch.dtype:
    """The config's ``compute_dtype`` string as a torch dtype."""
    names = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if config.compute_dtype not in names:
        raise ValueError(f"unknown compute_dtype {config.compute_dtype!r}")
    return names[config.compute_dtype]
