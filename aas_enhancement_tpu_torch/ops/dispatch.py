"""Which implementation a tensor takes, and what a kernel accepts.

A CUDA tensor runs the hand-written kernel or raises; a CPU tensor runs the
kernel's plain PyTorch version.  No other device has a path.  Entry points
take ``device="cuda"`` by default and resolve it with ``resolve_device``,
which raises when no GPU is there.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """A device name -> torch.device.  The port's entry points run on the card
    unless the caller asks for the CPU: a CUDA device without a GPU is an
    error, never a quiet run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is available "
                           "(pass device 'cpu' to run the plain versions)")
    return device


def uses_kernel(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain version)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no implementation for device {x.device}")


def check_kernel_inputs(name: str, tensors: tuple[torch.Tensor, ...]) -> None:
    """Raise unless every tensor is float32 on the first one's device.  (Every
    kernel's gradient is an autograd Function with a backward kernel.)"""
    for x in tensors:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: needs float32, got {x.dtype}")
        if x.device != tensors[0].device:
            raise ValueError(f"{name}: inputs on {x.device} and {tensors[0].device}")
