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


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """A model config's ``dtype`` ("float32" or "bfloat16", the JAX configs'
    names) -> the torch dtype the model computes in; raises on any other."""
    if name not in COMPUTE_DTYPES:
        raise NotImplementedError(f"dtype {name!r}: the port computes in {list(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def uses_kernel(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain version)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no implementation for device {x.device}")


def check_kernel_inputs(name: str, tensors: tuple[torch.Tensor, ...],
                        streams: tuple[torch.Tensor, ...] = (),
                        stream_dtypes: tuple[torch.dtype, ...] = (torch.float32,)
                        ) -> torch.dtype:
    """Raise unless every tensor of ``tensors`` (parameters, masks: always
    float32) is float32, every tensor of ``streams`` (the activations a kernel
    reads and writes) has one dtype, which ``stream_dtypes`` allows, and all
    lie on one device -> that stream dtype (float32 without streams).
    (Every kernel's gradient is an autograd Function with a backward kernel.)"""
    for x in tensors:
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: needs float32, got {x.dtype}")
    dtype = streams[0].dtype if streams else torch.float32
    for x in streams:
        if x.dtype not in stream_dtypes or x.dtype != dtype:
            raise TypeError(f"{name}: streams in one of {stream_dtypes}, got "
                            f"{[s.dtype for s in streams]}")
    every = (*streams, *tensors)
    for x in every:
        if x.device != every[0].device:
            raise ValueError(f"{name}: inputs on {x.device} and {every[0].device}")
    return dtype
