"""Where the port's entry points put what they make: the card unless the
caller names a device."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: torch.device | str | None) -> torch.device | str:
    """``device``, or the card when None; raises when None and there is no card."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tensors go to the card unless a device "
                           "is given; pass device='cpu' for the CPU")
    return torch.device("cuda")


def device_guard(device: torch.device):
    """``torch.cuda.device(device)`` for a card, a no-op for the host: the
    CUDA launchers run on the calling thread's current device, so work on
    one card of a mesh runs under it (``parallel/``)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def each_position(fn, *args):
    """``fn(*args)`` of tensors, or, when ``args[0]`` is a list (one entry a
    position of a mesh, ``parallel/``), ``fn`` position by position over
    the lists, each under its position's device (that of the first tensor
    among its arguments, nested tuples searched)."""
    if not isinstance(args[0], list):
        return fn(*args)
    out = []
    for xs in zip(*args):
        with device_guard(_device_of(xs)):
            out.append(fn(*xs))
    return out


def _device_of(x) -> torch.device:
    if isinstance(x, torch.Tensor):
        return x.device
    return next(_device_of(y) for y in x if isinstance(y, (torch.Tensor, tuple, list)))
