"""Where the port's entry points put what they make: the card unless the
caller names a device."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device | str:
    """``device``, or the card when None; raises when None and there is no card."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: tensors go to the card unless a device "
                           "is given; pass device='cpu' for the CPU")
    return torch.device("cuda")
