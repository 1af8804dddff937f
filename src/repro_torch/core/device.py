"""Where the port's entry points run: the CUDA card unless asked otherwise."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card. Without one this raises: the port never
    carries on silently on the CPU. Pass ``device="cpu"`` to ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def cpu_generator(generator: Optional[torch.Generator], seed: int = 0):
    """The CPU generator random initialisation draws from (a fresh one
    seeded with ``seed`` when none is given), so a seed gives the same
    weights whatever device they are moved to."""
    if generator is None:
        return torch.Generator().manual_seed(seed)
    if generator.device.type != "cpu":
        raise ValueError("initialisation draws from a CPU torch.Generator")
    return generator
