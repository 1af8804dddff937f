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


def init_generator(generator: Optional[torch.Generator], seed: int = 0):
    """The generator random initialisation draws from: ``generator`` itself,
    or a fresh CPU one seeded with ``seed``. Weights are drawn on the
    generator's device, so a seeded CPU generator gives the same weights
    whatever device they are moved to, and a CUDA generator draws a large
    model on the card."""
    if generator is None:
        return torch.Generator().manual_seed(seed)
    return generator
