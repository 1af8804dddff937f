"""Gradient compression: int8 quantization with error feedback.

Counterpart of ``repro/training/compression.py``. Gradients are quantized
to int8 with one fp32 scale per block of 256 before they cross the
interconnect (4x fewer collective bytes), and the quantization error is
fed back into the next step's gradient (error feedback), which keeps SGD's
convergence guarantees.

The same arithmetic as the reference, step for step: zero padding to whole
blocks, scale = max|x| / 127 with a floor of 1e-12, ``round`` half to even
(``torch.round``, as ``jnp.round``), clip to +-127, cast to int8. On the
same fp32 input the two packages give the same ``q`` and scales bit for
bit. The reference's ``compressed_psum`` needs a process group; it comes
with the mesh modules (ROADMAP.md).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

_BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization. Returns (q, scales):
    ``q`` (blocks, 256) int8 and ``scales`` (blocks, 1) fp32."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape: Sequence[int]) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(tuple(shape))


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor):
    """Error-feedback compression: returns (q, scale, new_error)."""
    target = grad + error
    q, scale = quantize_int8(target)
    recon = dequantize_int8(q, scale, grad.shape)
    return q, scale, target - recon
