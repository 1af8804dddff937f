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
bit.

``compressed_psum`` is the bandwidth-reduced sum over one mesh axis (the
reference's, inside ``shard_map``): every rank quantizes its tensor,
``all_gather_into_tensor`` moves the int8 blocks and the fp32 scales over
the axis's process group, and each rank dequantizes the N blocks and adds
them in rank order, so every rank holds the same bits. For an N-way axis
this moves (N-1)/N * S bytes of int8, against 2 (N-1)/N * 4 S bytes for a
ring all-reduce in fp32.
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


def dequantize_sum(q_all: torch.Tensor, s_all: torch.Tensor,
                   shape: Sequence[int]) -> torch.Tensor:
    """The sum of N ranks' gathered blocks ((N, blocks, 256) int8 and
    (N, blocks, 1) scales), dequantized and added in rank order."""
    total = q_all[0].to(torch.float32) * s_all[0]
    for q, s in zip(q_all[1:], s_all[1:]):
        total = total + q.to(torch.float32) * s
    return total.reshape(-1)[:math.prod(shape)].reshape(tuple(shape))


def gather_blocks(x: torch.Tensor, group):
    """Every rank's int8 blocks and scales of ``x`` over ``group``:
    ((N, blocks, 256) int8, (N, blocks, 1) fp32), in rank order."""
    import torch.distributed as dist

    q, scale = quantize_int8(x)
    n = dist.get_world_size(group)
    q_all = q.new_empty((n * q.shape[0], q.shape[1]))
    s_all = scale.new_empty((n * scale.shape[0], 1))
    dist.all_gather_into_tensor(q_all, q, group=group)
    dist.all_gather_into_tensor(s_all, scale, group=group)
    return q_all.view(n, *q.shape), s_all.view(n, *scale.shape)


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Bandwidth-reduced sum of each rank's ``x`` over mesh axis ``axis``:
    int8 all-gather, then dequantize and sum locally in rank order. Exact
    up to the int8 quantization error (use with error feedback)."""
    q_all, s_all = gather_blocks(x, mesh.get_group(axis))
    return dequantize_sum(q_all, s_all, x.shape)
