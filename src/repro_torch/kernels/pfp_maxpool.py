"""PFP 2x2/stride-2 max pool on Hopper (NHWC, VAR in, VAR out).

Replaces ``repro/kernels/pfp_maxpool.py``: ``pfp_maxpool2d_pallas``, the
Clark tournament. The kernel is ``csrc/pfp_maxpool.cu``: one thread per
output reads its 2x2 window straight from the NHWC input, so the four
phase arrays the TPU wrapper sliced out never exist. Bound by bytes. The
plain version is ``pfp_maxpool2d_ref`` (``kernels/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.ref import pfp_maxpool2d_ref  # noqa: F401


def pfp_maxpool2d_cuda(mu, var):
    """Launch the max-pool kernel on NHWC CUDA tensors with even H and W."""
    mu, var = cuda_operands(mu, var)
    if mu.dim() != 4 or mu.shape != var.shape:
        raise ValueError(f"NHWC mean {tuple(mu.shape)} vs var {tuple(var.shape)}")
    n, h, w, c = mu.shape
    if h % 2 or w % 2:
        raise ValueError(f"the 2x2/2 pool needs even H and W, got {h}x{w}")
    mu_out = torch.empty((n, h // 2, w // 2, c), dtype=torch.float32,
                         device=mu.device)
    var_out = torch.empty_like(mu_out)
    if mu_out.numel() == 0:
        return mu_out, var_out
    lib = _build.load()
    with torch.cuda.device(mu.device):
        status = lib.pfp_maxpool2d_launch(
            mu.data_ptr(), var.data_ptr(), mu_out.data_ptr(),
            var_out.data_ptr(), n, h, w, c, stream_ptr(mu.device))
    _build.check(status, "pfp_maxpool2d_launch")
    LAUNCHES["maxpool2d"] += 1
    return mu_out, var_out
