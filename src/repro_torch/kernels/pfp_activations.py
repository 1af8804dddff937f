"""Moment-matched activation on Hopper: (mu, var) -> (mean, srm).

Replaces ``repro/kernels/pfp_activations.py``: ``pfp_activation_pallas``
(ReLU Eq. 8/9 and the 8-node Gauss-Hermite gelu/silu/tanh/sigmoid). The
kernel is ``csrc/pfp_activations.cu``, one thread per element, bound by
bytes. The plain version is ``pfp_activation_ref`` (``kernels/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.ref import pfp_activation_ref  # noqa: F401

KINDS = {"relu": 0, "gelu": 1, "silu": 2, "tanh": 3, "sigmoid": 4}


def pfp_activation_cuda(mu, var, *, kind: str = "relu"):
    """Launch the activation kernel on same-shape CUDA tensors."""
    if kind not in KINDS:
        raise ValueError(f"no activation kernel for {kind!r}")
    mu, var = cuda_operands(mu, var)
    if mu.shape != var.shape:
        raise ValueError(f"mean {tuple(mu.shape)} vs var {tuple(var.shape)}")
    mean_out = torch.empty_like(mu)
    srm_out = torch.empty_like(mu)
    if mu.numel() == 0:
        return mean_out, srm_out
    lib = _build.load()
    with torch.cuda.device(mu.device):
        status = lib.pfp_activation_launch(
            KINDS[kind], mu.data_ptr(), var.data_ptr(), mean_out.data_ptr(),
            srm_out.data_ptr(), mu.numel(), stream_ptr(mu.device))
    _build.check(status, "pfp_activation_launch")
    LAUNCHES["activation"] += 1
    return mean_out, srm_out
