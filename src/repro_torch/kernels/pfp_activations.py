"""Elementwise PFP kernels on Hopper: the moment-matched activation,
(mu, var) -> (mean, srm), and the GLU gated product in SRM form.

Replaces ``repro/kernels/pfp_activations.py``: ``pfp_activation_pallas``
(ReLU Eq. 8/9 and the 8-node Gauss-Hermite gelu/silu/tanh/sigmoid) and
``pfp_glu_pallas``. The kernels are in ``csrc/pfp_activations.cu``, bound
by bytes. The plain versions are ``pfp_activation_ref`` and
``pfp_glu_ref`` (``kernels/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.ref import (pfp_activation_ref,  # noqa: F401
                                     pfp_glu_ref)

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


def pfp_glu_cuda(mu_a, srm_a, mu_b, srm_b):
    """Launch the GLU product on four same-shape CUDA tensors: returns
    (mu_a * mu_b, srm_a * srm_b)."""
    mu_a, srm_a, mu_b, srm_b = cuda_operands(mu_a, srm_a, mu_b, srm_b)
    if not mu_a.shape == srm_a.shape == mu_b.shape == srm_b.shape:
        raise ValueError(f"GLU operands differ in shape: {tuple(mu_a.shape)}, "
                         f"{tuple(srm_a.shape)}, {tuple(mu_b.shape)}, "
                         f"{tuple(srm_b.shape)}")
    mu_out = torch.empty_like(mu_a)
    srm_out = torch.empty_like(mu_a)
    if mu_a.numel() == 0:
        return mu_out, srm_out
    lib = _build.load()
    with torch.cuda.device(mu_a.device):
        status = lib.pfp_glu_launch(
            mu_a.data_ptr(), srm_a.data_ptr(), mu_b.data_ptr(),
            srm_b.data_ptr(), mu_out.data_ptr(), srm_out.data_ptr(),
            mu_a.numel(), stream_ptr(mu_a.device))
    _build.check(status, "pfp_glu_launch")
    LAUNCHES["glu_product"] += 1
    return mu_out, srm_out
