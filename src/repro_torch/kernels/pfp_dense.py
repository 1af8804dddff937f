"""Joint PFP dense on Hopper: Eq. 12, its first-layer form Eq. 13, and Eq. 7.

Replaces ``repro/kernels/pfp_dense.py``: ``pfp_dense_pallas`` (Eq. 12/13)
and ``pfp_dense_var_pallas`` (Eq. 7). The kernel is ``csrc/pfp_dense.cu``,
a shared-memory-tiled fp32 SIMT kernel with the K loop inside the block;
its source says what bounds it and why it is built so. The plain versions
are ``pfp_dense_ref``, ``pfp_dense_first_layer_ref`` and
``pfp_dense_var_ref`` (``kernels/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.ref import (pfp_dense_first_layer_ref,  # noqa: F401
                                     pfp_dense_ref, pfp_dense_var_ref)

MODE_SRM, MODE_FIRST_LAYER, MODE_VAR = 0, 1, 2
_COUNTER = {MODE_SRM: "dense", MODE_FIRST_LAYER: "dense_first_layer",
            MODE_VAR: "dense_var"}


def pfp_dense_cuda(x_a, x_b, w_a, w_b, *, mode: int):
    """Launch the dense kernel on 2-D CUDA operands: (M,K) x (K,N) -> fp32
    (mean, var) of shape (M, N). ``mode`` picks the operands' meaning:
    Eq. 12 (mu_x, srm_x, mu_w, srm_w), Eq. 13 (x, x, mu_w, var_w) or Eq. 7
    (mu_x, var_x, mu_w, var_w)."""
    if mode not in _COUNTER:
        raise ValueError(f"unknown dense mode {mode}")
    x_a, x_b, w_a, w_b = cuda_operands(x_a, x_b, w_a, w_b)
    m, k = x_a.shape
    k_w, n = w_a.shape
    if k_w != k or x_b.shape != x_a.shape or w_b.shape != w_a.shape:
        raise ValueError(f"dense shapes {tuple(x_a.shape)} x {tuple(w_a.shape)}")
    mu = torch.empty((m, n), dtype=torch.float32, device=x_a.device)
    var = torch.empty_like(mu)
    if m == 0 or n == 0:
        return mu, var
    lib = _build.load()
    with torch.cuda.device(x_a.device):
        status = lib.pfp_dense_launch(
            mode, x_a.data_ptr(), x_b.data_ptr(), w_a.data_ptr(),
            w_b.data_ptr(), mu.data_ptr(), var.data_ptr(), m, n, k,
            stream_ptr(x_a.device))
    _build.check(status, "pfp_dense_launch")
    LAUNCHES[_COUNTER[mode]] += 1
    return mu, var
