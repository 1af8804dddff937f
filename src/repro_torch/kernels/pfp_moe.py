"""Batched-expert joint PFP dense on Hopper: the MoE expert MLP.

Replaces ``repro/kernels/pfp_moe.py``: ``pfp_dense_batched_pallas`` (Eq. 12,
and Eq. 13 with ``first_layer``) and ``pfp_dense_batched_var_pallas``
(Eq. 7), E independent (C,K) x (K,N) denses in one launch. The kernel is
``csrc/pfp_dense.cu``'s dense kernel with the expert axis on ``blockIdx.z``;
an expert's slice comes out bit for bit as ``pfp_dense_cuda`` gives it. The
plain versions are ``pfp_dense_batched_ref``,
``pfp_dense_batched_first_layer_ref`` and ``pfp_dense_batched_var_ref``
(``kernels/ref.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.pfp_dense import (MODE_FIRST_LAYER, MODE_SRM,
                                           MODE_VAR, DensePlan, launch_plan,
                                           walks_split)
from repro_torch.kernels.ref import (  # noqa: F401
    pfp_dense_batched_first_layer_ref, pfp_dense_batched_ref,
    pfp_dense_batched_var_ref)

_COUNTER = {MODE_SRM: "dense_batched",
            MODE_FIRST_LAYER: "dense_batched_first_layer",
            MODE_VAR: "dense_batched_var"}
MAX_EXPERTS = 65535   # the grid's z extent


def pfp_dense_batched_cuda(x_a, x_b, w_a, w_b, *, mode: int, rows=None,
                           plan: Optional[DensePlan] = None):
    """Launch the batched dense kernel on 3-D CUDA operands: (E,C,K) x
    (E,K,N) -> fp32 (mean, var) of shape (E, C, N). ``mode`` reads the
    operands as in ``pfp_dense_cuda``: Eq. 12 (mu_x, srm_x, mu_w, srm_w),
    Eq. 13 (x, x, mu_w, var_w) or Eq. 7 (mu_x, var_x, mu_w, var_w).

    ``rows``: None, or an int32 (E,) tensor on the same device, expert e's
    kept rows (a prefix: rows from ``rows[e]`` on are zero in x). Their
    outputs come out as +0, a tile of them written without reading the
    expert's weights.
    ``plan`` overrides ``dense_plan``, as in ``pfp_dense_cuda``."""
    if mode not in _COUNTER:
        raise ValueError(f"unknown dense mode {mode}")
    x_a, x_b, w_a, w_b = cuda_operands(x_a, x_b, w_a, w_b)
    if x_a.dim() != 3 or w_a.dim() != 3:
        raise ValueError(f"batched dense takes 3-D operands, got "
                         f"{tuple(x_a.shape)} x {tuple(w_a.shape)}")
    e, c, k = x_a.shape
    e_w, k_w, n = w_a.shape
    if (e_w, k_w) != (e, k) or x_b.shape != x_a.shape or \
            w_b.shape != w_a.shape:
        raise ValueError(f"batched dense shapes {tuple(x_a.shape)} x "
                         f"{tuple(w_a.shape)}")
    if e > MAX_EXPERTS:
        raise ValueError(f"{e} experts, the kernel takes at most "
                         f"{MAX_EXPERTS}")
    if rows is not None and (rows.dtype != torch.int32
                             or tuple(rows.shape) != (e,)
                             or rows.device != x_a.device):
        raise ValueError(f"rows must be int32 ({e},) on {x_a.device}, got "
                         f"{rows.dtype} {tuple(rows.shape)} on "
                         f"{rows.device}")
    mu = torch.empty((e, c, n), dtype=torch.float32, device=x_a.device)
    var = torch.empty_like(mu)
    if e == 0 or c == 0 or n == 0:
        return mu, var
    plan = launch_plan(plan, c, n, k, e, mode)
    rows_ptr = None if rows is None else rows.contiguous().data_ptr()
    lib = _build.load()
    with torch.cuda.device(x_a.device):
        status = lib.pfp_dense_batched_launch(
            mode, x_a.data_ptr(), x_b.data_ptr(), w_a.data_ptr(),
            w_b.data_ptr(), mu.data_ptr(), var.data_ptr(), rows_ptr, e, c,
            n, k, c * k, k * n, *plan, int(walks_split(c, n)),
            stream_ptr(x_a.device))
    _build.check(status, f"pfp_dense_batched_launch {plan}")
    LAUNCHES[_COUNTER[mode]] += 1
    return mu, var
