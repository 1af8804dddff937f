"""PFP 2x2/stride-2 max pool on Hopper (NHWC; VAR or SRM in, VAR out).

Replaces ``repro/kernels/pfp_maxpool.py``: ``pfp_maxpool2d_pallas``, the
Clark tournament. The kernel is ``csrc/pfp_maxpool.cu``: each thread reads
the 2x2 windows of a few neighbouring channels straight from the NHWC
input, so the four phase arrays the TPU wrapper sliced out never exist.
It also takes the input's second moment as E[x^2] (``rep="srm"``) and
forms the variance as ``GaussianTensor.to_var()`` does, bit for bit. The
plain version is ``pfp_maxpool2d_ref`` (``kernels/ref.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.pfp_activations import ElementwisePlan, spread
from repro_torch.kernels.ref import pfp_maxpool2d_ref  # noqa: F401

REPS = ("var", "srm")


def pool_plan(n: int, h: int, w: int, c: int,
              align_bytes: int) -> ElementwisePlan:
    """The plan of a pool of an (n, h, w, c) input: ``vec`` channels a
    thread, the most of 4, 2 and 1 that divides ``c`` and that every
    pointer's alignment (the largest power of two up to 16 dividing all
    four addresses, ``align_bytes``) allows; threads spread as
    :func:`spread` does."""
    vec = next(v for v in (4, 2, 1) if c % v == 0 and align_bytes >= 4 * v)
    return spread(n * (h // 2) * (w // 2) * c // vec, vec)


def _align_bytes(*tensors) -> int:
    return min(next(b for b in (16, 8, 4) if t.data_ptr() % b == 0)
               for t in tensors)


def pfp_maxpool2d_cuda(mu, second, *, rep: str = "var",
                       plan: Optional[ElementwisePlan] = None):
    """Launch the max-pool kernel on NHWC CUDA tensors with even H and W.
    ``second`` is the variance (``rep="var"``) or E[x^2] (``"srm"``); the
    output is (mean, var). ``plan`` forces a launch plan (for tests and
    timing); by default :func:`pool_plan`."""
    if rep not in REPS:
        raise ValueError(f"unknown rep {rep!r}")
    mu, second = cuda_operands(mu, second)
    if mu.dim() != 4 or mu.shape != second.shape:
        raise ValueError(f"NHWC mean {tuple(mu.shape)} vs second moment "
                         f"{tuple(second.shape)}")
    n, h, w, c = mu.shape
    if h % 2 or w % 2:
        raise ValueError(f"the 2x2/2 pool needs even H and W, got {h}x{w}")
    mu_out = torch.empty((n, h // 2, w // 2, c), dtype=torch.float32,
                         device=mu.device)
    var_out = torch.empty_like(mu_out)
    if mu_out.numel() == 0:
        return mu_out, var_out
    if plan is None:
        plan = pool_plan(n, h, w, c,
                         _align_bytes(mu, second, mu_out, var_out))
    lib = _build.load()
    with torch.cuda.device(mu.device):
        status = lib.pfp_maxpool2d_launch(
            mu.data_ptr(), second.data_ptr(), mu_out.data_ptr(),
            var_out.data_ptr(), n, h, w, c, int(rep == "srm"), *plan,
            stream_ptr(mu.device))
    _build.check(status, "pfp_maxpool2d_launch")
    LAUNCHES["maxpool2d"] += 1
    return mu_out, var_out
