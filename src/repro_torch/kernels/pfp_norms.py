"""Delta-method PFP RMSNorm / LayerNorm on Hopper, with an optional
activation epilogue.

Replaces ``repro/kernels/pfp_norms.py``: ``pfp_rmsnorm_pallas`` and
``pfp_layernorm_pallas`` (``_norm_call``). The kernel is
``csrc/pfp_norms.cu``, one block per row, bound by bytes; its source says
how it is built and which LayerNorm spread it sums. The plain versions are
``pfp_rmsnorm_ref`` and ``pfp_layernorm_ref`` (``kernels/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.pfp_activations import KINDS
from repro_torch.kernels.ref import (pfp_layernorm_ref,  # noqa: F401
                                     pfp_rmsnorm_ref)

NORMS = {"rmsnorm": 0, "layernorm": 1}
REPS = {"var": 0, "srm": 1}
NO_ACT = -1


def pfp_norm_cuda(mu, second, gain, bias=None, *, norm: str = "rmsnorm",
                  rep: str = "var", eps: float = 1e-6, act=None):
    """Launch the norm kernel over the last axis of same-shape CUDA
    tensors. Returns (mean, var), or (mean, srm) after ``act``."""
    if norm not in NORMS or rep not in REPS or (act is not None
                                                and act not in KINDS):
        raise ValueError(f"no norm kernel for {norm!r}, rep {rep!r}, "
                         f"act {act!r}")
    if bias is None:  # RMSNorm reads no bias
        bias = torch.zeros_like(gain) if norm == "layernorm" else gain
    mu, second, gain, bias = cuda_operands(mu, second, gain, bias)
    d = mu.shape[-1]
    if mu.shape != second.shape or gain.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"norm shapes mu {tuple(mu.shape)}, second "
                         f"{tuple(second.shape)}, gain {tuple(gain.shape)}, "
                         f"bias {tuple(bias.shape)}")
    mu_out = torch.empty_like(mu)
    sec_out = torch.empty_like(mu)
    rows = mu.numel() // d if d else 0
    if rows == 0:
        return mu_out, sec_out
    lib = _build.load()
    with torch.cuda.device(mu.device):
        status = lib.pfp_norm_launch(
            NORMS[norm], REPS[rep], NO_ACT if act is None else KINDS[act],
            mu.data_ptr(), second.data_ptr(), gain.data_ptr(),
            bias.data_ptr(), mu_out.data_ptr(), sec_out.data_ptr(), rows, d,
            eps, stream_ptr(mu.device))
    _build.check(status, "pfp_norm_launch")
    LAUNCHES[norm] += 1
    return mu_out, sec_out
