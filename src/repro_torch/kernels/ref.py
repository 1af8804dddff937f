"""Plain PyTorch versions of the port's hand-written kernels.

Counterpart of ``repro/kernels/ref.py``. Each function computes exactly
what one CUDA kernel computes, from ``core/pfp_math.py``, in fp32. The
kernel wrappers (``kernels/ops.py``) run these for tensors on the CPU;
``chip_smoke.py`` and the GPU tests hold each kernel against them on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.core import pfp_math

_F32 = torch.float32


def pfp_dense_ref(mu_x, srm_x, mu_w, srm_w):
    """Joint PFP dense, SRM formulation (Eq. 4 + Eq. 12)."""
    mu_x, srm_x, mu_w, srm_w = (a.to(_F32) for a in (mu_x, srm_x, mu_w, srm_w))
    mu = mu_x @ mu_w
    var = srm_x @ srm_w - torch.square(mu_x) @ torch.square(mu_w)
    return mu, var


def pfp_dense_first_layer_ref(x, mu_w, var_w):
    """First-layer simplification (Eq. 13): deterministic inputs."""
    x, mu_w, var_w = (a.to(_F32) for a in (x, mu_w, var_w))
    return x @ mu_w, torch.square(x) @ var_w


def pfp_dense_var_ref(mu_x, var_x, mu_w, var_w):
    """Joint PFP dense, Eq. 7 formulation: four contractions."""
    mx, vx, mw, vw = (a.to(_F32) for a in (mu_x, var_x, mu_w, var_w))
    mu = mx @ mw
    var = vx @ torch.square(mw) + torch.square(mx) @ vw + vx @ vw
    return mu, var


ACTIVATION_REFS = {
    "relu": pfp_math.relu_moments,
    "gelu": pfp_math.gelu_moments,
    "silu": pfp_math.silu_moments,
    "tanh": pfp_math.tanh_moments,
    "sigmoid": pfp_math.sigmoid_moments,
}


def pfp_activation_ref(mu, var, kind: str = "relu"):
    """Moment-matched activation: (mean, var) in, (mean, srm) out."""
    return ACTIVATION_REFS[kind](mu.to(_F32), var.to(_F32))


def pfp_relu_ref(mu, var):
    """Moment-matched ReLU, Eq. 8/9, the kind the paper's models run."""
    return pfp_activation_ref(mu, var, "relu")


def pfp_maxpool2d_ref(mu, var):
    """2x2/stride-2 PFP max pool on NHWC via Clark tournament (VAR->VAR)."""
    mu, var = mu.to(_F32), var.to(_F32)
    m_w, s_w = pfp_math.clark_max_moments(mu[:, :, 0::2], var[:, :, 0::2],
                                          mu[:, :, 1::2], var[:, :, 1::2])
    v_w = torch.clamp(s_w - torch.square(m_w), min=0.0)
    m, s = pfp_math.clark_max_moments(m_w[:, 0::2], v_w[:, 0::2],
                                      m_w[:, 1::2], v_w[:, 1::2])
    return m, torch.clamp(s - torch.square(m), min=0.0)
