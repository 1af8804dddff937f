"""Moment algebra for the Probabilistic Forward Pass, on torch tensors.

Counterpart of ``repro/core/pfp_math.py``; every function works on raw
(mean, variance / SRM) tensors and is held elementwise against the JAX one.

  * ReLU moment matching, paper Eqs. (8), (9)            [exact]
  * Clark (1961) max of two independent Gaussians         [exact 2 moments]
  * 8-node Gauss-Hermite moments for gelu/silu/tanh/sigmoid
  * joint dense moments, Eqs. (7), (12), (13)
  * exact products of independent Gaussians (the GLU gate)
  * probit-corrected softmax scores (``variance_corrected`` attention)
"""
from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.gaussian import VAR_EPS

_SQRT_2 = math.sqrt(2.0)
_SQRT_2PI = math.sqrt(2.0 * math.pi)
_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
_PROBIT_LAMBDA_SQ = math.pi / 8.0


def normal_pdf(x):
    return torch.exp(-0.5 * torch.square(x)) / _SQRT_2PI


def normal_cdf(x):
    return 0.5 * (1.0 + torch.erf(x / _SQRT_2))


def relu_moments(mean, var):
    """Moment-matched ReLU on N(mean, var). VAR in, ``(mean, srm)`` out."""
    safe_var = torch.clamp(var, min=VAR_EPS)
    std = torch.sqrt(safe_var)
    t = mean / (std * _SQRT_2)
    cdf_term = 0.5 * (1.0 + torch.erf(t))                       # P(X > 0)
    pdf_term = std * torch.exp(-0.5 * torch.square(mean) / safe_var) / _SQRT_2PI
    mean_out = mean * cdf_term + pdf_term                        # Eq. (8)
    srm_out = (safe_var + torch.square(mean)) * cdf_term + mean * pdf_term  # Eq. (9)
    # Point-mass fallback keeps the var -> 0 limit exact.
    det_mean = torch.clamp(mean, min=0.0)
    is_det = var <= VAR_EPS
    mean_out = torch.where(is_det, det_mean, mean_out)
    srm_out = torch.where(is_det, torch.square(det_mean),
                          torch.clamp(srm_out, min=0.0))
    return mean_out, srm_out


@functools.lru_cache(maxsize=None)
def _gh_nodes(num_nodes: int, dtype: torch.dtype, device: torch.device):
    """Nodes and weights (divided by sqrt(pi)) on ``device``, made once per
    device: a host-to-device copy cannot run inside a CUDA graph capture."""
    nodes, weights = np.polynomial.hermite.hermgauss(num_nodes)
    return (torch.as_tensor(nodes, dtype=dtype, device=device),
            torch.as_tensor(weights * _INV_SQRT_PI, dtype=dtype, device=device))


def gauss_hermite_moments(f: Callable, mean, var, num_nodes: int = 8):
    """E[f(X)], E[f(X)^2] for X ~ N(mean, var); returns ``(mean, srm)``."""
    nodes, weights = _gh_nodes(num_nodes, mean.dtype, mean.device)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    x = mean[..., None] + (_SQRT_2 * std)[..., None] * nodes
    fx = f(x)
    mean_out = torch.sum(fx * weights, dim=-1)
    srm_out = torch.sum(torch.square(fx) * weights, dim=-1)
    return mean_out, srm_out


def gelu_tanh(x):
    """GELU in its tanh form, the default of ``jax.nn.gelu``."""
    return F.gelu(x, approximate="tanh")


def gelu_moments(mean, var, num_nodes: int = 8):
    return gauss_hermite_moments(gelu_tanh, mean, var, num_nodes)


def silu_moments(mean, var, num_nodes: int = 8):
    return gauss_hermite_moments(F.silu, mean, var, num_nodes)


def tanh_moments(mean, var, num_nodes: int = 8):
    return gauss_hermite_moments(torch.tanh, mean, var, num_nodes)


def sigmoid_moments(mean, var, num_nodes: int = 8):
    return gauss_hermite_moments(torch.sigmoid, mean, var, num_nodes)


def product_moments(mean_a, var_a, mean_b, var_b):
    """Moments of X*Y for independent Gaussians (exact). Returns
    ``(mean, var)``."""
    mean = mean_a * mean_b
    var = (torch.square(mean_a) * var_b + torch.square(mean_b) * var_a
           + var_a * var_b)
    return mean, var


def product_srm(mean_a, srm_a, mean_b, srm_b):
    """The same product in SRM form: E[XY] = mu_a mu_b, E[(XY)^2] =
    E[X^2] E[Y^2]. Returns ``(mean, srm)``."""
    return mean_a * mean_b, srm_a * srm_b


def clark_max_moments(mean_a, var_a, mean_b, var_b):
    """First two moments of max(X, Y), X and Y independent Gaussians
    (Clark 1961). Returns ``(mean, srm)``."""
    theta_sq = var_a + var_b
    safe_theta = torch.sqrt(torch.clamp(theta_sq, min=VAR_EPS))
    alpha = (mean_a - mean_b) / safe_theta
    cdf_a = normal_cdf(alpha)
    cdf_b = normal_cdf(-alpha)
    pdf = normal_pdf(alpha)
    mean = mean_a * cdf_a + mean_b * cdf_b + safe_theta * pdf
    srm = ((torch.square(mean_a) + var_a) * cdf_a
           + (torch.square(mean_b) + var_b) * cdf_b
           + (mean_a + mean_b) * safe_theta * pdf)
    # Degenerate (both deterministic) limit.
    det = theta_sq <= VAR_EPS
    det_mean = torch.maximum(mean_a, mean_b)
    mean = torch.where(det, det_mean, mean)
    srm = torch.where(det, torch.square(det_mean), srm)
    return mean, srm


def dense_moments_srm(mean_x, srm_x, mean_w, srm_w):
    """Joint dense moments, SRM formulation (Eq. 4 + Eq. 12): three
    matmuls. Returns ``(mean, var)``."""
    mean_a = mean_x @ mean_w
    var_a = srm_x @ srm_w - torch.square(mean_x) @ torch.square(mean_w)
    return mean_a, var_a


def dense_moments_var(mean_x, var_x, mean_w, var_w):
    """Joint dense moments, mean/variance formulation (Eq. 4 + Eq. 7)."""
    mean_a = mean_x @ mean_w
    mean_x_sq = torch.square(mean_x)
    mean_w_sq = torch.square(mean_w)
    var_a = var_x @ mean_w_sq + mean_x_sq @ var_w + var_x @ var_w
    return mean_a, var_a


def dense_moments_first_layer(x, mean_w, var_w):
    """First-layer simplification for deterministic inputs (Eq. 13)."""
    return x @ mean_w, torch.square(x) @ var_w


def probit_corrected_logits(mean, var):
    """Scale logits by 1/sqrt(1 + pi/8 var): the identity at var = 0; the
    ``variance_corrected`` attention mode folds score uncertainty into the
    attention weights with it."""
    return mean / torch.sqrt(1.0 + _PROBIT_LAMBDA_SQ * var)
