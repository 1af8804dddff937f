"""Elementwise PFP kernels on Hopper: the moment-matched activation,
(mu, var) -> (mean, srm), and the GLU gated product in SRM form.

Replaces ``repro/kernels/pfp_activations.py``: ``pfp_activation_pallas``
(ReLU Eq. 8/9 and the 8-node Gauss-Hermite gelu/silu/tanh/sigmoid) and
``pfp_glu_pallas``. The kernels are in ``csrc/pfp_activations.cu``; its
header says what bounds them. The plain versions are
``pfp_activation_ref`` and ``pfp_glu_ref`` (``kernels/ref.py``).

Every activation launch runs a plan from :func:`activation_plan`, chosen
here from the element count and the operands' alignment alone, so that the
rule can be read and tested without a card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.ref import (pfp_activation_ref,  # noqa: F401
                                     pfp_glu_ref)

KINDS = {"relu": 0, "gelu": 1, "silu": 2, "tanh": 3, "sigmoid": 4}
SMS = 132                   # the H100's SMs
# Threads an SM holds of the activation and max-pool kernels: their
# __launch_bounds__(256, 4) keep a thread at 64 registers, 4 blocks of 256.
SM_THREADS = 1024
WAVE = SMS * SM_THREADS     # threads on the card at once


class ElementwisePlan(NamedTuple):
    """How one elementwise launch is cut: ``vec`` elements a thread takes
    at a time (4: float4 loads and stores), ``block`` threads a block,
    ``grid`` blocks. The kernel strides over whatever the grid does not
    cover at once, so any plan covers every element."""

    vec: int
    block: int
    grid: int


def spread(units: int, vec: int) -> ElementwisePlan:
    """``units`` independent units of ``vec`` elements. From a wave up:
    exactly one wave of 256-thread blocks that strides over them (no
    partial last wave). Under a wave: one unit a thread, in the block of
    64 to 256 threads that puts the fewest threads on the busiest SM when
    the blocks are dealt out evenly (the larger block on a tie), so the
    work spreads over every SM it can."""
    if units >= WAVE:
        return ElementwisePlan(vec, 256, WAVE // 256)

    def busiest(block):
        return -(-(-(-units // block)) // SMS) * block

    block = min(range(256, 63, -32), key=busiest)
    return ElementwisePlan(vec, block, -(-units // block))


def activation_plan(n: int, aligned: bool) -> ElementwisePlan:
    """The plan of an activation over ``n`` elements; ``aligned``: all four
    pointers on 16 bytes. A call that fits one wave takes one element a
    thread, to reach every SM it can; a larger one takes groups of 4
    where it is aligned."""
    if n < 1:
        raise ValueError(f"no activation plan for {n} elements")
    vec = 4 if aligned and n > WAVE else 1
    return spread(-(-n // vec), vec)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def pfp_activation_cuda(mu, var, *, kind: str = "relu",
                        plan: Optional[ElementwisePlan] = None):
    """Launch the activation kernel on same-shape CUDA tensors. ``plan``
    forces a launch plan (for tests and timing); by default
    :func:`activation_plan`."""
    if kind not in KINDS:
        raise ValueError(f"no activation kernel for {kind!r}")
    mu, var = cuda_operands(mu, var)
    if mu.shape != var.shape:
        raise ValueError(f"mean {tuple(mu.shape)} vs var {tuple(var.shape)}")
    mean_out = torch.empty_like(mu)
    srm_out = torch.empty_like(mu)
    if mu.numel() == 0:
        return mean_out, srm_out
    if plan is None:
        plan = activation_plan(mu.numel(),
                               _aligned(mu, var, mean_out, srm_out))
    lib = _build.load()
    with torch.cuda.device(mu.device):
        status = lib.pfp_activation_launch(
            KINDS[kind], mu.data_ptr(), var.data_ptr(), mean_out.data_ptr(),
            srm_out.data_ptr(), mu.numel(), *plan, stream_ptr(mu.device))
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
