"""Delta-method PFP RMSNorm / LayerNorm on Hopper, with an optional
activation epilogue.

Replaces ``repro/kernels/pfp_norms.py``: ``pfp_rmsnorm_pallas`` and
``pfp_layernorm_pallas`` (``_norm_call``). The kernel is
``csrc/pfp_norms.cu``, bound by bytes: one block a row, the row held in
registers (each thread loads its slice once, as float4 where aligned), the
statistics from those registers by shuffle trees, one barrier a reduction.
Its source says how it is built and which LayerNorm spread it sums;
``csrc/pfp_norm.cuh`` states the bit rules. The plain versions are
``pfp_rmsnorm_ref`` and ``pfp_layernorm_ref`` (``kernels/ref.py``).

Every launch runs the plan :func:`norm_plan` gives for the row width, here
in Python so that the rule can be read and tested without a card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.pfp_activations import KINDS
from repro_torch.kernels.ref import (pfp_layernorm_ref,  # noqa: F401
                                     pfp_rmsnorm_ref)

NORMS = {"rmsnorm": 0, "layernorm": 1}
REPS = {"var": 0, "srm": 1}
NO_ACT = -1
# {float4 groups a thread: the most threads a block of them}, the plans
# csrc/pfp_norm.cuh's PFP_NORM_GROUPS instantiates, in its order.
GROUPS = {1: 1024, 2: 1024}
# {groups: the most threads a row norm_plan gives a block of them}: one
# group a thread up to 512 threads (d <= 2048), then two, up to d 8192.
# Measured on the card (tools/norm_plan_sweep.py, PERF.md): at 4 rows a
# 1024 x 1 block is slower than 512 x 2, and 4 groups slower than 2.
PLAN_THREADS = {1: 512, 2: 1024}


class NormPlan(NamedTuple):
    """How a row is cut: ``threads`` a block (one block a row), each
    holding ``groups`` float4 groups of the row, entries 4 (g threads +
    t) .. + 3 for thread t and group g."""

    threads: int
    groups: int


def _threads(d: int, groups: int) -> int:
    """The fewest threads, a multiple of 32, whose groups cover d."""
    per_thread = -(-(-(-d // 4)) // groups)   # ceil(ceil(d / 4) / groups)
    return max(32, -(-per_thread // 32) * 32)


def norm_plan(d: int) -> NormPlan:
    """The plan of a row of ``d`` entries: the fewest groups a thread whose
    block needs no more than ``PLAN_THREADS[groups]`` threads. A function
    of ``d`` alone, so that a row's bits do not depend on the call's rows
    or on the operands' alignment. Raises where no plan covers ``d``."""
    if d < 1:
        raise ValueError(f"no norm plan for a row of {d} entries")
    for groups, most in PLAN_THREADS.items():
        threads = _threads(d, groups)
        if threads <= most:
            return NormPlan(threads, groups)
    widest = max(4 * g * t for g, t in PLAN_THREADS.items())
    raise ValueError(f"no norm plan covers a row of {d} entries (at most "
                     f"{widest})")


def plan_ok(plan: NormPlan, d: int) -> bool:
    """Whether the kernel takes ``plan`` for a row of ``d`` entries (the C
    side's ``norm_plan_ok``)."""
    threads, groups = plan
    return (groups in GROUPS and 32 <= threads <= GROUPS[groups]
            and threads % 32 == 0 and 4 * groups * threads >= d)


def pfp_norm_cuda(mu, second, gain, bias=None, *, norm: str = "rmsnorm",
                  rep: str = "var", eps: float = 1e-6, act=None,
                  plan: Optional[NormPlan] = None):
    """Launch the norm kernel over the last axis of same-shape CUDA
    tensors. Returns (mean, var), or (mean, srm) after ``act``. ``plan``
    forces a launch plan (for timing); by default :func:`norm_plan`."""
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
    plan = norm_plan(d) if plan is None else NormPlan(*plan)
    if not plan_ok(plan, d):
        raise ValueError(f"norm plan {tuple(plan)} does not take a row of "
                         f"{d} entries")
    lib = _build.load()
    with torch.cuda.device(mu.device):
        status = lib.pfp_norm_launch(
            NORMS[norm], REPS[rep], NO_ACT if act is None else KINDS[act],
            *plan, mu.data_ptr(), second.data_ptr(), gain.data_ptr(),
            bias.data_ptr(), mu_out.data_ptr(), sec_out.data_ptr(), rows, d,
            eps, stream_ptr(mu.device))
    _build.check(status, "pfp_norm_launch")
    LAUNCHES[norm] += 1
    return mu_out, sec_out
