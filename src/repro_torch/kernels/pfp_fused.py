"""The fused PFP unit on Hopper: norm -> VAR to SRM -> Eq. 12 dense ->
moment-matched activation.

Replaces ``repro/kernels/pfp_fused.py``: ``pfp_norm_dense_act_pallas``
(``_norm_dense_act_kernel``). The kernel is ``csrc/pfp_fused.cu``: a norm
pass that writes the normalised input in SRM, then the dense kernel's own
``cp.async`` ring (``csrc/pfp_dense_ring.cuh``) with the activation as its
epilogue. Bound by the fp32 operations of its dense at prefill and by the
weight stream at decode; its source says how it reproduces the unfused
kernel chain bit for bit, and why the norm is a pass of its own. It runs on the dense
kernel's plans in ``PLANS``; a schedule names one by its (block_m,
block_n) output tile (``TILES``), the autotuner's search space. The plain
version is ``pfp_norm_dense_act_ref`` (``kernels/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.pfp_activations import KINDS
from repro_torch.kernels.pfp_dense import (NARROW_N, dense_plan, split_k,
                                           thread_rows)
from repro_torch.kernels.pfp_norms import NORMS, REPS, norm_plan
from repro_torch.kernels.ref import pfp_norm_dense_act_ref  # noqa: F401

# The dense plans (bn, tn, tm, stages) csrc/pfp_fused.cu is instantiated
# on, its PFP_FUSED_TILES in its order: the large regime's wide and ring
# tiles and the decode regime's TM 1 tiles (kernels/pfp_dense.py _LARGE,
# _DECODE), all of split 1.
PLANS = ((128, 8, 8, 2), (128, 8, 4, 2), (64, 4, 4, 4), (64, 4, 1, 4),
         (128, 4, 1, 4), (64, 1, 1, 4))


def tile_of(plan) -> tuple:
    """The (block_m, block_n) output tile of a plan (bn, tn, tm, stages)."""
    bn, tn, tm, _ = plan
    return thread_rows(bn, tn) * tm, bn


# The tiles, larger first: (128, 128), (64, 128), (64, 64), (16, 64),
# (8, 128), (4, 64).
TILES = tuple(tile_of(p) for p in PLANS)
_PLAN_OF = dict(zip(TILES, PLANS))


def fusable(k: int, n: int) -> bool:
    """Whether the fused unit is the unfused chain bit for bit at (K, N):
    where the chain's dense splits K over a cluster (``split_k`` > 1, 64
    <= N <= 128) its sums run in another order than the fused unit's
    single pass, so the fusion pass runs the chain there."""
    return split_k(k, n) == 1


def default_tile(m: int, n: int, k: int) -> tuple:
    """The tile the chain's dense runs at (M, K, N) when N > 128
    (``dense_plan``): the wide or ring tiles for M > 16, the decode tiles
    below."""
    return tile_of(dense_plan(m, max(n, NARROW_N + 1), k)[1:])


def check_config(norm: str, rep: str, act: str, tile) -> None:
    """Raise unless the kernel is instantiated for this norm, input
    representation, activation and tile."""
    if norm not in NORMS or rep not in REPS or act not in KINDS \
            or tuple(tile) not in TILES:
        raise ValueError(f"no fused norm_dense_act kernel for norm {norm!r}, "
                         f"rep {rep!r}, act {act!r}, tile {tuple(tile)}; "
                         f"tiles are {TILES}")


def pfp_norm_dense_act_cuda(mu, second, gain, bias, mu_w, srm_w, *,
                            norm: str = "rmsnorm", rep: str = "var",
                            eps: float = 1e-6, act: str = "silu",
                            tile=None):
    """Launch the fused kernel on 2-D CUDA operands: the norm input
    (mu, second) (M, K), the norm's gain and (LayerNorm) bias (K,), the
    dense weight (mu_w, srm_w) (K, N). ``tile`` is one of ``TILES``
    (None: :func:`default_tile`). Returns fp32 (mean, srm) (M, N)."""
    m, k = mu.shape
    n = mu_w.shape[-1]
    tile = default_tile(m, n, k) if tile is None else tuple(tile)
    check_config(norm, rep, act, tile)
    if bias is None:  # RMSNorm reads no bias
        bias = torch.zeros_like(gain) if norm == "layernorm" else gain
    mu, second, gain, bias, mu_w, srm_w = cuda_operands(
        mu, second, gain, bias, mu_w, srm_w)
    if (second.shape != mu.shape or gain.shape != (k,) or bias.shape != (k,)
            or mu_w.shape != (k, n) or srm_w.shape != (k, n)):
        raise ValueError(f"norm_dense_act shapes x {tuple(mu.shape)} / "
                         f"{tuple(second.shape)}, gain {tuple(gain.shape)}, "
                         f"bias {tuple(bias.shape)}, w {tuple(mu_w.shape)} / "
                         f"{tuple(srm_w.shape)}")
    mean = torch.empty((m, n), dtype=torch.float32, device=mu.device)
    srm = torch.empty_like(mean)
    if m == 0 or n == 0:
        return mean, srm
    if k == 0:
        raise ValueError("norm_dense_act needs K >= 1: a norm over no "
                         "features is undefined")
    norm_pass = norm_plan(k)   # the norm kernel's plan: its bits
    h = torch.empty((2, m, k), dtype=torch.float32, device=mu.device)
    lib = _build.load()
    with torch.cuda.device(mu.device):
        status = lib.pfp_norm_dense_act_launch(
            NORMS[norm], REPS[rep], KINDS[act], *_PLAN_OF[tile], *norm_pass,
            mu.data_ptr(), second.data_ptr(), gain.data_ptr(),
            bias.data_ptr(), h.data_ptr(), mu_w.data_ptr(),
            srm_w.data_ptr(), mean.data_ptr(), srm.data_ptr(), m, n, k, eps,
            stream_ptr(mu.device))
    _build.check(status, "pfp_norm_dense_act_launch")
    LAUNCHES["norm_dense_act"] += 1
    return mean, srm
