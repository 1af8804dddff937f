"""Joint PFP dense on Hopper: Eq. 12, its first-layer form Eq. 13, and Eq. 7.

Replaces ``repro/kernels/pfp_dense.py``: ``pfp_dense_pallas`` (Eq. 12/13)
and ``pfp_dense_var_pallas`` (Eq. 7). The kernel is ``csrc/pfp_dense.cu``,
an fp32 SIMT kernel on a ``cp.async`` ring of shared-memory tiles; its
source says what bounds it in each regime and why it is built so. The
plain versions are ``pfp_dense_ref``, ``pfp_dense_first_layer_ref`` and
``pfp_dense_var_ref`` (``kernels/ref.py``).

Every launch runs a plan from :func:`dense_plan`, chosen here so that the
rule can be read and tested without a card: the cluster split of K, the
tile, the rows per thread and the depth of the copy ring.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.ref import (pfp_dense_first_layer_ref,  # noqa: F401
                                     pfp_dense_ref, pfp_dense_var_ref)

MODE_SRM, MODE_FIRST_LAYER, MODE_VAR = 0, 1, 2
_COUNTER = {MODE_SRM: "dense", MODE_FIRST_LAYER: "dense_first_layer",
            MODE_VAR: "dense_var"}


class DensePlan(NamedTuple):
    """How one dense launch is cut. ``split`` CTAs of a cluster share an
    output tile, each summing a K range; the tile is ``bn`` columns wide,
    ``tn`` columns and ``tm`` rows per thread (``tn`` 8: a wide tile of
    the large regime, each thread's columns in two groups of 4
    neighbours); ``stages`` is the depth of the cp.async ring."""

    split: int
    bn: int
    tn: int
    tm: int
    stages: int


# (bn, tn, tm, stages) of every instantiation: csrc/pfp_dense.cu's
# PFP_DENSE_TILES, in its order.
TILES = (
    (128, 8, 8, 2), (128, 8, 4, 2),                      # large
    (8, 1, 1, 4), (8, 1, 4, 4), (16, 1, 1, 4), (16, 1, 4, 4),
    (32, 2, 1, 4), (32, 2, 4, 4), (64, 4, 1, 4), (64, 4, 4, 4),
    (128, 4, 1, 4), (128, 4, 4, 4),                      # narrow
    (64, 1, 1, 4),                                       # decode
)
THREADS = 256
SMS = 132                  # the H100's SMs
FILL_BLOCKS = 2 * SMS      # two blocks an SM
NARROW_N = 128             # N up to this: one tile holds every column
DECODE_M = 16              # M up to this: the weight stream
SPLIT_N = 64               # N from this up to NARROW_N: K is split
SPLIT_MIN_K = 64           # K up to this (4 tiles): not split
SPLIT_K = 48               # K per cluster rank, before rounding to tiles
MAX_SPLIT = 8              # the portable cluster size
TILE_K = 16                # K of one staged tile
RING_STAGES = 4            # tiles in the cp.async ring (3 in flight)
WIDE_STAGES = 2            # the same for the wide tiles, of 32 k each
# Narrow tiles (bn, tn): the first with bn >= N is taken.
_NARROW = ((8, 1), (16, 1), (32, 2), (64, 4), (128, 4))
# Decode tiles (bn, tn) by the thread rows that cover M.
_DECODE = {4: (64, 1), 8: (128, 4), 16: (64, 4)}
# Large tiles (bn, tn, tm, stages), fastest per block first: the wide
# 128 x 128 and 64 x 128, then the interleaved 64 x 64 and 16 x 64 ring
# tiles, which give more blocks where few rows or columns leave the card
# idle.
_LARGE = ((128, 8, 8, WIDE_STAGES), (128, 8, 4, WIDE_STAGES),
          (64, 4, 4, RING_STAGES), (64, 4, 1, RING_STAGES))
FILL_LARGE = SMS * 5 // 6  # blocks that keep the card busy in one wave


def thread_rows(bn: int, tn: int) -> int:
    return THREADS // (bn // tn)


def split_k(k: int, n: int, mode: int = MODE_SRM) -> int:
    """The cluster split of K: a function of (K, N, mode) only, so a row's
    result never depends on M or E.

    1 whenever N > 128 (every LM shape: prefill and decode rows agree bit
    for bit); for N < 64: in the paper's models those are the conv layers'
    im2col products, whose 196-784 rows per image fill the card unsplit,
    where the cluster's combine costs (conv2 at batch 1024,
    ``tools/dense_plan_sweep.py``); and for K <= 64, a loop of at most 4
    tiles. Else about one rank per 48 of K, at most 8, each rank whole
    tiles of 16 and none left empty."""
    del mode   # every formulation splits alike
    if not SPLIT_N <= n <= NARROW_N or k <= SPLIT_MIN_K:
        return 1
    split = min(MAX_SPLIT, -(-k // SPLIT_K))
    chunk = -(-k // split)
    chunk = -(-chunk // TILE_K) * TILE_K
    return -(-k // chunk)


def _blocks(m, n, e, bn, tn, tm, split=1):
    return -(-m // (thread_rows(bn, tn) * tm)) * -(-n // bn) * e * split


def dense_plan(m: int, n: int, k: int, e: int = 1,
               mode: int = MODE_SRM) -> DensePlan:
    """The plan for E problems of (M, K) x (K, N).

    * Large (N > 128, M > 16): the first of the 128 x 128 wide tile (8 x
      8 outputs a thread), 64 x 128, and the ring tiles (64, 4) at TM 4
      and 1 that gives FILL_LARGE blocks, else the last: where rows or
      columns are few (a prefill chunk of 128 rows), more blocks beat a
      faster block (``tools/dense_plan_sweep.py``). Every tile sums an
      output alike, so the choice moves no bit.
    * Narrow (N <= 128): the narrowest tile that holds all of N, so x is
      read once; K split by :func:`split_k` over a cluster; TM 4 once TM 1
      would give more than two blocks an SM (never for M <= 16).
    * Decode (M <= 16, N > 128): TM 1 and the fewest thread rows (4, 8 or
      16) that cover M, at the tile measured fastest for them.
    """
    split = split_k(k, n, mode)
    if n > NARROW_N and m > DECODE_M:
        tile = next((t for t in _LARGE
                     if _blocks(m, n, e, *t[:3]) >= FILL_LARGE), _LARGE[-1])
        return DensePlan(1, *tile)
    if n <= NARROW_N:
        bn, tn = next(t for t in _NARROW if t[0] >= n)
        tm = 4 if (m > DECODE_M and _blocks(m, n, e, bn, tn, 1, split)
                   >= FILL_BLOCKS) else 1
        return DensePlan(split, bn, tn, tm, RING_STAGES)
    bn, tn = _DECODE[next(r for r in sorted(_DECODE) if r >= m)]
    return DensePlan(1, bn, tn, 1, RING_STAGES)


def launch_plan(plan: Optional[DensePlan], m, n, k, e, mode) -> DensePlan:
    """``plan``, or :func:`dense_plan`'s when it is None."""
    return dense_plan(m, n, k, e, mode) if plan is None else DensePlan(*plan)


def pfp_dense_cuda(x_a, x_b, w_a, w_b, *, mode: int,
                   plan: Optional[DensePlan] = None):
    """Launch the dense kernel on 2-D CUDA operands: (M,K) x (K,N) -> fp32
    (mean, var) of shape (M, N). ``mode`` picks the operands' meaning:
    Eq. 12 (mu_x, srm_x, mu_w, srm_w), Eq. 13 (x, x, mu_w, var_w) or Eq. 7
    (mu_x, var_x, mu_w, var_w). ``plan`` overrides :func:`dense_plan` (to
    time one plan against another); one the kernel did not instantiate
    raises."""
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
    plan = launch_plan(plan, m, n, k, 1, mode)
    lib = _build.load()
    with torch.cuda.device(x_a.device):
        status = lib.pfp_dense_launch(
            mode, x_a.data_ptr(), x_b.data_ptr(), w_a.data_ptr(),
            w_b.data_ptr(), mu.data_ptr(), var.data_ptr(), m, n, k, *plan,
            stream_ptr(x_a.device))
    _build.check(status, f"pfp_dense_launch {plan}")
    LAUNCHES[_COUNTER[mode]] += 1
    return mu, var
