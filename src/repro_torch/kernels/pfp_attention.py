"""Flash-style mean-field PFP attention on Hopper: out_mu = P.mu_v and
out_var = P^2.var_v from one online softmax.

Replaces the three entry points of ``repro/kernels/pfp_attention.py``:

  * ``pfp_attention_pallas``, without a KV cache: ``pfp_attention_cuda``,
    one block per (batch x KV head, :func:`flash_rows` rows of its query
    heads), both products register-blocked on a ``cp.async`` ring, bound
    by fp32 operations;
  * ``pfp_attention_cache_pallas``, the KV cache with per-batch
    ``q_start`` / ``kv_len``: ``pfp_attention_cache_cuda``;
  * ``pfp_attention_paged_pallas``, the paged cache read through a page
    table: ``pfp_attention_paged_cuda``.

The two cache kernels are one template of ``csrc/pfp_attention.cu`` that
differs only in a key row's address; the G query heads of a KV head are
packed into a block's rows; bound by bytes at decode. The keys are cut into
segments of ``SEGMENT`` at fixed positions and the segments' partial
softmax states are folded left in order, so a row's bits depend on its own
query and keys only. Every launch runs a plan from :func:`attention_plan`:
the block's rows and how many blocks of a cluster share a row tile's
segments. The source says how they are built. The plain versions are
``pfp_attention_ref``, ``pfp_attention_cache_ref`` and
``pfp_attention_paged_ref`` (``kernels/ref.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import (LAUNCHES, aligned16, cuda_operands,
                                         stream_ptr)
from repro_torch.kernels.ref import (pfp_attention_cache_ref,  # noqa: F401
                                     pfp_attention_paged_ref,
                                     pfp_attention_ref)

# Row 9's widths: the reduced test config, musicgen-medium, granite-8b (and
# the other llama-style configs) and gemma-7b.
HEAD_DIMS = (16, 64, 128, 256)
# Rows 10 and 11 take the same, 256 also for recurrentgemma-2b.
CACHE_HEAD_DIMS = HEAD_DIMS

# Rows a block without a cache (FlashShape<D>::kRows): 128, and 64 at
# head_dim 256, where 128 rows and their tiles pass an SM's shared memory.
FLASH_ROWS, WIDE_FLASH_ROWS = 128, 64
SEGMENT = 128          # keys a segment: csrc/pfp_attention.cu kSegment
BLOCK_ROWS = (8, 64)   # rows a block (decode, else): PFP_ATTENTION_BLOCKS
# At head_dim 256 (tiles of WIDE_TILE_KEYS): PFP_ATTENTION_WIDE_BLOCKS.
WIDE_BLOCK_ROWS = (16, 32)
MAX_CLUSTER = 8        # the portable cluster size: its kMaxCluster
# The cache kernel's threads, warps, keys a tile and tiles in its ring:
# kThreads, kWarps, kBK and kStages; kWideBK keys a tile at head_dim 256.
THREADS, WARPS, TILE_KEYS, STAGES = 256, 8, 32, 2
WIDE_TILE_KEYS = 16
# The H100: SMs, and an SM's threads and shared memory, of which the
# runtime keeps 1 KB a block, and its registers, handed out to a thread in
# steps of 8.
SMS, SM_THREADS, SM_SMEM, SMEM_RESERVED = 132, 2048, 228 * 1024, 1024
SM_REGISTERS, REGISTER_STEP = 64 * 1024, 8
# Registers a thread of each cache-kernel instantiation takes, by (head_dim,
# block rows): the larger of its contiguous and paged forms, as ptxas
# reports them for sm_90a (nvcc 12.8; chip_smoke.py prints them). They bind
# the 64-row block at head_dim 16 and 64 to one block an SM, and the decode
# block at 16 to four; the gpu tests hold blocks_per_sm to the library's
# occupancy, so a compiler that moves them shows there.
KV_REGISTERS = {(16, 8): 64, (16, 64): 182, (64, 8): 64, (64, 64): 183,
                (128, 8): 74, (128, 64): 247, (256, 16): 125,
                (256, 32): 211}


def flash_rows(d: int) -> int:
    """Rows a block of the kernel without a cache holds at head_dim ``d``."""
    return WIDE_FLASH_ROWS if d > 128 else FLASH_ROWS


def block_sizes(d: int):
    """The block sizes (rows) instantiated at head_dim ``d``."""
    return WIDE_BLOCK_ROWS if d > 128 else BLOCK_ROWS


def tile_keys(d: int) -> int:
    """Keys a staged tile at head_dim ``d``: one size for every block of a
    width, so a row's bits do not depend on the block."""
    return WIDE_TILE_KEYS if d > 128 else TILE_KEYS


class AttentionPlan(NamedTuple):
    """How one cache-attention launch is cut: ``block_rows`` query rows a
    block; ``cluster`` blocks of a thread-block cluster share one row
    tile's keys, rank r taking segments r, r + cluster, ... of it. No
    field moves a bit of the result."""

    block_rows: int
    cluster: int


def segments(capacity: int) -> int:
    """Segments of a cache that holds ``capacity`` keys."""
    return -(-capacity // SEGMENT)


def kv_block_bytes(d: int, block_rows: int) -> int:
    """Shared memory of a cache-kernel block, as ``KvTile<D, BQ>::kBytes``
    lays it out: Q, the ring of K / mu_v / var_v tiles (or a segment's
    partial laid over it), p, and the running accumulators where a thread
    has more than 16."""
    keys = tile_keys(d)
    acc = block_rows // WARPS * max(d // 32, 1) * 2
    stage = keys * (d + 4) + 2 * keys * d
    ring = max(STAGES * stage, acc * THREADS + 2 * block_rows)
    run = acc * THREADS if acc > 16 else 0
    return 4 * (block_rows * d + ring + block_rows * keys + run)


def blocks_per_sm(d: int, block_rows: int) -> int:
    """Blocks an SM holds by shared memory, threads and registers
    (``KV_REGISTERS``): 2 decode blocks (102 KB) or 1 of 64 rows (201 KB)
    at head_dim 128, shared memory binding; at head_dim 64, 4 decode blocks
    (52 KB, 64 registers) and 1 of 64 rows (105 KB, but 183 registers); at
    256, 1 of 16 rows (146 KB) or of 32 (195 KB)."""
    regs = -(-KV_REGISTERS[(d, block_rows)] // REGISTER_STEP) * REGISTER_STEP
    return min(SM_SMEM // (kv_block_bytes(d, block_rows) + SMEM_RESERVED),
               SM_THREADS // THREADS, SM_REGISTERS // (regs * THREADS))


def attention_plan(b: int, h: int, hkv: int, tq: int, capacity: int,
                   d: int) -> AttentionPlan:
    """The plan for q (b, h, tq, d) against a cache of ``capacity`` keys a
    slot (S contiguous, P * page_size paged), never its ``kv_len``, which
    stays on the device.

    The smallest block of :func:`block_sizes` that holds the G query heads
    of a KV head times Tq, else the largest: up to head_dim 128 the decode
    block (8 rows) where they fit it, else 64 rows; at 256, 16 rows (the 10
    of recurrentgemma-2b's decode step) or 32. The cluster is the largest
    power of two (at most 8 and the cache's segment count) whose blocks
    still run in one wave at :func:`blocks_per_sm`, else 1: a second wave
    cost more than the keys it split (PERF.md, the segment sweep). So 8 at
    a 4-slot decode of granite-8b (256 blocks), 4 of deepseek-moe-16b (256)
    and of musicgen-medium (384, four blocks an SM at head_dim 64), 2 at a
    128-row prefill chunk of one slot (128; musicgen's 96), 1 where the row
    tiles fill the card. A block that no SM can hold is refused."""
    if d not in CACHE_HEAD_DIMS:
        raise ValueError(f"no cache attention kernel for head_dim {d}; "
                         f"built for {CACHE_HEAD_DIMS}")
    rows = (h // hkv) * tq
    sizes = block_sizes(d)
    bq = next((r for r in sizes if rows <= r), sizes[-1])
    per_sm = blocks_per_sm(d, bq)
    if per_sm < 1:
        raise ValueError(f"a block of {bq} rows at head_dim {d} fits no SM")
    blocks = -(-rows // bq) * b * hkv
    limit = min(MAX_CLUSTER, segments(capacity))
    cluster = 1
    while (2 * cluster <= limit
           and blocks * 2 * cluster <= SMS * per_sm):
        cluster *= 2
    return AttentionPlan(bq, cluster)


def check_plan(plan, d: int) -> AttentionPlan:
    """``plan`` as an AttentionPlan; raises if the kernel does not take it
    at head_dim ``d``, or no SM holds its block."""
    plan = AttentionPlan(*plan)
    if d not in CACHE_HEAD_DIMS:
        raise ValueError(f"attention plan {tuple(plan)}: no cache attention "
                         f"kernel for head_dim {d}")
    sizes = block_sizes(d)
    if (plan.block_rows not in sizes
            or not 1 <= plan.cluster <= MAX_CLUSTER):
        raise ValueError(f"attention plan {tuple(plan)}: block_rows in "
                         f"{sizes} at head_dim {d}, cluster "
                         f"1..{MAX_CLUSTER}")
    if blocks_per_sm(d, plan.block_rows) < 1:
        raise ValueError(f"attention plan {tuple(plan)}: a block of "
                         f"{plan.block_rows} rows at head_dim {d} fits no SM")
    return plan


def plan_blocks(plan: AttentionPlan, b: int, h: int, hkv: int,
                tq: int) -> int:
    """The blocks a launch under ``plan`` starts."""
    rows = (h // hkv) * tq
    return -(-rows // plan.block_rows) * plan.cluster * b * hkv


def pfp_attention_cuda(q_mu, k_mu, v_mu, v_var, *, scale: float,
                       causal: bool = True):
    """Launch the attention kernel: q (B, H, Tq, D) x k, v (B, Hkv, Tk, D)
    CUDA tensors, H a multiple of Hkv. Returns fp32 (mean, var) of q's
    shape."""
    q_mu, k_mu, v_mu, v_var = cuda_operands(q_mu, k_mu, v_mu, v_var)
    if q_mu.dim() != 4 or k_mu.dim() != 4:
        raise ValueError(f"attention takes (B, H, T, D) tensors, got "
                         f"{tuple(q_mu.shape)} and {tuple(k_mu.shape)}")
    b, h, tq, d = q_mu.shape
    hkv, tk = k_mu.shape[1], k_mu.shape[2]
    if (k_mu.shape != (b, hkv, tk, d) or v_mu.shape != k_mu.shape
            or v_var.shape != k_mu.shape or h % hkv):
        raise ValueError(f"attention shapes q {tuple(q_mu.shape)}, k "
                         f"{tuple(k_mu.shape)}, v {tuple(v_mu.shape)}, "
                         f"v_var {tuple(v_var.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"no attention kernel for head_dim {d}; built for "
                         f"{HEAD_DIMS}")
    row_tiles = -(-(h // hkv) * tq // flash_rows(d))
    if row_tiles > 65535:
        raise ValueError(f"{row_tiles} row tiles of {flash_rows(d)} are "
                         f"above the grid's 65535")
    q_mu, k_mu, v_mu, v_var = (aligned16(t) for t in (q_mu, k_mu, v_mu,
                                                       v_var))
    out_mu = torch.empty_like(q_mu)
    out_var = torch.empty_like(q_mu)
    if q_mu.numel() == 0:
        return out_mu, out_var
    lib = _build.load()
    with torch.cuda.device(q_mu.device):
        status = lib.pfp_attention_launch(
            q_mu.data_ptr(), k_mu.data_ptr(), v_mu.data_ptr(),
            v_var.data_ptr(), out_mu.data_ptr(), out_var.data_ptr(), b, h,
            hkv, tq, tk, d, scale, int(causal), stream_ptr(q_mu.device))
    _build.check(status, "pfp_attention_launch")
    LAUNCHES["attention"] += 1
    return out_mu, out_var


def _window(window) -> int:
    """The kernels' window argument: 0 for none."""
    if window is None:
        return 0
    if window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return int(window)


def _kv_launch(paged, q_mu, k, v_mu, v_var, page_table, q_start, kv_len, *,
               scale, causal, window, s_rows, num_pages, plan):
    """Checks shared by both cache kernels, then one launch under ``plan``
    (:func:`attention_plan`'s when None)."""
    if q_mu.dim() != 4 or k.dim() != 4:
        raise ValueError(f"attention takes 4-D tensors, got "
                         f"{tuple(q_mu.shape)} and {tuple(k.shape)}")
    b, h, tq, d = q_mu.shape
    hkv = k.shape[1]
    if (k.shape[3] != d or v_mu.shape != k.shape or v_var.shape != k.shape
            or h % hkv):
        raise ValueError(f"attention shapes q {tuple(q_mu.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v_mu.shape)}, v_var "
                         f"{tuple(v_var.shape)}")
    if tuple(q_start.shape) != (b,) or tuple(kv_len.shape) != (b,):
        raise ValueError(f"q_start {tuple(q_start.shape)} and kv_len "
                         f"{tuple(kv_len.shape)} must be ({b},)")
    if d not in CACHE_HEAD_DIMS:
        raise ValueError(f"no cache attention kernel for head_dim {d}; "
                         f"built for {CACHE_HEAD_DIMS}")
    if b * hkv > 65535:
        raise ValueError(f"B * Hkv = {b * hkv} is above the grid's 65535")
    q_mu, k, v_mu, v_var = (aligned16(t) for t in (q_mu, k, v_mu, v_var))
    ints = [t.to(device=q_mu.device, dtype=torch.int32).contiguous()
            for t in (page_table, q_start, kv_len)]
    if plan is None:
        capacity = s_rows * ints[0].shape[-1] if paged else s_rows
        plan = attention_plan(b, h, hkv, tq, capacity, d)
    out_mu = torch.empty_like(q_mu)
    out_var = torch.empty_like(q_mu)
    if q_mu.numel() == 0:
        return out_mu, out_var
    lib = _build.load()
    with torch.cuda.device(q_mu.device):
        status = lib.pfp_attention_kv_launch(
            int(paged), q_mu.data_ptr(), k.data_ptr(), v_mu.data_ptr(),
            v_var.data_ptr(), ints[0].data_ptr(), ints[1].data_ptr(),
            ints[2].data_ptr(), out_mu.data_ptr(), out_var.data_ptr(), b, h,
            hkv, tq, s_rows, ints[0].shape[-1], num_pages, d, scale,
            int(causal), _window(window), *plan, stream_ptr(q_mu.device))
    _build.check(status, f"pfp_attention_kv_launch {tuple(plan)}")
    LAUNCHES["attention_paged" if paged else "attention_cache"] += 1
    return out_mu, out_var


def pfp_attention_cache_cuda(q_mu, k_mu, v_mu, v_var, q_start, kv_len, *,
                             scale: float, causal: bool = True, window=None,
                             plan: Optional[AttentionPlan] = None):
    """Launch the KV-cache kernel: q (B, H, Tq, D) x cache (B, Hkv, S, D)
    CUDA tensors, q_start / kv_len (B,) integer tensors on the same card
    (read there: no host sync). Returns fp32 (mean, var) of q's shape.
    ``plan`` overrides :func:`attention_plan` (to time or test one plan
    against another); one the kernel does not take raises."""
    plan = None if plan is None else check_plan(plan, q_mu.shape[-1])
    q_mu, k_mu, v_mu, v_var = cuda_operands(q_mu, k_mu, v_mu, v_var)
    if k_mu.dim() != 4 or k_mu.shape[0] != q_mu.shape[0]:
        raise ValueError(f"cache {tuple(k_mu.shape)} does not match the "
                         f"query batch {q_mu.shape[0]}")
    return _kv_launch(False, q_mu, k_mu, v_mu, v_var, q_start.new_zeros(1),
                      q_start, kv_len, scale=scale, causal=causal,
                      window=window, s_rows=k_mu.shape[2], num_pages=0,
                      plan=plan)


def pfp_attention_paged_cuda(q_mu, k_pages, v_pages, vv_pages, page_table,
                             q_start, kv_len, *, scale: float,
                             causal: bool = True, window=None,
                             plan: Optional[AttentionPlan] = None):
    """Launch the paged kernel: q (B, H, Tq, D) x page pools
    (NP, Hkv, page_size, D) CUDA tensors read through ``page_table``
    (B, P); q_start / kv_len (B,). Returns fp32 (mean, var) of q's shape.
    ``plan`` as in :func:`pfp_attention_cache_cuda`."""
    plan = None if plan is None else check_plan(plan, q_mu.shape[-1])
    q_mu, k_pages, v_pages, vv_pages = cuda_operands(q_mu, k_pages, v_pages,
                                                     vv_pages)
    if page_table.dim() != 2 or page_table.shape[0] != q_mu.shape[0] \
            or page_table.shape[1] < 1:
        raise ValueError(f"page_table {tuple(page_table.shape)} must be "
                         f"({q_mu.shape[0]}, P >= 1)")
    return _kv_launch(True, q_mu, k_pages, v_pages, vv_pages, page_table,
                      q_start, kv_len, scale=scale, causal=causal,
                      window=window, s_rows=k_pages.shape[2],
                      num_pages=k_pages.shape[0], plan=plan)
