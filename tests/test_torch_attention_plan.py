"""Cache and paged attention: the launch plan and the bit contract.

On the CPU: ``attention_plan`` (``kernels/pfp_attention.py``) fills the
card at the 4-slot decode shapes of granite-8b and deepseek-moe-16b, reads
shapes and the cache's capacity only (never ``kv_len``), gives only plans
that ``csrc/pfp_attention.cu`` instantiates (read from the source), models
a block's shared memory with the source's constants, and a plan the kernel
does not take raises in the wrapper.

The tests marked ``gpu`` hold the bit contract on the card: a query row's
two outputs are a function of its query, its valid keys, its position,
``kv_len``, the window and the scale only. The rows of one slot (G 4 query
heads a KV head, as granite-8b, and G 1, as deepseek-moe-16b and
musicgen-medium, at every head_dim of ``HEAD_DIMS``, and G 10 at head_dim
256, as recurrentgemma-2b; a cache of 640 keys: 5 segments) come out
``torch.equal`` to those of
one Tq 512 call when run in chunks of 128, at Tq 4, 3, 2 (a speculative
verify block of 4 slots) and Tq 1; inside batches of 4 and 32 slots (one
of them without keys, which gives 0); through pages of 1, 16 and 24
rows in shuffled order; and under every block size and cluster a plan
may take (``plan=``), with and without a
window. The Tq 512 call and the plans of 8 ranks (every segment fold) are
also held to the plain version at ``ATT_TOL``. The library's block size
and occupancy match the plan's model of them. No JAX: ``python -m pytest
-m gpu tests/test_torch_attention_plan.py`` on the card. The cases without
``plan=`` also run against a tree whose wrappers take no plan.
"""
import ctypes
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.pfp_attention import HEAD_DIMS
from repro_torch.kernels.ref import (pfp_attention_cache_ref,
                                     pfp_attention_paged_ref)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "pfp_attention.cu")
# One slot: H query heads over HKV KV heads (HEADS) at head_dim D, a cache
# of S keys; its rows at positions N0 .. N0 + N - 1. SLOTS: (H, HKV, D) by
# id, head_dim 128 unsuffixed.
HEADS = {"G4": (8, 2), "G1": (4, 4)}
SLOTS = {(name if d == 128 else f"{name}-d{d}"): (*HEADS[name], d)
         for name in HEADS for d in HEAD_DIMS}
# recurrentgemma-2b's layout: 10 query heads of 256 over one KV head.
SLOTS["G10-d256"] = (10, 1, 256)
S = 640
N0, N = 88, 512
WINDOWS = (None, 100)
ATT_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_torch_decode.py
# (B, H, Hkv, Tq, capacity) of the decode shapes chip_smoke.py times.
GRANITE_DECODE = (4, 32, 8, 1, 1024)
DEEPSEEK_DECODE = (4, 16, 16, 1, 1024)


# ---------------------------------------------------------------------------
# The plan (CPU)
# ---------------------------------------------------------------------------
def _source_plan_space():
    return (_source_blocks("PFP_ATTENTION_BLOCKS"),
            _source_constant("kSegment"), _source_constant("kMaxCluster"))


def _source_blocks(macro):
    blocks = re.search(rf"#define {macro}\(X\) (.*)", SOURCE.read_text())
    return tuple(int(v) for v in re.findall(r"X\((\d+)\)", blocks.group(1)))


def _source_constant(name):
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert len(found) == 1, f"{name}: {found}"
    return int(found[0])


@pytest.mark.parametrize("shape", [GRANITE_DECODE, DEEPSEEK_DECODE],
                         ids=["granite-8b", "deepseek-moe-16b"])
def test_plan_fills_the_card_at_decode(shape):
    from repro_torch.kernels.pfp_attention import (SMS, attention_plan,
                                                   plan_blocks)
    b, h, hkv, tq, capacity = shape
    plan = attention_plan(b, h, hkv, tq, capacity, 128)
    assert plan.block_rows == 8
    assert SMS <= plan_blocks(plan, b, h, hkv, tq) <= 2 * SMS
    assert plan.cluster == 256 // (b * hkv)   # 8 for granite, 4 deepseek


def test_plan_reads_shapes_and_capacity_only():
    """The plan's arguments are shapes and the cache's capacity: kv_len and
    q_start stay on the device. A 128-row chunk of one slot takes a cluster
    of 2, a 4 x 512 prefill none, 32 decode slots none."""
    from repro_torch.kernels.pfp_attention import attention_plan
    assert list(inspect.signature(attention_plan).parameters) == [
        "b", "h", "hkv", "tq", "capacity", "d"]
    assert attention_plan(1, 32, 8, 128, 1024, 128) == (64, 2)
    assert attention_plan(4, 32, 8, 512, 1024, 128) == (64, 1)
    assert attention_plan(32, 32, 8, 1, 1024, 128) == (8, 1)
    # A paged pool of 64 pages of 16 rows holds what a 1024-row cache does.
    assert (attention_plan(4, 32, 8, 1, 64 * 16, 128)
            == attention_plan(4, 32, 8, 1, 1024, 128))


def test_every_plan_is_instantiated():
    """BLOCK_ROWS, SEGMENT and MAX_CLUSTER are the source's, and every plan
    over a sweep of shapes lies inside them, with no more cluster ranks
    than the cache has segments."""
    from repro_torch.kernels.pfp_attention import (BLOCK_ROWS, MAX_CLUSTER,
                                                   SEGMENT, attention_plan,
                                                   segments)
    blocks, segment, max_cluster = _source_plan_space()
    assert (blocks, segment, max_cluster) == (BLOCK_ROWS, SEGMENT,
                                              MAX_CLUSTER)
    for b in (1, 4, 32):
        for h, hkv in ((32, 8), (16, 16), (4, 2)):
            for tq in (1, 2, 3, 4, 128, 512):
                for capacity in (40, 640, 1024, 4096):
                    plan = attention_plan(b, h, hkv, tq, capacity, 128)
                    assert plan.block_rows in blocks
                    assert 1 <= plan.cluster <= min(max_cluster,
                                                    segments(capacity))
                    assert (plan.block_rows == 8) == ((h // hkv) * tq <= 8)


def test_wide_plans_are_instantiated():
    """At head_dim 256 the plan takes only PFP_ATTENTION_WIDE_BLOCKS: 16
    rows where G * Tq fits them (recurrentgemma-2b's decode step of 10),
    else 32, with a cluster within the cache's segments; recurrentgemma's
    4-slot decode step clusters 8 (32 blocks, each alone on an SM) and a
    128-token chunk of one slot (1280 rows, 40 blocks) 2."""
    from repro_torch.kernels.pfp_attention import (MAX_CLUSTER,
                                                   WIDE_BLOCK_ROWS,
                                                   attention_plan, segments)
    assert _source_blocks("PFP_ATTENTION_WIDE_BLOCKS") == WIDE_BLOCK_ROWS
    for b in (1, 4, 32):
        for h, hkv in ((10, 1), (16, 16), (8, 2)):
            for tq in (1, 2, 3, 4, 128, 512):
                for capacity in (40, 640, 2048, 4096):
                    plan = attention_plan(b, h, hkv, tq, capacity, 256)
                    assert plan.block_rows in WIDE_BLOCK_ROWS
                    assert 1 <= plan.cluster <= min(MAX_CLUSTER,
                                                    segments(capacity))
                    assert (plan.block_rows == 16) == ((h // hkv) * tq <= 16)
    assert attention_plan(4, 10, 1, 1, 2048, 256) == (16, 8)
    assert attention_plan(1, 10, 1, 128, 2048, 256) == (32, 2)


def test_plan_refuses_a_block_no_sm_holds(monkeypatch):
    """A 64-row block at head_dim 256 would take 393 KB, above an SM's 228:
    neither the plan nor a forced plan takes it."""
    from repro_torch.kernels import pfp_attention as pa
    assert pa.kv_block_bytes(256, 64) > pa.SM_SMEM
    monkeypatch.setattr(pa, "WIDE_BLOCK_ROWS", (64,))
    monkeypatch.setitem(pa.KV_REGISTERS, (256, 64), 200)
    with pytest.raises(ValueError, match="fits no SM"):
        pa.attention_plan(4, 10, 1, 1, 2048, 256)
    with pytest.raises(ValueError, match="fits no SM"):
        pa.check_plan((64, 1), 256)


def test_block_model_follows_the_source():
    """The plan's model of a block (kv_block_bytes, blocks_per_sm) is built
    on the source's thread, tile and ring counts: at head_dim 128 a decode
    block takes 102 KB (2 an SM) and a 64-row block 201 KB (1 an SM)."""
    from repro_torch.kernels.pfp_attention import (STAGES, THREADS,
                                                   TILE_KEYS, WARPS,
                                                   blocks_per_sm,
                                                   kv_block_bytes)
    assert (THREADS, TILE_KEYS, STAGES) == tuple(
        _source_constant(n) for n in ("kThreads", "kBK", "kStages"))
    assert "constexpr int kWarps = kThreads / 32;" in SOURCE.read_text()
    assert WARPS == THREADS // 32
    assert [kv_block_bytes(128, bq) for bq in (8, 64)] == [104448, 205824]
    assert [blocks_per_sm(128, bq) for bq in (8, 64)] == [2, 1]
    assert [kv_block_bytes(64, bq) for bq in (8, 64)] == [53248, 107520]
    assert [blocks_per_sm(64, bq) for bq in (8, 64)] == [4, 1]
    # head_dim 256: tiles of kWideBK keys; an 8-row block of 32-key tiles
    # would take 202 KB, the 16- and 32-row blocks take 146 and 195 KB.
    from repro_torch.kernels.pfp_attention import WIDE_TILE_KEYS, tile_keys
    assert WIDE_TILE_KEYS == _source_constant("kWideBK") == tile_keys(256)
    assert tile_keys(128) == TILE_KEYS
    assert [kv_block_bytes(256, bq) for bq in (16, 32)] == [148992, 199168]
    assert [blocks_per_sm(256, bq) for bq in (16, 32)] == [1, 1]


def test_register_model_covers_every_instantiation():
    """KV_REGISTERS has one count for each (head_dim, block rows) the
    source instantiates, and at the 64-row block of head_dim 64 registers
    bind where shared memory would allow two blocks."""
    from repro_torch.kernels.pfp_attention import (CACHE_HEAD_DIMS,
                                                   KV_REGISTERS, SM_SMEM,
                                                   SMEM_RESERVED,
                                                   block_sizes,
                                                   blocks_per_sm,
                                                   kv_block_bytes)
    assert set(KV_REGISTERS) == {(d, bq) for d in CACHE_HEAD_DIMS
                                 for bq in block_sizes(d)}
    assert SM_SMEM // (kv_block_bytes(64, 64) + SMEM_RESERVED) == 2
    assert blocks_per_sm(64, 64) == 1


def test_plan_at_musicgen_decode_and_chunk():
    """musicgen-medium (24 heads of 64, MHA): a 4-slot decode step takes
    the decode block in clusters of 4 (384 blocks, four an SM); a 128-row
    chunk of one slot 64-row blocks in clusters of 2 (96 blocks, one an
    SM)."""
    from repro_torch.kernels.pfp_attention import attention_plan, plan_blocks
    decode = attention_plan(4, 24, 24, 1, 1024, 64)
    assert decode == (8, 4) and plan_blocks(decode, 4, 24, 24, 1) == 384
    chunk = attention_plan(1, 24, 24, 128, 1024, 64)
    assert chunk == (64, 2) and plan_blocks(chunk, 1, 24, 24, 128) == 96
    assert attention_plan(4, 24, 24, 512, 1024, 64) == (64, 1)


@pytest.mark.parametrize("plan", [(16, 1), (8, 0), (64, 9)],
                         ids=["block_rows", "cluster0", "cluster9"])
def test_illegal_plan_raises_in_the_wrapper(plan):
    _illegal_plan_raises(plan, 16)


@pytest.mark.parametrize("plan", [(8, 1), (64, 1), (16, 9)],
                         ids=["block_rows8", "block_rows64", "cluster9"])
def test_illegal_wide_plan_raises_in_the_wrapper(plan):
    """At head_dim 256 only the 16- and 32-row blocks are built."""
    _illegal_plan_raises(plan, 256)


def _illegal_plan_raises(plan, d):
    from repro_torch.kernels.pfp_attention import (pfp_attention_cache_cuda,
                                                   pfp_attention_paged_cuda)
    q = torch.zeros((1, 4, 1, d))
    cache = torch.zeros((1, 2, 8, d))
    ints = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="attention plan"):
        pfp_attention_cache_cuda(q, cache, cache, cache, ints, ints,
                                 scale=0.25, plan=plan)
    with pytest.raises(ValueError, match="attention plan"):
        pfp_attention_paged_cuda(q, cache, cache, cache,
                                 torch.zeros((1, 1), dtype=torch.int32), ints,
                                 ints, scale=0.25, plan=plan)


# ---------------------------------------------------------------------------
# The bit contract (on the card)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_block_model_matches_the_library(cuda):
    """The library's shared memory for every instantiated block equals
    kv_block_bytes, and the blocks an SM holds (its occupancy, registers
    included) equal blocks_per_sm."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.pfp_attention import (CACHE_HEAD_DIMS,
                                                   block_sizes,
                                                   blocks_per_sm,
                                                   kv_block_bytes)
    lib = _build.load()
    for paged in (0, 1):
        for d in CACHE_HEAD_DIMS:
            for bq in block_sizes(d):
                nbytes, per_sm = ctypes.c_int(), ctypes.c_int()
                _build.check(lib.pfp_attention_kv_block(
                    paged, d, bq, ctypes.byref(nbytes),
                    ctypes.byref(per_sm)), "pfp_attention_kv_block")
                assert nbytes.value == kv_block_bytes(d, bq), (paged, d, bq)
                assert per_sm.value == blocks_per_sm(d, bq), (paged, d, bq)


def _gaussian_cache(rng, b, hkv, d):
    k, vm = (rng.normal(size=(b, hkv, S, d)).astype(np.float32)
             for _ in range(2))
    vv = np.log1p(np.exp(rng.normal(size=(b, hkv, S, d)))).astype(np.float32)
    return k, vm, vv


@pytest.fixture(scope="module", params=sorted(SLOTS))
def slot(request):
    """One slot's queries by position (H, N0 + N, D) and its cache, for
    each head layout and head_dim of SLOTS."""
    h, hkv, d = SLOTS[request.param]
    rng = np.random.default_rng(0)
    q = rng.normal(size=(h, N0 + N, d)).astype(np.float32)
    k, vm, vv = _gaussian_cache(rng, 1, hkv, d)
    return q, k[0], vm[0], vv[0]


def _pages(caches, kv_len, ps, seed):
    """Shuffled pools of pages of ``ps`` rows holding the caches' rows up to
    each slot's kv_len, and the page table (unused slots: the trash page
    0, whose rows are random)."""
    rng = np.random.default_rng(seed)
    b, hkv, _, d = caches[0].shape
    p = -(-S // ps)
    used = [-(-int(n) // ps) for n in kv_len]
    ids = rng.permutation(np.arange(1, 1 + sum(used) + 2))
    table = np.zeros((b, p), np.int32)
    pools = [rng.normal(size=(len(ids) + 1, hkv, ps, d)).astype(np.float32)
             for _ in caches]
    nxt = 0
    for bi in range(b):
        for j in range(used[bi]):
            table[bi, j] = ids[nxt]
            nxt += 1
            rows = slice(j * ps, min((j + 1) * ps, S))
            for pool, src in zip(pools, caches):
                pool[table[bi, j], :, :rows.stop - rows.start] = \
                    src[bi, :, rows]
    return pools, table


def _run(slot, device, q_start, tq, *, b=1, at=0, window=None, ps=None,
         plan=None, seed=1, ref=False):
    """The slot's rows at positions q_start .. q_start + tq - 1 (kv_len
    q_start + tq), run as slot ``at`` of a batch of ``b``; the other slots
    hold random keys, queries and lengths, the first of them none. Returns
    the slot's (mean, var) rows (H, tq, D). With ``ref``, every slot's
    outputs are also held to the plain version at ATT_TOL."""
    q_all, k, vm, vv = slot
    d = q_all.shape[-1]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, q_all.shape[0], tq, d)).astype(np.float32)
    q[at] = q_all[:, q_start:q_start + tq]
    caches = _gaussian_cache(rng, b, k.shape[0], d)
    for cache, mine in zip(caches, (k, vm, vv)):
        cache[at] = mine
    starts = rng.integers(0, S - tq, size=b).astype(np.int32)
    lens = (starts + tq).astype(np.int32)
    starts[at], lens[at] = q_start, q_start + tq
    empty = (at + 1) % b if b > 1 else None
    if empty is not None:
        starts[empty], lens[empty] = 0, 0
    if ps is None:
        args = [q, *caches]
    else:
        pools, table = _pages(caches, lens, ps, seed)
        args = [q, *pools, table]
    args = [torch.from_numpy(a).to(device)
            for a in args + [starts, lens]]
    kw = dict(scale=d ** -0.5, window=window)
    if plan is None:
        fn = ops.pfp_attention_cache if ps is None else ops.pfp_attention_paged
    else:
        from repro_torch.kernels.pfp_attention import (
            pfp_attention_cache_cuda, pfp_attention_paged_cuda)
        fn = pfp_attention_cache_cuda if ps is None else \
            pfp_attention_paged_cuda
        kw["plan"] = plan
    mu, var = fn(*args, **kw)
    torch.cuda.synchronize()
    if ref:
        kw.pop("plan", None)
        plain = pfp_attention_cache_ref if ps is None else \
            pfp_attention_paged_ref
        want = plain(*(a.cpu() for a in args), **kw)
        for name, g, w in (("mean", mu, want[0]), ("var", var, want[1])):
            torch.testing.assert_close(g.cpu(), w, **ATT_TOL,
                                       msg=lambda m: f"{name}: {m}")
    if empty is not None:
        assert not mu[empty].any() and not var[empty].any(), \
            "a slot without keys is not 0"
    return mu[at].cpu(), var[at].cpu()


@pytest.fixture(scope="module")
def whole(slot):
    """The slot's N rows from one Tq N call (B 1, its own plan: 5 segments
    folded in turn), per window, held to the plain version: the rows every
    other run is held to."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return {w: _run(slot, torch.device("cuda"), N0, N, window=w, ref=True)
            for w in WINDOWS}


def _assert_rows(got, whole, q_start, what):
    mu, var = got
    tq = mu.shape[1]
    rows = slice(q_start - N0, q_start - N0 + tq)
    for name, g, w in (("mean", mu, whole[0][:, rows]),
                       ("var", var, whole[1][:, rows])):
        same = (g == w).all(dim=-1)   # per (head, row)
        assert bool(same.all()), (
            f"{what}: {name} of {int((~same).sum())} of {same.numel()} "
            f"(head, row) pairs differ from the Tq {N} call, at most "
            f"{float((g - w).abs().max()):.3e}")


# Runs of the slot's rows: (q_start and tq of each call, b, at).
RUNS = {
    "tq128": ([(N0 + 128 * c, 128) for c in range(N // 128)], 1, 0),
    "tq3": ([(N0, 3), (N0 + 250, 3), (N0 + N - 3, 3)], 1, 0),
    "tq1": ([(p, 1) for p in (N0, N0 + 39, N0 + 40, N0 + 167, N0 + N - 1)],
            1, 0),
    # A speculative engine's verify pass: K = 2 keeps the 8-row block at
    # G 4, K = 4 takes the 64-row one; slot 2 of a 4-slot batch.
    "tq2": ([(N0, 2), (N0 + 127, 2), (N0 + 255, 2), (N0 + N - 2, 2)], 4, 2),
    "tq4": ([(N0, 4), (N0 + 126, 4), (N0 + 300, 4), (N0 + N - 4, 4)], 4, 2),
    "b4": ([(N0 + 300, 1), (N0 + 128, 128)], 4, 2),
    "b32": ([(N0 + 200, 1), (N0 + N - 1, 1)], 32, 17),
}


@pytest.mark.gpu
@pytest.mark.parametrize("window", WINDOWS, ids=["full", "window"])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_rows_bit_for_bit_across_tq_and_batch(cuda, slot, whole, run,
                                              window):
    calls, b, at = RUNS[run]
    for q_start, tq in calls:
        got = _run(slot, cuda, q_start, tq, b=b, at=at, window=window)
        _assert_rows(got, whole[window], q_start,
                     f"{run}: q_start {q_start}, Tq {tq}")


@pytest.mark.gpu
@pytest.mark.parametrize("window", WINDOWS, ids=["full", "window"])
@pytest.mark.parametrize("ps", [1, 16, 24])
def test_paged_rows_bit_for_bit(cuda, slot, whole, ps, window):
    """Shuffled pages of 1, 16 and 24 rows: a decode step of 4 slots, a
    4-token verify block of 4 slots and a chunk of 128 rows of one, as the
    contiguous cache gives them."""
    for q_start, tq, b, at in ((N0 + 300, 1, 4, 2), (N0 + 300, 4, 4, 2),
                               (N0 + 256, 128, 1, 0), (N0 + N - 1, 1, 1, 0)):
        got = _run(slot, cuda, q_start, tq, b=b, at=at, window=window, ps=ps,
                   seed=ps)
        _assert_rows(got, whole[window], q_start,
                     f"pages of {ps}: q_start {q_start}, Tq {tq}, B {b}")


@pytest.mark.gpu
@pytest.mark.parametrize("window", WINDOWS, ids=["full", "window"])
@pytest.mark.parametrize("block", [0, 1], ids=["small", "large"])
def test_rows_bit_for_bit_under_every_plan(cuda, slot, whole, block,
                                           window):
    """Every cluster size 1 .. 8 at both block sizes of the head_dim (8 and
    64 rows, 16 and 32 at 256): a whole Tq 512 call, a 128-row chunk and a
    4-slot decode step, contiguous and (the chunk) paged. At 8 ranks, each
    of the 5 segments a rank's partial folded by rank 0, the outputs are
    also held to the plain version."""
    from repro_torch.kernels.pfp_attention import block_sizes
    block_rows = block_sizes(slot[0].shape[-1])[block]
    for cluster in range(1, 9):
        plan = (block_rows, cluster)
        for q_start, tq, b, at, ps in ((N0, N, 1, 0, None),
                                       (N0 + 128, 128, 1, 0, 16),
                                       (N0 + 300, 1, 4, 2, None)):
            got = _run(slot, cuda, q_start, tq, b=b, at=at, window=window,
                       ps=ps, plan=plan, ref=cluster == 8)
            _assert_rows(got, whole[window], q_start,
                         f"plan {plan}: q_start {q_start}, Tq {tq}, B {b}, "
                         f"pages {ps}")
