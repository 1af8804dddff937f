"""The dense kernel's launch plan and the MoE expert-row counts.

On the CPU: ``kernels/pfp_dense.py``'s ``dense_plan`` (the K split depends
only on (K, N, mode); no split at an LM shape up to K 4096, 4 or 8
ranks past it; TM 1 for M <= 16; the 128 x 128 wide tile exactly where
it fills the card; every plan it gives is one ``csrc/pfp_dense.cu``
instantiates), the batched
plain versions with ``rows=``, the counts ``nn/moe.py`` passes to the
expert MLP, and ``moe_apply`` with and without them, bit for bit.

The tests marked ``gpu`` hold the kernel on the card: against its plain
version at the paper's shapes at batch 10, 100 and 1024, at ragged K on
both sides of each split boundary, at granite-8b's decode shapes and at
ragged large-regime shapes under both wide tiles (single, and batched
with ``rows``); a row's bits independent of M; Eq. 12 at long K within
an fp64 bound that TF32 inputs break; the Eq. 12 cancellation
check at a split shape; the batched kernel with ``rows``; and a plan the
kernel did not instantiate refused. They skip where there is no card:
``python -m pytest -m gpu tests/test_torch_dense_plan.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.gaussian import SRM, GaussianTensor
from repro_torch.core.modes import Mode
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pfp_dense import (FILL_LARGE, MODE_FIRST_LAYER,
                                           MODE_SRM, MODE_VAR, RING_STAGES,
                                           TILES, WIDE_STAGES, DensePlan,
                                           dense_plan, pfp_dense_cuda,
                                           split_k, thread_rows, walks_split)
from repro_torch.kernels.pfp_moe import pfp_dense_batched_cuda
from repro_torch.nn import moe
from repro_torch.nn.module import Context

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "csrc" / "pfp_dense.cu")
MODES = (MODE_SRM, MODE_FIRST_LAYER, MODE_VAR)
FORMS = ("srm", "first_layer", "var")
DENSE_TOL = dict(rtol=1e-5, atol=1e-4)
LM_ARCHS = ("granite-8b", "deepseek-moe-16b", "llama4-scout-17b-a16e")
BATCHES = (10, 100, 1024)


def paper_shapes(b):
    """(M, K, N) of every dense of LeNet-5 and the MLP at batch ``b``."""
    return [(784 * b, 25, 6), (196 * b, 150, 16), (b, 784, 120),
            (b, 120, 84), (b, 84, 10), (b, 784, 100), (b, 100, 100),
            (b, 100, 10)]


def lm_dense_kn(cfg):
    """(K, N) of every dense of an LM config at full width: attention
    projections, dense and shared-expert MLPs, routed experts, LM head."""
    d, kv, ff = cfg.d_model, cfg.num_kv_heads * cfg.head_dim, cfg.d_ff
    kn = {(d, cfg.attn_dim), (d, kv), (cfg.attn_dim, d), (d, ff), (ff, d),
          (d, cfg.vocab_size)}
    if cfg.num_shared_experts:
        shared = ff * cfg.num_shared_experts
        kn |= {(d, shared), (shared, d)}
    return sorted(kn)


# ---------------------------------------------------------------------------
# The plan (CPU)
# ---------------------------------------------------------------------------
def test_tiles_are_the_kernels_instantiations():
    """TILES is csrc/pfp_dense.cu's PFP_DENSE_TILES list, in its order."""
    text = SOURCE.read_text()
    block = text[text.index("#define PFP_DENSE_TILES(X)"):]
    block = block[:block.index("\n\n")]
    found = tuple(tuple(int(v) for v in m.groups()) for m in re.finditer(
        r"X\((\d+), (\d+), (\d+), (\d+)\)", block))
    assert found == TILES


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [6, 10, 16, 84, 100, 120, 128, 129, 1408,
                               4096])
def test_split_depends_only_on_k_n_mode(mode, n):
    for k in (0, 1, 17, 25, 84, 127, 128, 129, 150, 783, 784, 785, 4096,
              4097, 6144, 14336, 20000):
        want = split_k(k, n, mode)
        for m in (1, 4, 6, 16, 17, 100, 1024, 200704):
            for e in (1, 64):
                assert dense_plan(m, n, k, e, mode).split == want


def test_split_boundaries():
    """About one rank per 48 of K in whole tiles, at most 8, for N in
    [64, 128] and K > 64; none elsewhere."""
    ks = (1, 17, 64, 65, 96, 97, 100, 120, 127, 129, 783, 784, 785, 4096)
    assert [split_k(k, 100) for k in ks] == \
        [1, 1, 1, 2, 2, 3, 3, 3, 3, 3, 7, 7, 8, 8]
    for k in ks:
        split = split_k(k, 128)
        chunk = -(-(-(-k // split)) // 16) * 16
        assert (split - 1) * chunk < k <= split * chunk   # no empty rank
        assert split_k(k, 63) == split_k(k, 129) == split_k(k, 16) == 1


def test_long_k_split_boundaries():
    """N > 128: no split up to K 4096, then the fewest of 4 or 8 ranks
    that leave each at most 2048 of K (8 past 16384), every rank whole
    tiles of 16 and none empty."""
    ks = (4096, 4097, 5120, 6144, 8192, 8193, 10944, 14336, 16384, 16385,
          40000)
    for n in (129, 4096, 49152):
        assert [split_k(k, n) for k in ks] == [1, 4, 4, 4, 4, 8, 8, 8, 8,
                                               8, 8]
    for k in ks:
        split = split_k(k, 4096)
        chunk = -(-(-(-k // split)) // 16) * 16
        assert (split - 1) * chunk < k <= split * chunk   # no empty rank
        assert split == 1 or chunk <= 2048 or split == 8


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_no_split_at_any_lm_shape(arch):
    """N > 128 everywhere: no split up to K 4096, and past it the same
    split at every M and E, so prefill and decode rows agree bit for
    bit."""
    cfg = get_config(arch)
    experts = max(cfg.num_experts, 1)
    for k, n in lm_dense_kn(cfg):
        assert n > 128
        for m in (1, 4, 6, 16, 240, 2048):
            for e in {1, experts}:
                plan = dense_plan(m, n, k, e)
                assert plan.split == split_k(k, n), (arch, m, k, n, e)
                assert (plan.split == 1) == (k <= 4096), (arch, k, n)
                assert plan[1:] in TILES
                assert plan.stages > 1   # the cp.async ring, every regime


@pytest.mark.parametrize("arch", ("granite-8b", "deepseek-moe-16b"))
def test_wide_tile_exactly_where_it_fills_the_card(arch):
    """At the prefill chunk (M 128), the MoE capacity (240) and the forward
    (2048), for one problem and for every expert: 128 x 128 (8 x 8 outputs
    a thread) exactly where that gives FILL_LARGE blocks (5/6 of the SMs);
    elsewhere the first smaller tile that does, or the one with the most
    blocks. A split of K is walked in one block, so it adds none."""
    cfg = get_config(arch)
    for k, n in lm_dense_kn(cfg):
        for m in (128, 240, 2048):
            for e in {1, max(cfg.num_experts, 1)}:
                plan = dense_plan(m, n, k, e)
                assert walks_split(m, n)
                assert plan.split == split_k(k, n) and plan.stages == (
                    WIDE_STAGES if plan.tn == 8 else RING_STAGES)
                rows = plan.tm * thread_rows(plan.bn, plan.tn)
                blocks = -(-m // rows) * -(-n // plan.bn) * e
                fills = -(-m // 128) * -(-n // 128) * e >= FILL_LARGE
                assert ((plan.bn, plan.tn, plan.tm) == (128, 8, 8)) == fills
                assert blocks >= FILL_LARGE or plan == (1, 64, 4, 1,
                                                        RING_STAGES)


def test_wide_tiles_at_the_main_paths():
    """granite's forward: every dense at 128 x 128; its prefill chunks of
    128 rows: 128 x 128 where N is 14336 or more, the ring tiles where it
    is 1024 or 4096 (16 x 64 and 64 x 64, 128 blocks each); the down
    projection's K 14336 in 8 ranges; deepseek's experts at 128 x 128."""
    wide = DensePlan(1, 128, 8, 8, 2)
    chunk = {1024: DensePlan(1, 64, 4, 1, 4), 4096: DensePlan(1, 64, 4, 4, 4)}
    for k, n in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                 (4096, 49152)):
        split = split_k(k, n)
        assert dense_plan(2048, n, k) == wide._replace(split=split)
        assert dense_plan(128, n, k) == chunk.get(n, wide)._replace(
            split=split)
    assert split_k(14336, 4096) == 8
    assert dense_plan(256, 4096, 4096) == DensePlan(1, 128, 8, 4, 2)
    assert dense_plan(240, 1408, 2048, 64) == wide
    assert dense_plan(240, 2048, 1408, 64) == wide
    assert DensePlan(1, 64, 4, 4, 1)[1:] not in TILES   # no synchronous loop
    assert all(stages > 1 for *_, stages in TILES)


@pytest.mark.parametrize("m", range(1, 17))
def test_one_row_per_thread_up_to_16_rows(m):
    for n in (6, 100, 120, 1024, 1408, 14336, 49152):
        for e in (1, 64):
            plan = dense_plan(m, n, 784, e)
            assert plan.tm == 1 and plan.stages > 1
            if n > 128:   # decode: one tile of thread rows covers M
                assert thread_rows(plan.bn, plan.tn) >= m


@pytest.mark.parametrize("batch", BATCHES)
def test_paper_plans_are_instantiated(batch):
    for mode in MODES:
        for m, k, n in paper_shapes(batch):
            plan = dense_plan(m, n, k, 1, mode)
            assert plan[1:] in TILES
            assert plan.bn >= n and plan.bn // 2 < max(n, 8)  # one tile
            assert plan.stages > 1


def test_decode_tiles_cover_m_with_fewest_thread_rows():
    """granite-8b's 4-slot step: 4 thread rows, the LM head's tile; the
    MoE step at capacity 6: 8 thread rows."""
    for m, rows in ((1, 4), (4, 4), (5, 8), (6, 8), (8, 8), (9, 16),
                    (16, 16)):
        plan = dense_plan(m, 1408, 2048, 64)
        assert thread_rows(plan.bn, plan.tn) == rows
    assert dense_plan(4, 49152, 4096) == DensePlan(1, 64, 1, 1, 4)
    assert dense_plan(6, 1408, 2048, 64) == DensePlan(1, 128, 4, 1, 4)


# ---------------------------------------------------------------------------
# rows= (CPU)
# ---------------------------------------------------------------------------
def _batched(e, c, k, n, seed):
    rng = np.random.default_rng(seed)
    mx = rng.normal(size=(e, c, k)).astype(np.float32)
    vx = np.log1p(np.exp(rng.normal(size=(e, c, k)))).astype(np.float32)
    mw = (0.1 * rng.normal(size=(e, k, n))).astype(np.float32)
    vw = (0.1 * np.log1p(np.exp(rng.normal(size=(e, k, n))))).astype(
        np.float32)
    return [torch.from_numpy(a) for a in (mx, vx + mx * mx, mw, vw + mw * mw)]


def _plain(form, args, rows=None):
    if form == "var":
        return ref.pfp_dense_batched_var_ref(*args, rows=rows)
    if form == "first_layer":
        return ref.pfp_dense_batched_first_layer_ref(args[0], *args[2:],
                                                     rows=rows)
    return ref.pfp_dense_batched_ref(*args, rows=rows)


@pytest.mark.parametrize("form", FORMS)
def test_plain_versions_zero_rows_past_each_count(form):
    args = _batched(5, 7, 9, 4, seed=3)
    rows = torch.tensor([0, 7, 3, 1, 6], dtype=torch.int32)
    full = _plain(form, args)
    got = _plain(form, args, rows)
    for g, f in zip(got, full):
        for e, r in enumerate(rows.tolist()):
            assert torch.equal(g[e, :r], f[e, :r])
            assert not g[e, r:].any() and not g[e, r:].signbit().any()
    assert all(torch.equal(a, b) for a, b in zip(_plain(form, args, None),
                                                 full))


@pytest.mark.parametrize("form", FORMS)
def test_ops_pass_rows_to_the_plain_versions_on_the_cpu(form):
    args = _batched(3, 5, 8, 6, seed=4)
    rows = torch.tensor([2, 0, 5], dtype=torch.int32)
    if form == "var":
        got = ops.pfp_dense_batched_var(*args, rows=rows)
    else:
        got = ops.pfp_dense_batched(*args, first_layer=form == "first_layer",
                                    rows=rows)
    want = _plain(form, args, rows)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


D, FF, N_E, TOP_K = 16, 24, 8, 2


def _moe_block(gated, shared):
    return moe.MoE(D, FF, N_E, num_shared=1 if shared else 0, gated=gated,
                   sigma_init=1e-2, generator=torch.Generator().manual_seed(7),
                   device="cpu")


def _moe_input(seed, tokens=12):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(2, tokens, D)).astype(np.float32)
    return GaussianTensor(torch.from_numpy(mu), torch.from_numpy(
        mu ** 2 + 0.1), SRM)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_expert_rows_are_the_kept_rows_of_the_buffer(monkeypatch,
                                                     capacity_factor):
    """The counts _moe_tokens hands the expert MLP: the kept assignments
    per expert; every buffer row below the count holds a token, every row
    from it on is zero."""
    seen = []
    inner = moe._expert_mlp

    def spy(experts, x, ctx, activation, rows=None):
        seen.append((x.mean.clone(), rows.clone()))
        return inner(experts, x, ctx, activation, rows)

    monkeypatch.setattr(moe, "_expert_mlp", spy)
    ctx = Context(mode=Mode.PFP, impl="kernel", device="cpu")
    with moe.record_routing() as routes:
        moe.moe_apply(_moe_block(True, False), _moe_input(1), ctx,
                      num_experts=N_E, top_k=TOP_K,
                      capacity_factor=capacity_factor)
    (buf, rows), = seen
    r = routes[0]
    want = np.bincount(r.expert_idx.reshape(-1)[r.keep].numpy(),
                       minlength=N_E)
    assert rows.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), want)
    for e, count in enumerate(want):
        assert buf[e, :count].abs().sum(-1).gt(0).all()
        assert not buf[e, count:].any()
    if capacity_factor < 1:
        assert not r.keep.all()   # the drops are left out of the count


@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
@pytest.mark.parametrize("gated,shared", [(True, True), (False, False)])
def test_moe_apply_bitwise_with_and_without_rows(impl, formulation, gated,
                                                 shared):
    block = _moe_block(gated, shared)
    ctx = Context(mode=Mode.PFP, impl=impl, formulation=formulation,
                  device="cpu")
    x = _moe_input(2, tokens=5)
    kw = dict(num_experts=N_E, top_k=TOP_K, capacity_factor=1.0)
    out, aux = moe.moe_apply(block, x, ctx, **kw)
    with moe.empty_expert_skip(False):
        plain, plain_aux = moe.moe_apply(block, x, ctx, **kw)
    assert torch.equal(out.mean, plain.mean)
    assert torch.equal(out.var, plain.var)
    assert all(torch.equal(aux[k], plain_aux[k]) for k in aux)
    assert moe._SKIP_EMPTY


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(m, k, n, seed, form, device):
    g = torch.Generator().manual_seed(seed)
    mx = torch.randn((m, k), generator=g)
    vx = torch.nn.functional.softplus(torch.randn((m, k), generator=g))
    mw = 0.1 * torch.randn((k, n), generator=g)
    vw = 0.1 * torch.nn.functional.softplus(torch.randn((k, n), generator=g))
    if form == "srm":
        args = (mx, vx + mx * mx, mw, vw + mw * mw)
    elif form == "var":
        args = (mx, vx, mw, vw)
    else:
        args = (mx, mx, mw, vw)
    return [a.to(device) for a in args]


def _check_dense(form, args):
    mode = dict(zip(FORMS, MODES))[form]
    got = pfp_dense_cuda(*args, mode=mode)
    torch.cuda.synchronize()
    if form == "first_layer":
        want = ref.pfp_dense_first_layer_ref(args[0], args[2], args[3])
    elif form == "var":
        want = ref.pfp_dense_var_ref(*args)
    else:
        want = ref.pfp_dense_ref(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **DENSE_TOL)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("form", FORMS)
def test_dense_at_paper_shapes_on_card(cuda, form, batch):
    for i, (m, k, n) in enumerate(paper_shapes(batch)):
        _check_dense(form, _operands(m, k, n, i, form, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("k", [1, 17, 64, 65, 96, 97, 783, 784, 785])
def test_dense_at_split_boundaries_on_card(cuda, form, k):
    for m, n in ((37, 100), (5, 6), (300, 128)):
        _check_dense(form, _operands(m, k, n, k + n, form, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", [4096, 1024, 14336, 49152])
def test_dense_at_granite_decode_shapes_on_card(cuda, form, n):
    _check_dense(form, _operands(4, 4096, n, n, form, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(784, 120), (150, 16), (2048, 1408),
                                 (4096, 1024), (14336, 4096), (6144, 1536)])
@pytest.mark.parametrize("form", FORMS)
def test_row_bits_independent_of_m_on_card(cuda, form, k, n):
    """The first 6 rows, bit for bit, at M = 6, 100, 128, 256 and 1024 (up
    to four plans for the same weights; at (14336, 4096), K over 8 ranks,
    and at (6144, 1536), over 4: the decode tile and the wide tiles)."""
    mode = dict(zip(FORMS, MODES))[form]
    big = _operands(1024, k, n, 5, form, cuda)
    first = None
    for m in (6, 100, 128, 256, 1024):
        args = [a[:m] if i < 2 else a for i, a in enumerate(big)]
        got = [t[:6] for t in pfp_dense_cuda(*args, mode=mode)]
        if first is None:
            first = got
        assert all(torch.equal(a, b) for a, b in zip(got, first)), m


LARGE_RAGGED = ((300, 4100, 1000), (2049, 4096, 1031))


def wide_plans(k, n):
    """Both wide tiles at the split of (K, N): 4 ranks at K 4100."""
    return (DensePlan(split_k(k, n), 128, 8, 8, 2),
            DensePlan(split_k(k, n), 128, 8, 4, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", LARGE_RAGGED)
@pytest.mark.parametrize("form", FORMS)
def test_large_regime_ragged_on_card(cuda, form, shape):
    """M, K and N off the tile: both wide tiles against the plain version,
    and bit for bit each other."""
    m, k, n = shape
    mode = dict(zip(FORMS, MODES))[form]
    args = _operands(m, k, n, sum(shape), form, cuda)
    want = _check_dense(form, args)
    for plan in wide_plans(k, n):
        got = pfp_dense_cuda(*args, mode=mode, plan=plan)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), plan


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 300, 4100, 1000),
                                   (2, 2049, 1031, 260)])
@pytest.mark.parametrize("form", FORMS)
def test_large_regime_batched_rows_on_card(cuda, form, shape):
    """The batched wide tiles with kept-row counts against the plain
    version with the same counts, and each expert bit for bit the single
    dense kernel on its zero-padded rows."""
    e, c, k, n = shape
    mode = dict(zip(FORMS, MODES))[form]
    g = torch.Generator().manual_seed(sum(shape))
    rows = torch.randint(1, c + 1, (e,), generator=g, dtype=torch.int32)
    rows[-1] = c
    args = [a.to(cuda) for a in _batched(e, c, k, n, seed=sum(shape))]
    keep = (torch.arange(c)[None, :, None] < rows[:, None, None]).to(cuda)
    args[:2] = [torch.where(keep, a, 0.0) for a in args[:2]]
    rows = rows.to(cuda)
    want = _plain(form, args, rows)
    for plan in wide_plans(k, n):
        got = pfp_dense_batched_cuda(*args, mode=mode, rows=rows, plan=plan)
        torch.cuda.synchronize()
        for gt, w in zip(got, want):
            torch.testing.assert_close(gt, w, **DENSE_TOL)
        for ex in range(e):
            one = pfp_dense_cuda(*(a[ex] for a in args), mode=mode)
            assert torch.equal(one[0], got[0][ex]), (plan, ex)
            assert torch.equal(one[1], got[1][ex]), (plan, ex)


@pytest.mark.gpu
def test_eq12_cancellation_at_a_split_shape_on_card(cuda):
    """srm ~= mu^2 at (10, 784, 120), split over a cluster of 7: error
    against fp64 at most 4x the fp32 plain version's."""
    g = torch.Generator().manual_seed(1)
    mx = torch.relu(torch.randn((10, 784), generator=g)) + 0.1
    mw = 0.05 * torch.randn((784, 120), generator=g)
    sx = mx * mx + 1e-6 * torch.rand((10, 784), generator=g)
    sw = mw * mw + 4e-7
    mx, sx, mw, sw = (a.to(cuda) for a in (mx, sx, mw, sw))
    assert dense_plan(10, 120, 784).split == 7
    _, var_k = ops.pfp_dense(mx, sx, mw, sw)
    _, var_p = ref.pfp_dense_ref(mx, sx, mw, sw)
    d = [a.double() for a in (mx, sx, mw, sw)]
    var_64 = d[1] @ d[3] - (d[0] * d[0]) @ (d[2] * d[2])
    err_k = float((var_k.double() - var_64).abs().max())
    err_p = float((var_p.double() - var_64).abs().max())
    assert err_k <= 4 * err_p, (err_k, err_p)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(16, 14336, 4096), (4, 6144, 1536),
                                   (128, 14336, 4096)])
def test_long_k_within_fp64_bound_on_card(cuda, shape):
    """Eq. 12 where K is split: mean and variance within u sqrt(K)
    sum|products| of fp64 (u = 2^-24), a bound the same product on
    operands rounded to TF32 exceeds."""
    m, k, n = shape
    assert dense_plan(m, n, k).split > 1
    args = _operands(m, k, n, 3, "srm", cuda)
    tf32 = []
    for a in args:
        i = a.view(torch.int32)
        i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
        tf32.append(i.view(torch.float32))
    mx, sx, mw, sw = (a.double() for a in args)
    exact = (mx @ mw, sx @ sw - (mx * mx) @ (mw * mw))
    unit = 2.0 ** -24 * k ** 0.5
    bound = (unit * (mx.abs() @ mw.abs()),
             unit * (sx @ sw + (mx * mx) @ (mw * mw)))
    for out, within in ((pfp_dense_cuda(*args, mode=MODE_SRM), True),
                        (ref.pfp_dense_ref(*tf32), False)):
        for o, x, b in zip(out, exact, bound):
            assert bool(((o.double() - x).abs() <= b).all()) == within


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 6, 256, 1408), (6, 240, 130, 70),
                                   (4, 20, 33, 200)])
@pytest.mark.parametrize("form", FORMS)
def test_batched_rows_on_card(cuda, form, shape):
    """Rows past each count come out +0 (the kernel writes them); the rest
    bit for bit the rows=None kernel's, and each expert's slice the single
    dense kernel's on the same (zero-padded) rows."""
    e, c, k, n = shape
    mode = dict(zip(FORMS, MODES))[form]
    g = torch.Generator().manual_seed(sum(shape))
    rows = torch.randint(0, c + 1, (e,), generator=g, dtype=torch.int32)
    rows[0], rows[-1] = 0, c
    args = [a.to(cuda) for a in _batched(e, c, k, n, seed=sum(shape))]
    keep = (torch.arange(c)[None, :, None] < rows[:, None, None]).to(cuda)
    args[:2] = [torch.where(keep, a, 0.0) for a in args[:2]]
    full = pfp_dense_batched_cuda(*args, mode=mode)
    got = pfp_dense_batched_cuda(*args, mode=mode, rows=rows.to(cuda))
    torch.cuda.synchronize()
    for gt, f in zip(got, full):
        for ex, r in enumerate(rows.tolist()):
            assert torch.equal(gt[ex, :r], f[ex, :r])
            assert not gt[ex, r:].any() and not gt[ex, r:].signbit().any()
    for ex in range(e):
        one = pfp_dense_cuda(*(a[ex] for a in args), mode=mode)
        assert torch.equal(one[0], full[0][ex])
        assert torch.equal(one[1], full[1][ex])


@pytest.mark.gpu
def test_plan_not_instantiated_raises_on_card(cuda):
    args = _operands(4, 64, 256, 0, "srm", cuda)
    for plan in (DensePlan(1, 64, 4, 2, 1), DensePlan(2, 64, 4, 1, 1),
                 DensePlan(9, 128, 4, 1, 4), DensePlan(1, 128, 4, 1, 3),
                 DensePlan(1, 64, 4, 4, 1), DensePlan(0, 128, 8, 8, 2),
                 DensePlan(1, 128, 8, 8, 4)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            pfp_dense_cuda(*args, mode=MODE_SRM, plan=plan)
    with pytest.raises(ValueError, match="rows must be int32"):
        pfp_dense_batched_cuda(*(a[None] for a in args), mode=MODE_SRM,
                               rows=torch.zeros(1, device=cuda))
