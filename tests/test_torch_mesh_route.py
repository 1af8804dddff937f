"""The kernel impl's mesh route, emulated for 2 and 4 ranks in one process.

No process group: each op's plan (``core/mesh_route.py``) places the
inputs, each emulated rank runs the op's kernel impl on its blocks (on the
CPU, the kernels' plain versions), and the outputs are put together as the
plan's output placements say: blocks of a split joined, partial sums added
in rank order. The result equals the unsharded op, and the reference's
``xla`` impl, within the reference's op tolerances (dense rtol 1e-5 / atol
1e-4, attention 1e-4 / 1e-5):

* dense, Eq. 12, Eq. 13 and Eq. 7, with the weight split over N (column)
  and over K (row); the row split's partial outputs are VAR, and their
  means and variances add. Adding second moments instead, or the bias on
  every rank, misses the unsharded result: the test's controls show both.
* attention with the heads split (contiguous GQA groups), and the raise on
  a split head dimension or a cut GQA group;
* the embedding with the vocab split (uneven blocks too): each rank's
  rows of its own range, zeros elsewhere, bit for bit the whole gather.

* the sharded-serving plans: cache attention with query heads split
  (whole GQA groups, part of one, and a cut group whose KV heads are
  repeated), paged attention with the pages split over 'data', both
  against the unsharded op and the reference's; the placements of the
  cache plan for slots over 'data' with heads over 'model' and for a split
  sequence, of the paged and fused plans; the paged and contiguous
  inserts on fake ranks' blocks joined equal to one whole insert, and the
  owner rank's local indices of a slot write.

Also ``constrain``'s choice of spec (``nn/pjit_hints.py``) on the
reference's own example, batch 32 on (2, 16, 16), and its other cases.
"""
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.core import dispatch, mesh_route, pfp_layers
from repro_torch.core.gaussian import SRM, VAR, GaussianTensor
from repro_torch.launch.mesh import MeshSpec
from repro_torch.nn import pjit_hints

DENSE_TOL = dict(rtol=1e-5, atol=1e-4)
ATTENTION_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import dispatch as jdispatch
    from repro.core.gaussian import GaussianTensor as JGaussian
    return dict(jnp=jnp, dispatch=jdispatch, G=JGaussian)


def _pair(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    mu = (scale * rng.normal(size=shape)).astype(np.float32)
    var = (scale * np.log1p(np.exp(rng.normal(size=shape)))).astype(
        np.float32)
    return mu, var


def _close(got, want, tol):
    for g, w in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


def _block(t, placement, rank, n):
    """Rank ``rank``'s block of ``t`` under one mesh axis of ``n``."""
    if placement.is_shard():
        return torch.chunk(t, n, dim=placement.dim)[rank]
    return t


def _block_g(x, placement, rank, n):
    if isinstance(x, GaussianTensor):
        return GaussianTensor(_block(x.mean, placement, rank, n),
                              _block(x.second, placement, rank, n), x.rep)
    return _block(x, placement, rank, n)


def _combine(parts, placement):
    """The whole output from the ranks' outputs (rank order)."""
    if placement.is_shard():
        return torch.cat(parts, dim=placement.dim)
    if placement.is_partial():
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total
    return parts[0]


def _combine_g(parts, placement):
    if placement.is_partial():
        assert all(p.rep == VAR for p in parts), "partial sums must be VAR"
    return GaussianTensor(_combine([p.mean for p in parts], placement),
                          _combine([p.second for p in parts], placement),
                          parts[0].rep)


DENSE_FORMS = {"eq12": "srm", "eq13": "srm", "eq7": "var"}


def _dense_inputs(form, b=3, t=5, k=24, n=20):
    mx, vx = _pair((b, t, k), 1)
    mw, vw = _pair((k, n), 2, 0.1)
    mb, vb = _pair((n,), 3, 0.1)
    if form == "eq13":
        x = torch.from_numpy(mx)
    elif form == "eq7":
        x = GaussianTensor(torch.from_numpy(mx), torch.from_numpy(vx), VAR)
    else:
        x = GaussianTensor(torch.from_numpy(mx),
                           torch.from_numpy(vx + mx ** 2), SRM)
    w = GaussianTensor(torch.from_numpy(mw), torch.from_numpy(vw + mw ** 2),
                       SRM)
    bias = GaussianTensor(torch.from_numpy(mb), torch.from_numpy(vb), VAR)
    return x, w, bias, (mx, vx, mw, vw, mb, vb)


def _jdense(jax_ref, form, arrays):
    jnp, JG, jd = jax_ref["jnp"], jax_ref["G"], jax_ref["dispatch"]
    mx, vx, mw, vw, mb, vb = (jnp.asarray(a) for a in arrays)
    x = (mx if form == "eq13" else JG(mx, vx, VAR))
    w = JG(mw, vw + mw ** 2, SRM)
    return jd.pfp_dense(x, w, JG(mb, vb, VAR),
                        formulation=DENSE_FORMS[form], impl="xla")


def _emulated_dense(x, w, bias, formulation, split, n):
    """The route's dense for ``n`` ranks: plan, local kernels, combine, the
    bias added once."""
    xm = x.mean if isinstance(x, GaussianTensor) else x
    xs, ws, out = mesh_route.dense_plan([Replicate()], [split], xm.ndim)
    x = dispatch._to_compute_rep(x, formulation)
    parts = [dispatch._dense_kernel(_block_g(x, xs[0], r, n),
                                    _block_g(w, ws[0], r, n), formulation)
             for r in range(n)]
    return dispatch._add_bias(_combine_g(parts, out[0]), bias), parts, out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("split", ["column", "row"])
@pytest.mark.parametrize("form", ["eq12", "eq13", "eq7"])
def test_dense_route_matches_the_unsharded_op(jax_ref, form, split, n):
    x, w, bias, arrays = _dense_inputs(form)
    formulation = DENSE_FORMS[form]
    placement = Shard(1) if split == "column" else Shard(0)
    got, parts, out = _emulated_dense(x, w, bias, formulation, placement, n)
    assert out[0] == (Shard(2) if split == "column" else Partial())
    whole = dispatch.pfp_dense(x, w, bias, formulation=formulation,
                               impl="kernel")
    want = _jdense(jax_ref, form, arrays)
    assert got.rep == whole.rep == VAR
    _close((got.mean, got.var), (whole.mean, whole.var), DENSE_TOL)
    _close((got.mean, got.var), (want.mean, want.var), DENSE_TOL)
    if split == "row":
        # Controls: second moments do not add across ranks ((sum m)^2 !=
        # sum m^2), and a bias added on every rank counts n times.
        srm_sum = sum(p.srm for p in parts[1:]) + parts[0].srm
        wrong_var = srm_sum - torch.square(got.mean - bias.mean)
        assert not np.allclose(wrong_var + bias.var, whole.var, **DENSE_TOL)
        per_rank = [dispatch._add_bias(p, bias) for p in parts]
        wrong = _combine_g(per_rank, Partial())
        assert not np.allclose(wrong.mean, whole.mean, **DENSE_TOL)


def test_dense_plan_gathers_an_fsdp_weight_beside_a_batch_split():
    xs, ws, out = mesh_route.dense_plan([Shard(0), Replicate()],
                                        [Shard(0), Shard(1)], 3)
    assert xs == [Shard(0), Replicate()]
    assert ws == [Replicate(), Shard(1)]
    assert out == [Shard(0), Shard(2)]


def _attention_inputs(b=2, h=8, hkv=4, tq=6, tk=9, d=16):
    q, _ = _pair((b, h, tq, d), 4)
    k, _ = _pair((b, hkv, tk, d), 5)
    v, vv = _pair((b, hkv, tk, d), 6)
    return [torch.from_numpy(a) for a in (q, k, v, vv)]


@pytest.mark.parametrize("n", [2, 4])
def test_attention_route_with_heads_split(jax_ref, n):
    q, k, v, vv = _attention_inputs()
    scale = 16 ** -0.5
    ps = mesh_route.attention_plan([Shard(1)], [n], q.shape[1], k.shape[1])
    assert ps == [Shard(1)]
    parts = [dispatch._attention_kernel(
        *(_block(t, ps[0], r, n) for t in (q, k, v, vv)), scale, True)
        for r in range(n)]
    got = [_combine([p[i] for p in parts], ps[0]) for i in (0, 1)]
    whole = dispatch.pfp_attention(q, k, v, vv, scale=scale, causal=True,
                                   impl="kernel")
    jnp = jax_ref["jnp"]
    want = jax_ref["dispatch"].pfp_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, vv)), scale=scale,
        causal=True, impl="xla")
    _close(got, whole, ATTENTION_TOL)
    _close(got, want, ATTENTION_TOL)


def test_attention_route_never_runs_on_part_of_a_head():
    with pytest.raises(ValueError, match="part of a head"):
        mesh_route.attention_plan([Shard(3)], [2], 8, 4)
    with pytest.raises(ValueError, match="GQA group"):
        mesh_route.attention_plan([Shard(1)], [4], 8, 2)
    # Split query rows and partial inputs are gathered, a batch split kept.
    assert mesh_route.attention_plan(
        [Shard(2), Partial(), Shard(0)], [2, 2, 2], 8, 4) == [
            Replicate(), Replicate(), Shard(0)]


@pytest.mark.parametrize("vocab,n", [(96, 2), (98, 4)])
def test_embedding_route_with_the_vocab_split(jax_ref, vocab, n):
    mu, var = _pair((vocab, 12), 7)
    table = GaussianTensor(torch.from_numpy(mu),
                           torch.from_numpy(var + mu ** 2), SRM)
    ids = torch.from_numpy(
        np.random.default_rng(8).integers(0, vocab, size=(3, 11)))
    ts, ips, out = mesh_route.embedding_plan([Shard(0)], [Shard(0)], 2)
    assert (ts, ips, out) == ([Shard(0)], [Replicate()], [Partial()])
    lo, parts = 0, []
    for r in range(n):
        local = _block_g(table, ts[0], r, n)
        parts.append(mesh_route.masked_embedding(
            pfp_layers.pfp_embedding, local, ids, lo))
        lo += local.mean.shape[0]
    got = _combine_g(parts, out[0])
    whole = dispatch.pfp_embedding(table, ids, impl="kernel")
    assert torch.equal(got.mean, whole.mean)
    assert torch.equal(got.var, whole.var)
    jnp, JG = jax_ref["jnp"], jax_ref["G"]
    want = jax_ref["dispatch"].pfp_embedding(
        JG(jnp.asarray(mu), jnp.asarray(var + mu ** 2), SRM),
        jnp.asarray(ids.numpy()))
    _close((got.mean, got.var), (want.mean, want.var), DENSE_TOL)


def test_row_and_elementwise_plans():
    assert mesh_route.rows_plan([Shard(2), Shard(0), Partial()], 3) == [
        Replicate(), Shard(0), Replicate()]
    assert mesh_route.rows_plan([Shard(1)], 3) == [Shard(1)]


def test_next_slice_ops_raise_on_a_dtensor_route(monkeypatch):
    assert set(mesh_route.NEXT_SLICE).isdisjoint(mesh_route.ROUTES)
    assert set(mesh_route.NEXT_SLICE) == {"dense_batched", "einsum",
                                          "conv2d_im2col", "maxpool2d"}
    for op in ("dense", "rmsnorm", "layernorm", "activation", "glu_product",
               "residual", "attention", "embedding", "attention_cache",
               "attention_paged", "norm_dense_act"):
        assert op in mesh_route.ROUTES
    # Each remaining op raises on a DTensor, naming its ROADMAP.md item.
    monkeypatch.setattr(mesh_route, "has_dtensor", lambda args: True)
    for op in mesh_route.NEXT_SLICE:
        assert op in dispatch._REGISTRY
        with pytest.raises(NotImplementedError,
                           match=mesh_route.ROADMAP_ITEM[op]):
            mesh_route.wrap(op, lambda *a: None)(torch.zeros(1))


# -- the sharded-serving plans (cache, paged, fused) and the inserts --------
def test_cache_plan_keeps_slots_and_heads_split():
    # Slots over 'data' (either side) split both; KV heads over 'model'
    # take the query heads with them.
    qs, ks = mesh_route.cache_plan([Shard(0), Replicate()],
                                   [Shard(0), Shard(1)], [2, 4], 8, 4)
    assert qs == [Shard(0), Shard(1)] and ks == [Shard(0), Shard(1)]
    qs, ks = mesh_route.cache_plan([Replicate(), Shard(1)],
                                   [Shard(0), Shard(1)], [2, 2], 8, 4)
    assert qs == [Shard(0), Shard(1)] and ks == [Shard(0), Shard(1)]


def test_cache_plan_gathers_a_split_sequence():
    # Reduced granite on (2, 4): 2 KV heads cannot fill 4 ranks, so the
    # state rule split the sequence; the kernel gets whole keys, the query
    # heads keep their split and read the KV heads they need.
    qs, ks = mesh_route.cache_plan([Shard(0), Shard(1)],
                                   [Shard(0), Shard(2)], [2, 4], 4, 2)
    assert qs == [Shard(0), Shard(1)] and ks == [Shard(0), Replicate()]
    # Query rows split, or heads that do not divide, are gathered.
    qs, ks = mesh_route.cache_plan([Shard(2)], [Shard(2)], [4], 6, 2)
    assert qs == [Replicate()] and ks == [Replicate()]
    with pytest.raises(ValueError, match="part of a head"):
        mesh_route.cache_plan([Shard(3)], [Replicate()], [2], 4, 2)


def test_paged_plan_gathers_the_pages_for_the_rank_heads():
    # Pages over 'data' gathered (a slot's pages may live on any rank),
    # the query slots keep their split, heads over 'model' with the KV
    # heads where these divide.
    qs, ps = mesh_route.paged_plan([Shard(0), Shard(1)],
                                   [Shard(0), Shard(1)], [4, 2], 4, 2)
    assert qs == [Shard(0), Shard(1)] and ps == [Replicate(), Shard(1)]
    qs, ps = mesh_route.paged_plan([Shard(0), Replicate()],
                                   [Shard(0), Shard(2)], [2, 4], 4, 2)
    assert qs == [Shard(0), Replicate()] and ps == [Replicate(), Replicate()]


def test_fused_plan_splits_n_and_gathers_k():
    xs, ws, out = mesh_route.fused_plan([Replicate(), Replicate()],
                                        [Replicate(), Shard(1)], 3)
    assert xs == [Replicate(), Replicate()]
    assert ws == [Replicate(), Shard(1)] and out == [Replicate(), Shard(2)]
    xs, ws, out = mesh_route.fused_plan([Shard(0), Replicate()],
                                        [Shard(0), Shard(0)], 3)
    assert xs == [Shard(0), Replicate()]
    assert ws == [Replicate(), Replicate()] and out == [Shard(0),
                                                        Replicate()]


def _cache_inputs(b=2, h=4, hkv=2, tq=3, s=10, d=16):
    q, _ = _pair((b, h, tq, d), 7)
    k, _ = _pair((b, hkv, s, d), 8)
    v, vv = _pair((b, hkv, s, d), 9)
    q_start = torch.tensor([4, 7])[:b]
    kv_len = q_start + tq
    return [torch.from_numpy(a) for a in (q, k, v, vv)] + [q_start, kv_len]


@pytest.mark.parametrize("h,hkv,n", [(4, 2, 2), (4, 2, 4), (6, 3, 2),
                                     (8, 1, 4)])
def test_cache_route_emulated_per_rank_heads(jax_ref, h, hkv, n):
    """Query heads split n ways, KV heads split where they divide n and
    otherwise whole: each emulated rank reads the KV heads its query heads
    read (kv_heads_for: whole groups, part of one, or a cut group (6 / 3
    over 2: heads 0-2 read KV heads 0, 0, 1) repeated per query head),
    and the joined outputs equal the unsharded op and the reference's."""
    q, k, v, vv, q_start, kv_len = _cache_inputs(h=h, hkv=hkv)
    scale = 16 ** -0.5
    qs, ks = mesh_route.cache_plan([Shard(1)], [Replicate()], [n], h, hkv)
    assert qs == [Shard(1)]
    assert ks == [Shard(1) if hkv % n == 0 else Replicate()]
    op = dispatch.get_op("attention_cache", "kernel")
    parts = []
    for r in range(n):
        hq = h // n
        kv = [_block(t, ks[0], r, n) for t in (k, v, vv)]
        k0 = r * (hkv // n) if ks[0].is_shard() else 0
        kv = [mesh_route.kv_heads_for(t, r * hq, hq, h // hkv, k0)[0]
              for t in kv]
        parts.append(op(_block(q, qs[0], r, n), *kv, q_start, kv_len, scale,
                        True, None))
    got = [_combine([p[i] for p in parts], qs[0]) for i in (0, 1)]
    whole = dispatch.pfp_attention_cache(q, k, v, vv, q_start, kv_len,
                                         scale=scale, impl="kernel")
    jnp = jax_ref["jnp"]
    want = jax_ref["dispatch"].pfp_attention_cache(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, vv)),
        jnp.asarray(q_start.numpy(), jnp.int32),
        jnp.asarray(kv_len.numpy(), jnp.int32), scale=scale, impl="xla")
    _close(got, whole, ATTENTION_TOL)
    _close(got, want, ATTENTION_TOL)


def test_kv_heads_for_slices_whole_groups_and_repeats_cut_ones():
    kv = torch.arange(3.0).reshape(1, 3, 1, 1)        # KV heads 0, 1, 2
    got, g = mesh_route.kv_heads_for(kv, 2, 2, 2, 0)   # heads 2-3: KV 1
    assert got.flatten().tolist() == [1.0] and g == 2
    got, g = mesh_route.kv_heads_for(kv, 2, 4, 2, 0)   # heads 2-5: KV 1, 2
    assert got.flatten().tolist() == [1.0, 2.0] and g == 2
    got, g = mesh_route.kv_heads_for(kv, 3, 2, 2, 0)   # heads 3-4: KV 1, 2
    assert got.flatten().tolist() == [1.0, 2.0] and g == 1
    got, g = mesh_route.kv_heads_for(kv[:, 1:], 3, 1, 2, 1)   # a block
    assert got.flatten().tolist() == [1.0] and g == 1
    assert mesh_route.kv_heads_for(kv, 0, 6, 2, 0)[0] is kv


@pytest.mark.parametrize("n", [2, 4])
def test_paged_route_emulated_with_pages_split_over_data(jax_ref, n):
    """Pools split over n 'data' ranks are gathered by the plan; the query
    slots stay split, each rank reading its slots' table rows; joined,
    the outputs equal the unsharded op and the reference's."""
    b, h, hkv, tq, d, npg, ps_ = 4, 4, 2, 2, 16, 8, 4
    q, _ = _pair((b, h, tq, d), 10)
    pages = [torch.from_numpy(_pair((npg, hkv, ps_, d), 11 + i)[0])
             for i in range(3)]
    table = torch.tensor([[1, 5], [2, 0], [7, 3], [4, 6]])
    q_start = torch.tensor([1, 0, 5, 3])
    kv_len = q_start + tq
    q = torch.from_numpy(q)
    scale = 16 ** -0.5
    qs, pls = mesh_route.paged_plan([Shard(0)], [Shard(0)], [n], h, hkv)
    assert qs == [Shard(0)] and pls == [Replicate()]
    op = dispatch.get_op("attention_paged", "kernel")
    parts = [op(_block(q, qs[0], r, n), *pages, _block(table, qs[0], r, n),
                _block(q_start, qs[0], r, n), _block(kv_len, qs[0], r, n),
                scale, True, None) for r in range(n)]
    got = [_combine([p[i] for p in parts], qs[0]) for i in (0, 1)]
    whole = dispatch.pfp_attention_paged(q, *pages, table, q_start, kv_len,
                                         scale=scale, impl="kernel")
    jnp = jax_ref["jnp"]
    want = jax_ref["dispatch"].pfp_attention_paged(
        jnp.asarray(q.numpy()), *(jnp.asarray(t.numpy()) for t in pages),
        *(jnp.asarray(t.numpy(), jnp.int32)
          for t in (table, q_start, kv_len)), scale=scale, impl="xla")
    _close(got, whole, ATTENTION_TOL)
    _close(got, want, ATTENTION_TOL)


def test_owner_rank_writes_land_at_local_indices():
    """Slot writes (reset, write, copy-on-write) run on the rank holding
    the row, at its local index: ``owned`` over a fake rank's block."""
    idx = torch.tensor([0, 5, 3, 7])
    sel, at = mesh_route.owned(idx, 4, 4)          # rank 1 of 2, rows 4-7
    assert sel.tolist() == [1, 3] and at.tolist() == [1, 3]
    sel, at = mesh_route.owned(idx, 0, 4)          # rank 0: rows 0-3
    assert sel.tolist() == [0, 2] and at.tolist() == [0, 3]
    sel, _ = mesh_route.owned(torch.tensor([9]), 4, 4)
    assert sel.tolist() == []


@pytest.mark.parametrize("pages_n,rows_n", [(2, 1), (4, 2), (1, 2)])
def test_paged_insert_on_fake_ranks_equals_the_whole_insert(pages_n, rows_n):
    """The pool split over ``pages_n`` ranks (pages) and ``rows_n`` (rows
    of a page): each fake rank writes its pages' rows at their local
    indices; joined, the blocks equal one insert into the whole pool, and
    no row lands in a local page that only shares a global page's index
    (rank 1's local page 0 is global page 2, 4, ...)."""
    from repro_torch.nn.attention import _insert_pages
    npg, hkv, ps_, d = 8, 2, 4, 3
    buf = torch.from_numpy(_pair((npg, hkv, ps_, d), 20)[0])
    new = torch.from_numpy(_pair((2, hkv, 3, d), 21)[0])
    dest_page = torch.tensor([[1, 1, 6], [0, 3, 3]])
    dest_row = torch.tensor([[2, 3, 0], [1, 1, 2]])
    want = _insert_pages(buf, new, dest_page, dest_row)
    blocks = []
    for pr in range(pages_n):
        pages = torch.chunk(buf, pages_n, dim=0)[pr]
        row_blocks = []
        for rr in range(rows_n):
            local = torch.chunk(pages, rows_n, dim=2)[rr]
            row_blocks.append(mesh_route.insert_pages_block(
                local, new, dest_page, dest_row, pr * (npg // pages_n),
                rr * (ps_ // rows_n)))
        blocks.append(torch.cat(row_blocks, dim=2))
    assert torch.equal(torch.cat(blocks, dim=0), want)


@pytest.mark.parametrize("n", [2, 4])
def test_contiguous_insert_on_a_sequence_block_equals_the_whole(n):
    """A cache with its sequence split n ways: each block writes the new
    rows that fall in it (clamped as on one device); joined, the whole
    insert."""
    from repro_torch.nn.attention import _insert_rows
    b, hkv, s, d, tq = 2, 2, 8, 3, 3
    buf = torch.from_numpy(_pair((b, hkv, s, d), 22)[0])
    new = torch.from_numpy(_pair((b, hkv, tq, d), 23)[0])
    positions = torch.tensor([[2, 3, 4], [7, 8, 9]])   # the second clamps
    want = _insert_rows(buf, new, positions)
    got = torch.cat([mesh_route.insert_rows_block(
        torch.chunk(buf, n, dim=2)[r], new, positions, r * (s // n), s)
        for r in range(n)], dim=2)
    assert torch.equal(got, want)
    assert mesh_route.insert_plan([Shard(0), Shard(2)], paged=False) == (
        [Shard(0), Replicate()], [Shard(0), Replicate()])
    assert mesh_route.insert_plan([Shard(0), Shard(1)], paged=True) == (
        [Replicate(), Shard(1)], [Replicate(), Replicate()])


RULES_2x16x16 = {"mesh": MeshSpec((2, 16, 16), ("pod", "data", "model")),
                 "batch": ("pod", "data", "model"), "seq": "model",
                 "embed": None, "vocab": "model",
                 "state_batch": ("pod", "data")}


def test_constrain_spec_on_the_references_example():
    """The reference's comment: batch 32 on 2x16x16 shards over
    ('pod', 'data') but not ('pod', 'data', 'model'); the sequence then
    takes 'model'."""
    spec = pjit_hints.constrain_spec((32, 32768, 4096),
                                     ("batch", "seq", "embed"), RULES_2x16x16)
    assert spec == (("pod", "data"), "model", None)
    # A batch that fills the product takes every axis; 'model' is then
    # used, so the sequence stays whole.
    assert pjit_hints.constrain_spec(
        (512, 4096, 64), ("batch", "seq", "embed"), RULES_2x16x16) == (
            ("pod", "data", "model"), None, None)
    # Down to a one-axis prefix, or nothing.
    assert pjit_hints.constrain_spec((2, 3), ("batch", "seq"),
                                     RULES_2x16x16) == (("pod",), None)
    assert pjit_hints.constrain_spec((3,), ("batch",), RULES_2x16x16) == \
        (None,)
    # A name the rules do not bind stays unsharded.
    assert pjit_hints.constrain_spec((32, 8), ("batch", "ffn"),
                                     RULES_2x16x16)[1] is None


def test_kv_spec_follows_the_state_rule():
    rules = dict(RULES_2x16x16)
    assert pjit_hints.kv_spec((128, 8, 32768, 128), rules) == (
        ("pod", "data"), None, "model", None)
    assert pjit_hints.kv_spec((16, 16, 4, 128), rules) == (
        "data", "model", None, None)


def test_constrain_returns_its_input_off_a_mesh():
    x = torch.ones(4, 3)
    g = GaussianTensor(x, x, VAR)
    assert pjit_hints.constrain(x, "batch", "embed") is x
    prev = pjit_hints.get_rules()
    pjit_hints.set_rules(RULES_2x16x16)
    try:
        assert pjit_hints.constrain(x, "batch", "embed") is x
        assert pjit_hints.constrain(g, "batch", "embed") is g
        assert pjit_hints.constrain_kv(torch.ones(2, 2, 2, 2)).shape == \
            (2, 2, 2, 2)
    finally:
        pjit_hints.set_rules(prev)
