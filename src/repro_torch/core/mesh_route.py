"""The ``kernel`` impl's route for DTensor inputs.

The hand-written kernels are bound through ``ctypes`` and take plain
tensors. When a registry op gets a DTensor, this route

  1. redistributes each input to the placements its local kernel needs
     (a plan per op, below: pure functions of the placements and shapes);
  2. runs the op's kernel impl on the ``to_local()`` shards;
  3. wraps the local outputs as DTensors with the plan's placements.

The ops of the dense family's PFP forward and decode step take it:
``embedding``, ``rmsnorm``, ``layernorm``, ``dense``, ``glu_product``,
``activation``, ``attention``, ``attention_cache``, ``attention_paged``,
``norm_dense_act`` and ``residual``. The others raise on a DTensor,
naming the ROADMAP.md item that brings their route (the batched experts,
``einsum`` and the CNN ops); no op carries on on another path. The
``eager`` impl needs no route: it is plain torch, and DTensor's own
propagation carries it, but for the KV caches, which it reads and writes
per rank through the same plans (``per_rank_cache``, ``insert_rows``,
``insert_pages``).

Plans, per mesh axis:

* dense ``x (..., K) @ w (K, N)``: an ``x`` sharded over a batch
  dimension keeps it and the weight is gathered on that axis (FSDP); else
  a weight split over K takes ``x`` split over K, and each rank holds a
  partial Eq. 12 output in the VAR representation. Mean and variance are
  both sums over K, so both are all-reduced here, before anything can
  turn the variance into a second moment ((sum m)^2 != sum m^2); the bias
  is added once, after the reduction, by the caller. A weight split over
  N takes a replicated ``x`` and gives an output split over N.
* the norms need whole rows; the elementwise ops follow their first
  input; a partial sum is reduced first.
* attention runs on whole heads: heads split only where the query and KV
  heads both divide the axis (contiguous GQA groups: query head h reads KV
  head h // G on the same rank); a split head dimension, or a head split
  that would cut a GQA group, raises. Split query rows are gathered (the
  kernel masks causally by index).
* the embedding with the vocab split gathers each rank's rows of its own
  vocab range, zeros elsewhere, and sums the exact partials.
* cache attention (``cache_plan``): query slots split over ``data`` stay
  split and the cache's slots take the same split; KV heads split over
  ``model`` go with their query heads. A cache whose sequence is split
  is gathered along it first, so the kernel sees whole keys (a row's bits
  depend on its own query and keys only). Where a rank's query heads do
  not read a whole block of KV heads, it keeps the KV heads they read,
  repeated per query head where a GQA group is cut (``kv_heads_for``).
* paged attention (``paged_plan``): the pools' page and row dimensions
  are gathered (a slot's pages may live on another ``data`` rank); the
  heads follow the queries as above; the page table is replicated.
* the fused unit (``fused_plan``): whole rows; a weight split over N
  gives an output split over N; a weight split over K is gathered.
* the cache inserts write each new row on the rank that holds its
  position (contiguous) or its page (paged), at the local index there;
  every other rank writes nothing.

The model code calls a few more helpers where DTensor's own propagation
would gather everything or refuse: ``place_dense`` (every dense, any
impl and mode, placed by the dense plan), ``whole_heads`` / ``heads_split``
/ ``cuts_kv_groups`` (whole heads before a head reshape, KV heads
repeated where the KV heads do not divide the split), ``per_rank_core``
(the chunked attention core run on each rank's rows and heads),
``follow`` (a residual add keeps the stream's split), ``whole`` (partial
scalars reduced before they mix), ``microbatch`` (a batch split per rank)
and ``gather_rows`` (a plain embedding gather by the embedding plan).
Each returns its input unchanged where no DTensor is involved.

Partial sums (a row-parallel dense's outputs, the vocab-split embedding's
rows) are reduced by :func:`reduce_partial`: an ``all_reduce`` (DTensor's
own redistribution, differentiable), or under :func:`ordered_sums` (the
serving engine's passes) the ranks' partials gathered and added in rank
order. An ``all_reduce`` adds an element's partials in an order that
depends on the element's offset in the buffer (a ring's chunks), so a
request's bits would depend on its slot; added in rank order they depend
on the row alone, and a fleet's replicas serve the single engine's bits
on any mesh, as on one device. The gather brings every rank the n - 1
other partials, where a ring all_reduce moves 2 (n - 1) / n of one: n / 2
times the all_reduce's bytes on an axis of n ranks.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Callable, Sequence

import torch

from repro_torch.core.gaussian import VAR, GaussianTensor, is_gaussian

# Ops with one function for both impls: both take the route.
SHARED = ("embedding", "residual")
# Ops with no route yet, and the ROADMAP.md item that brings it.
NEXT_SLICE = ("dense_batched", "einsum", "conv2d_im2col", "maxpool2d")
ROADMAP_ITEM = {"dense_batched": "expert parallelism",
                "einsum": "the einsum route and the SSD per rank",
                "conv2d_im2col": "the CNN ops' route",
                "maxpool2d": "the CNN ops' route"}


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def _tensors(args):
    for a in args:
        if is_gaussian(a):
            yield a.mean
            yield a.second
        elif isinstance(a, torch.Tensor):
            yield a


def has_dtensor(args) -> bool:
    # No DTensor exists before torch.distributed.tensor is imported, so
    # the unsharded path pays one dict lookup.
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:
        return False
    dt = mod.DTensor
    for a in args:
        if isinstance(a, GaussianTensor):
            if isinstance(a.mean, dt) or isinstance(a.second, dt):
                return True
        elif isinstance(a, dt):
            return True
    return False


def wrap(name: str, fn: Callable) -> Callable:
    """``fn`` (a kernel impl) routed through the DTensor plans when any
    argument is a DTensor; plain arguments go straight to ``fn``."""

    def routed(*args):
        if not has_dtensor(args):
            return fn(*args)
        if name not in ROUTES:
            raise NotImplementedError(
                f"the kernel impl of {name!r} takes no DTensor yet: it comes "
                f"with {ROADMAP_ITEM.get(name, 'a later slice')} "
                "(ROADMAP.md)")
        return ROUTES[name](fn, *args)

    routed.__wrapped__ = fn
    return routed


def whole_heads(t, num_heads: int, dim: int = -1):
    """``t`` ready to have dimension ``dim`` unflattened into ``num_heads``
    leading blocks (heads, or KV groups): a DTensor with ``dim`` split over
    a mesh axis that does not divide ``num_heads`` (it would cut a head,
    e.g. 8 KV heads over 16 ranks) is gathered on that axis first.
    Anything else comes back as it is."""
    if not has_dtensor((t,)):
        return t
    dim = dim % t.ndim
    ps = list(t.placements)
    want = [_R() if (_shard_dim(p) == dim
                     and num_heads % t.device_mesh.size(i)) else p
            for i, p in enumerate(ps)]
    return t if want == ps else _redistribute(t, want)


def heads_split(t, num_heads: int):
    """``t`` (B, H, T, D), a DTensor, with a partial sum or a split of its
    rows or head dimension moved onto its heads (reduced or regathered),
    where the mesh axis divides H, and onto nothing where it does not; a
    head split that does not divide H is gathered. Plain tensors come back
    as they are."""
    if not has_dtensor((t,)):
        return t
    ps = list(t.placements)
    heads_taken = any(_shard_dim(p) == 1 for p in ps)
    want = []
    for p, n in zip(ps, t.device_mesh.shape):
        d = _shard_dim(p)
        if p.is_partial() or d in (2, 3):
            if not heads_taken and not num_heads % n:
                want.append(_S(1))
                heads_taken = True
            else:
                want.append(_R())
        elif d == 1 and num_heads % n:
            want.append(_R())
        else:
            want.append(p)
    return t if want == ps else _redistribute(t, want)


def like(t, ref, dims: Sequence[int]):
    """``t`` split as ``ref`` is on ``dims`` and whole elsewhere (a plain
    ``t`` sliced locally): the chunked attention core's keys follow its
    queries' batch and head split."""
    if t is None or not has_dtensor((ref,)):
        return t
    return _placed(t, ref.device_mesh, [p if _shard_dim(p) in dims else _R()
                                        for p in ref.placements])


def per_rank_core(core, q_mu, q_var, k_mu, v_mu, v_var, *, q_pos, k_pos,
                  k_valid, **kw):
    """The chunked attention core (q (B, Hkv, G, Tq, D), k / v (B, Hkv,
    Tk, D), positions (B, T)) on DTensors: the queries keep only their
    batch and KV-head splits, the keys, values and positions take the
    same, and each rank runs ``core`` on its own rows and heads (attention
    is independent across both); the outputs come back split as the
    queries."""
    q_mu = split_only(q_mu, (0, 1))
    q_var = like(q_var, q_mu, (0, 1))
    k_mu, v_mu, v_var = (like(t, q_mu, (0, 1)) for t in (k_mu, v_mu, v_var))
    q_pos, k_pos, k_valid = (like(t, q_mu, (0,))
                             for t in (q_pos, k_pos, k_valid))

    def local(t):
        return None if t is None else (
            t.to_local() if has_dtensor((t,)) else t)

    out_mu, out_var = core(*(local(t) for t in (q_mu, q_var, k_mu, v_mu,
                                                v_var)),
                           q_pos=local(q_pos), k_pos=local(k_pos),
                           k_valid=local(k_valid), **kw)
    mesh, ps = q_mu.device_mesh, list(q_mu.placements)
    shape = tuple(q_mu.shape[:4]) + (v_mu.shape[-1],)
    return (_wrap(out_mu, mesh, ps, shape),
            None if out_var is None else _wrap(out_var, mesh, ps, shape))


def cuts_kv_groups(q, num_heads: int, num_kv_heads: int) -> bool:
    """Whether the queries (B, H, T, D), a DTensor, have their heads split
    over a mesh axis that divides H but not the KV heads: grouping them by
    KV head there would gather every head onto every rank."""
    if not has_dtensor((q,)):
        return False
    return any(_shard_dim(p) == 1 and not num_heads % n and num_kv_heads % n
               for p, n in zip(q.placements, q.device_mesh.shape))


def split_only(t, dims: Sequence[int]):
    """``t`` with every mesh axis that splits a dimension outside ``dims``
    gathered (a partial sum reduced): the chunked attention core's
    contractions then see batch and head splits only, which DTensor's
    batched-matmul strategy takes. A plain tensor or None comes back as it
    is."""
    if t is None or not has_dtensor((t,)):
        return t
    ps = list(t.placements)
    want = [p if (_shard_dim(p) in dims) else _R() for p in ps]
    return t if want == ps else _redistribute(t, want)


# -- placement helpers ---------------------------------------------------------
def _R():
    from torch.distributed.tensor import Replicate

    return Replicate()


def _S(d):
    from torch.distributed.tensor import Shard

    return Shard(d)


def _P():
    from torch.distributed.tensor import Partial

    return Partial()


def _shard_dim(p):
    return p.dim if p.is_shard() else None


def _mesh(args):
    dt = _dtensor_type()
    for t in _tensors(args):
        if isinstance(t, dt):
            return t.device_mesh
    raise ValueError("no DTensor among the arguments")


def placements_of(t, mesh) -> list:
    """``t``'s placements; a plain tensor counts as replicated."""
    if isinstance(t, _dtensor_type()):
        return list(t.placements)
    return [_R() for _ in range(mesh.ndim)]


def _local(t, mesh, want):
    """The local shard of ``t`` under placements ``want``. A plain tensor
    (equal on every rank) is sliced locally, with no collective."""
    if not has_dtensor((t,)) and all(p.is_replicate() for p in want):
        return t
    return _placed(t, mesh, want).to_local()


def _local_g(x, mesh, want):
    if is_gaussian(x):
        return GaussianTensor(_local(x.mean, mesh, want),
                              _local(x.second, mesh, want), x.rep)
    return _local(x, mesh, want)


def _wrap(local, mesh, out, shape):
    """A DTensor of global ``shape`` from this rank's ``local`` block; any
    partial sum is reduced to a replica at once."""
    dt = _dtensor_type()
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    t = dt.from_local(local, mesh, out, run_check=False, shape=shape,
                      stride=stride)
    if any(p.is_partial() for p in out):
        t = reduce_partial(t)
    return t


def _wrap_g(g, mesh, out, shape):
    return GaussianTensor(_wrap(g.mean, mesh, out, shape),
                          _wrap(g.second, mesh, out, shape), g.rep)


def _no_partial(ps):
    return [_R() if p.is_partial() else p for p in ps]


_ORDERED = False


@contextlib.contextmanager
def ordered_sums():
    """Within: :func:`reduce_partial` adds the ranks' partials in rank
    order (inference only: the gather is not differentiable)."""
    global _ORDERED
    prev, _ORDERED = _ORDERED, True
    try:
        yield
    finally:
        _ORDERED = prev


def reduce_partial(t):
    """``t`` (a DTensor) with every partial sum reduced to a replica, its
    other placements kept: an ``all_reduce``, or under
    :func:`ordered_sums` each mesh axis's partials gathered and added in
    rank order (see the module docstring)."""
    import torch.distributed as dist

    mesh, ps = t.device_mesh, list(t.placements)
    if not _ORDERED:
        return t.redistribute(mesh, _no_partial(ps))
    local = t.to_local()
    for i, p in enumerate(ps):
        if not p.is_partial():
            continue
        ps[i] = _R()
        if mesh.size(i) == 1:      # one rank's partial is the whole sum
            continue
        parts = [torch.empty_like(local) for _ in range(mesh.size(i))]
        dist.all_gather(parts, local.contiguous(), group=mesh.get_group(i))
        local = parts[0]
        for part in parts[1:]:
            local = local + part
    return _dtensor_type().from_local(local, mesh, ps, run_check=False,
                                      shape=t.shape, stride=t.stride())


def full(t):
    """``t`` whole on every rank as a plain tensor (a DTensor's
    ``full_tensor()``, its partial sums reduced by :func:`reduce_partial`);
    a mesh of one rank holds it whole already and moves nothing."""
    if not has_dtensor((t,)):
        return t
    if t.device_mesh.size() == 1:
        return t.to_local()
    return whole(t).full_tensor()


def _redistribute(t, want):
    """``t`` redistributed to ``want``, any partial sum reduced by
    :func:`reduce_partial` first."""
    if any(p.is_partial() for p in t.placements):
        t = reduce_partial(t)
    return t if list(t.placements) == list(want) else t.redistribute(
        t.device_mesh, want)


# -- plans (pure: placements and shapes in, placements out) ------------------
def dense_plan(px: Sequence, pw: Sequence, x_ndim: int):
    """(x's, w's and the output's placements) for ``x (..., K) @ w (K, N)``
    on each mesh axis; an output ``Partial`` is a sum over K."""
    last = x_ndim - 1
    xs, ws, outs = [], [], []
    for a, b in zip(px, pw):
        d = _shard_dim(a)
        if d is not None and d < last:
            xs.append(a), ws.append(_R()), outs.append(a)
        elif _shard_dim(b) == 0:
            xs.append(_S(last)), ws.append(b), outs.append(_P())
        elif _shard_dim(b) == 1:
            xs.append(_R()), ws.append(b), outs.append(_S(last))
        else:
            xs.append(_R()), ws.append(_R()), outs.append(_R())
    return xs, ws, outs


def place_dense(x, w):
    """``x (..., K)`` and ``w (K, N)`` (plain or Gaussian) placed by
    ``dense_plan`` where either is a DTensor, else as they are. DTensor's
    own matmul strategy, given an FSDP weight beside a batch split, may
    gather everything; placed first, every dense on a mesh (the eager
    impl's, SVI's, the kernel route's) runs as the plan says."""
    if not has_dtensor((x, w)):
        return x, w
    mesh = _mesh((x, w))
    xm = x.mean if is_gaussian(x) else x
    wm = w.mean if is_gaussian(w) else w
    xs, ws, _ = dense_plan(placements_of(xm, mesh), placements_of(wm, mesh),
                           xm.ndim)
    return _placed_g(x, mesh, xs), _placed_g(w, mesh, ws)


def _placed(t, mesh, want):
    """``t`` as a DTensor with placements ``want`` (a plain tensor, equal
    on every rank, sliced locally)."""
    if not has_dtensor((t,)):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, mesh, want, src_data_rank=None)
    return t if list(t.placements) == list(want) else _redistribute(t, want)


def _placed_g(x, mesh, want):
    if is_gaussian(x):
        return GaussianTensor(_placed(x.mean, mesh, want),
                              _placed(x.second, mesh, want), x.rep)
    return _placed(x, mesh, want)


def follow(t, ref):
    """``t`` placed as ``ref`` (a partial sum of ``ref``'s reduced) where
    both are DTensors, else as it is: the residual stream keeps its split
    through an add."""
    if not (has_dtensor((t,)) and has_dtensor((ref,))):
        return t
    want = _no_partial(ref.placements)
    return t if list(t.placements) == want else _redistribute(t, want)


def microbatch(t, i: int, n: int):
    """Part ``i`` of ``n`` of a batch tensor's leading axis. A DTensor
    split over its batch gives each rank part ``i`` of its own rows, so
    the part keeps the split (slicing the global axis would gather it);
    its rows are then not those of the unsharded run's part ``i``, but the
    ``n`` parts together are the batch."""
    if n == 1:
        return t
    if not has_dtensor((t,)):
        size = len(t) // n
        return t[i * size:(i + 1) * size]
    local = t.to_local()
    size = local.shape[0] // n
    return _wrap(local[i * size:(i + 1) * size], t.device_mesh,
                 list(t.placements), (t.shape[0] // n,) + tuple(t.shape[1:]))


def whole(t):
    """``t`` (plain, DTensor or Gaussian) with any partial sum reduced (a
    replica there), else as it is: scalars of several partial kinds (a
    mean's, a sum's) add only once reduced, and a dense's partial outputs
    are reduced in rank order before DTensor's own propagation would
    all-reduce them."""
    if not has_dtensor((t,)):
        return t
    if is_gaussian(t):
        return GaussianTensor(whole(t.mean), whole(t.second), t.rep)
    if not any(p.is_partial() for p in t.placements):
        return t
    return reduce_partial(t)


def rows_plan(px: Sequence, ndim: int) -> list:
    """A norm's placements: whole rows (the last dimension unsplit)."""
    return [_R() if (a.is_partial() or _shard_dim(a) == ndim - 1) else a
            for a in px]


def attention_plan(pq: Sequence, sizes: Sequence[int], heads: int,
                   kv_heads: int) -> list:
    """The placements of q, k, v and the output (B, H, T, D) on each mesh
    axis of ``sizes``. Raises where whole heads or whole GQA groups cannot
    be kept."""
    out = []
    for a, n in zip(pq, sizes):
        d = _shard_dim(a)
        if d == 3:
            raise ValueError("attention on part of a head: the head "
                             "dimension is split over a mesh axis")
        if d == 1:
            if heads % n or kv_heads % n:
                raise ValueError(
                    f"attention with {heads} query and {kv_heads} KV heads "
                    f"split {n} ways would cut a head or a GQA group")
            out.append(a)
        elif d == 0:
            out.append(a)
        else:
            out.append(_R())
    return out


def embedding_plan(pt: Sequence, pids: Sequence, ids_ndim: int):
    """(table's, ids' and the output's placements): a vocab split gives
    partial rows (zeros outside each rank's range); a feature split an
    output split over features."""
    ts, ids, outs = [], [], []
    for t, i in zip(pt, pids):
        d = _shard_dim(t)
        if d == 0:
            ts.append(t), ids.append(_R()), outs.append(_P())
        elif d == 1:
            ts.append(t), ids.append(_R()), outs.append(_S(ids_ndim))
        else:
            keep = i if _shard_dim(i) is not None else _R()
            ts.append(_R()), ids.append(keep), outs.append(keep)
    return ts, ids, outs


def masked_embedding(fn, table, ids, lo: int):
    """``fn(table, ids)`` for a block of vocab rows starting at ``lo``
    (a Gaussian or a plain table): rows of ids outside the block come out
    as exact zeros."""
    rows = (table.mean if is_gaussian(table) else table).shape[0]
    inside = (ids >= lo) & (ids < lo + rows)
    out = fn(table, torch.where(inside, ids - lo, 0))
    keep = inside[..., None]
    if is_gaussian(out):
        return GaussianTensor(torch.where(keep, out.mean, 0.0),
                              torch.where(keep, out.var, 0.0), VAR)
    return torch.where(keep, out, 0.0)


def gather_rows(table, ids):
    """``table[ids]`` (the SVI and deterministic embedding), through the
    embedding plan where either is a DTensor."""
    if not has_dtensor((table, ids)):
        return table[ids]
    return _embedding(lambda t, i: t[i], table, ids)


def _follow_rows(ps) -> list:
    """Placements of a per-row vector (B,) or (B, T) beside a tensor with
    placements ``ps``: split where its rows are, whole elsewhere."""
    return [_S(0) if _shard_dim(p) == 0 else _R() for p in ps]


def cache_plan(pq: Sequence, pk: Sequence, sizes: Sequence[int], heads: int,
               kv_heads: int):
    """(q's, the cache's placements) for q (B, H, Tq, D) against a cache
    (B, Hkv, S, D), per mesh axis of ``sizes``; the output is placed as q.
    Slots split on either side split both. Else query heads split where
    the axis divides H, and the KV heads with them where it divides Hkv
    (a rank then reads the KV heads its query heads read, ``kv_heads_for``);
    a cache with its heads split takes the queries' heads the same way.
    Everything else, a split sequence or query rows among it, is whole."""
    qs, ks = [], []
    for a, c, n in zip(pq, pk, sizes):
        if 3 in (_shard_dim(a), _shard_dim(c)):
            raise ValueError("cache attention on part of a head: the head "
                             "dimension is split over a mesh axis")
        if 0 in (_shard_dim(a), _shard_dim(c)):
            qs.append(_S(0)), ks.append(_S(0))
        elif (_shard_dim(a) == 1 or _shard_dim(c) == 1) and not heads % n:
            qs.append(_S(1)), ks.append(_R() if kv_heads % n else _S(1))
        else:
            qs.append(_R()), ks.append(_R())
    return qs, ks


def paged_plan(pq: Sequence, pp: Sequence, sizes: Sequence[int], heads: int,
               kv_heads: int):
    """(q's, the pools' placements) for q (B, H, Tq, D) against page pools
    (NP, Hkv, page_size, D) read through a replicated page table. A slot's
    pages may live on any rank, so the pools' page and row dimensions are
    gathered; heads split as in :func:`cache_plan`; query slots stay
    split."""
    qs, ps = [], []
    for a, c, n in zip(pq, pp, sizes):
        if 3 in (_shard_dim(a), _shard_dim(c)):
            raise ValueError("paged attention on part of a head: the head "
                             "dimension is split over a mesh axis")
        if _shard_dim(a) == 0:
            qs.append(a), ps.append(_R())
        elif (_shard_dim(a) == 1 or _shard_dim(c) == 1) and not heads % n:
            qs.append(_S(1)), ps.append(_R() if kv_heads % n else _S(1))
        else:
            qs.append(_R()), ps.append(_R())
    return qs, ps


def fused_plan(px: Sequence, pw: Sequence, x_ndim: int):
    """(x's, w's and the output's placements) for the fused unit norm ->
    ``x (..., K) @ w (K, N)`` -> activation: the norm needs whole rows and
    the activation whole sums, so a weight split over K is gathered; a
    weight split over N keeps its split (each rank runs the kernel on its
    own N columns) and the output is split over N; an ``x`` split over a
    batch dimension keeps it, the weight whole there."""
    last = x_ndim - 1
    xs, ws, outs = [], [], []
    for a, b in zip(px, pw):
        d = _shard_dim(a)
        if d is not None and d < last:
            xs.append(a), ws.append(_R()), outs.append(a)
        elif _shard_dim(b) == 1:
            xs.append(_R()), ws.append(b), outs.append(_S(last))
        else:
            xs.append(_R()), ws.append(_R()), outs.append(_R())
    return xs, ws, outs


def kv_heads_for(kv, h0: int, hq: int, group: int, k0: int):
    """(KV heads, local group) that query heads [h0, h0 + hq) read, from a
    block ``kv`` (B, n, S, D) of KV heads starting at KV head ``k0``:
    query head h reads KV head h // group. Whole groups, or part of one,
    slice the block; a block of query heads that cuts groups unevenly
    gets each KV head repeated for its query heads (local group 1)."""
    lo, hi = h0 // group, (h0 + hq - 1) // group + 1
    if (hq % group == 0 and h0 % group == 0) or hi - lo == 1:
        if lo == k0 and hi - lo == kv.shape[1]:
            return kv, hq // (hi - lo)
        return kv[:, lo - k0:hi - k0], hq // (hi - lo)
    rep = kv[:, lo - k0:hi - k0].repeat_interleave(group, dim=1)
    start = h0 - lo * group
    return rep[:, start:start + hq].contiguous(), 1


# -- routes ------------------------------------------------------------------
def _dense(fn, x, w, formulation):
    mesh = _mesh((x, w))
    xm = x.mean if is_gaussian(x) else x
    xs, ws, out = dense_plan(placements_of(xm, mesh),
                             placements_of(w.mean, mesh), xm.ndim)
    local = fn(_local_g(x, mesh, xs), _local_g(w, mesh, ws), formulation)
    return _wrap_g(local, mesh, out, tuple(xm.shape[:-1]) + (w.shape[-1],))


def _rows(fn, x, *rest):
    mesh = _mesh((x,))
    ps = rows_plan(placements_of(x.mean, mesh), x.mean.ndim)
    rep = [_R() for _ in ps]
    args = [a if not isinstance(a, torch.Tensor) else _local(a, mesh, rep)
            for a in rest]
    local = fn(_local_g(x, mesh, ps), *args)
    return _wrap_g(local, mesh, ps, x.shape)


def _elementwise(fn, a, *rest):
    mesh = _mesh((a,) + rest)
    first = a.mean if is_gaussian(a) else a
    ps = _no_partial(placements_of(first, mesh))
    args = [_local_g(r, mesh, ps) if (is_gaussian(r) or
                                      isinstance(r, torch.Tensor)) else r
            for r in rest]
    local = fn(_local_g(a, mesh, ps), *args)
    return _wrap_g(local, mesh, ps, first.shape)


def _attention(fn, q_mu, k_mu, v_mu, v_var, scale, causal):
    mesh = _mesh((q_mu, k_mu, v_mu, v_var))
    sizes = [mesh.size(i) for i in range(mesh.ndim)]
    ps = attention_plan(placements_of(q_mu, mesh), sizes, q_mu.shape[1],
                        k_mu.shape[1])
    mu, var = fn(*(_local(t, mesh, ps) for t in (q_mu, k_mu, v_mu, v_var)),
                 scale, causal)
    shape = tuple(q_mu.shape[:3]) + (v_mu.shape[3],)
    return _wrap(mu, mesh, ps, shape), _wrap(var, mesh, ps, shape)


def block_of(size: int, mesh, ps, dim: int = 0):
    """(first index, length) of this rank's block of a dimension ``dim``
    of ``size`` split by the placements ``ps`` (in mesh order, as DTensor
    chunks). ``mesh`` needs only ``size(i)`` and ``get_local_rank(i)``."""
    offset = 0
    for i, p in enumerate(ps):
        if _shard_dim(p) == dim:
            chunk = -(-size // mesh.size(i))
            start = chunk * mesh.get_local_rank(i)
            offset += start
            size = max(0, min(chunk, size - start))
    return offset, size


def row_offset(rows: int, mesh, ps) -> int:
    """The first row of this rank's block of ``rows`` rows split by the
    ``Shard(0)`` placements ``ps``."""
    return block_of(rows, mesh, ps, 0)[0]


def _embedding(fn, table, ids):
    mesh = _mesh((table, ids))
    tm = table.mean if is_gaussian(table) else table
    ts, ips, out = embedding_plan(placements_of(tm, mesh),
                                  placements_of(ids, mesh), ids.ndim)
    local_table = _local_g(table, mesh, ts)
    local_ids = _local(ids, mesh, ips)
    if any(_shard_dim(t) == 0 for t in ts):
        lo = row_offset(tm.shape[0], mesh, ts)
        local = masked_embedding(fn, local_table, local_ids, lo)
    else:
        local = fn(local_table, local_ids)
    shape = tuple(ids.shape) + (tm.shape[-1],)
    if is_gaussian(local):
        return _wrap_g(local, mesh, out, shape)
    return _wrap(local, mesh, out, shape)


def _heads_local(heads, kv_heads, mesh, qs, ks, kvs):
    """The KV tensors ``kvs`` (local blocks under ``ks``) cut to the KV
    heads this rank's query heads (its block under ``qs``) read."""
    group = heads // kv_heads
    h0, hq = block_of(heads, mesh, qs, 1)
    k0, hk = block_of(kv_heads, mesh, ks, 1)
    if hq == hk * group and h0 == k0 * group:
        return kvs
    return [kv_heads_for(t, h0, hq, group, k0)[0] for t in kvs]


def _attention_cache(fn, q_mu, k_mu, v_mu, v_var, q_start, kv_len, scale,
                     causal, window):
    def attend(q, _, k, v, vv, start, length, __):
        return fn(q, k, v, vv, start, length, scale, causal, window)

    return per_rank_cache(attend, q_mu, None, k_mu, v_mu, v_var,
                          rows=(q_start, kv_len))


def _attention_paged(fn, q_mu, k_pages, v_pages, vv_pages, page_table,
                     q_start, kv_len, scale, causal, window):
    def attend(q, _, k, v, vv, start, length, table):
        return fn(q, k, v, vv, table, start, length, scale, causal, window)

    return per_rank_cache(attend, q_mu, None, k_pages, v_pages, vv_pages,
                          rows=(q_start, kv_len), page_table=page_table)


def fused_local_shape(x, w):
    """(rows, K, N) of this rank's fused-unit call on ``x (..., K)`` and
    ``w (K, N)`` (Gaussian, DTensors) under :func:`fused_plan`: the key a
    tuned schedule is looked up by, so a DB tuned at the global shape
    misses on a split one."""
    mesh = _mesh((x, w))
    xs, ws, _ = fused_plan(placements_of(x.mean, mesh),
                           placements_of(w.mean, mesh), x.mean.ndim)
    rows = 1
    for dim, size in enumerate(x.mean.shape[:-1]):
        rows *= block_of(size, mesh, xs, dim)[1]
    n = block_of(w.mean.shape[-1], mesh, ws, 1)[1]
    return rows, x.mean.shape[-1], n


def _norm_dense_act(fn, x, gain, bias, w, norm, eps, act):
    mesh = _mesh((x, w))
    xs, ws, out = fused_plan(placements_of(x.mean, mesh),
                             placements_of(w.mean, mesh), x.mean.ndim)
    rep = [_R() for _ in xs]
    local = fn(_local_g(x, mesh, xs), _local(gain, mesh, rep),
               None if bias is None else _local(bias, mesh, rep),
               _local_g(w, mesh, ws), norm, eps, act)
    return _wrap_g(local, mesh, out,
                   tuple(x.mean.shape[:-1]) + (w.mean.shape[-1],))


# -- KV-cache attention and the cache inserts on a mesh ---------------------
def per_rank_cache(attend, q_mu, q_var, k_mu, v_mu, v_var, *, rows,
                   page_table=None):
    """KV-cache attention on DTensors, the kernel route's and the eager
    impl's: ``attend(q_mu, q_var, k_mu, v_mu, v_var, *rows, page_table)``
    runs on each rank's blocks, placed by :func:`cache_plan` (or
    :func:`paged_plan` where ``page_table`` is given: then k / v / v_var
    are page pools), the KV heads cut to those the rank's query heads read.
    q (B, H, Tq, D); ``rows``: per-slot tensors ((B,), (B, Tq)) that
    follow the queries' slots. The outputs come back placed as the
    queries."""
    mesh = _mesh((q_mu, k_mu))
    plan = cache_plan if page_table is None else paged_plan
    qs, ks = plan(placements_of(q_mu, mesh), placements_of(k_mu, mesh),
                  list(mesh.shape), q_mu.shape[1], k_mu.shape[1])
    follow = _follow_rows(qs)
    kv = _heads_local(q_mu.shape[1], k_mu.shape[1], mesh, qs, ks,
                      [_local(t, mesh, ks) for t in (k_mu, v_mu, v_var)])
    mu, var = attend(_local(q_mu, mesh, qs),
                     None if q_var is None else _local(q_var, mesh, qs),
                     *kv, *(_local(t, mesh, follow) for t in rows),
                     None if page_table is None else _local(page_table, mesh,
                                                            follow))
    shape = tuple(q_mu.shape[:3]) + (v_mu.shape[-1],)
    return (_wrap(mu, mesh, qs, shape),
            None if var is None else _wrap(var, mesh, qs, shape))


def insert_rows_block(buf, new, positions, offset: int, total: int):
    """A contiguous cache insert on a block of the sequence: rows
    ``[offset, offset + buf.shape[2])`` of a cache of ``total`` rows. Each
    new row lands at ``positions[b, 0] + i`` (clamped so the rows fit, as
    on one device) where that falls in the block; rows outside it are
    written to one extra row, which is dropped. Out of place."""
    b, hkv, tq, d = new.shape
    s = buf.shape[2]
    start = positions[:, 0].clamp(0, total - tq)
    idx = start[:, None] + torch.arange(tq, device=buf.device) - offset
    if s == total:             # the whole sequence: no row falls outside
        return buf.scatter(2, idx[:, None, :, None].expand(b, hkv, tq, d),
                           new.to(buf.dtype))
    idx = torch.where((idx >= 0) & (idx < s), idx, s)
    out = torch.cat([buf, buf.new_zeros(b, hkv, 1, d)], dim=2)
    out = out.scatter(2, idx[:, None, :, None].expand(b, hkv, tq, d),
                      new.to(buf.dtype))
    return out[:, :, :s].contiguous()


def insert_pages_block(buf, new, dest_page, dest_row, page0: int,
                       row0: int, whole_pool: bool = False):
    """A paged cache insert on a block of the pool: pages ``[page0, page0
    + buf.shape[0])`` and rows ``[row0, row0 + buf.shape[2])`` of each.
    New row (b, i) lands at page ``dest_page[b, i]``, row ``dest_row[b,
    i]``, at their local indices, where both fall in the block; every
    other row goes to one extra page, which is dropped. No row lands in a
    local page that only shares a global page's index. ``whole_pool``:
    the block is the whole pool, and every row lands. Out of place."""
    if whole_pool:
        out = buf.clone()
        out[dest_page, :, dest_row] = new.to(buf.dtype).transpose(1, 2)
        return out
    n, hkv, rows, d = buf.shape
    page = dest_page - page0
    row = dest_row - row0
    mine = (page >= 0) & (page < n) & (row >= 0) & (row < rows)
    out = torch.cat([buf, buf.new_zeros(1, hkv, rows, d)])
    out[torch.where(mine, page, n), :, torch.where(mine, row, 0)] = \
        new.to(buf.dtype).transpose(1, 2)
    return out[:n]


def insert_plan(pb: Sequence, paged: bool):
    """(the new rows', their indices' placements) for an insert into a
    cache placed ``pb``: the new rows (B, Hkv, Tq, D) take the cache's
    head split; a contiguous cache's slot split too, a paged pool's page
    split not (any slot may write any page); the sequence or page rows
    whole. The indices ((B,) / (B, Tq)) follow the new rows' slots."""
    new = [p if (_shard_dim(p) == 1 or (_shard_dim(p) == 0 and not paged))
           else _R() for p in pb]
    return new, _follow_rows(new)


def insert_rows(buf, new, positions):
    """:func:`insert_rows_block` on a DTensor cache (B, Hkv, S, D): each
    rank writes the rows of its own slots, heads and sequence block."""
    mesh, pb = buf.device_mesh, list(buf.placements)
    pn, pi = insert_plan(pb, paged=False)
    offset, _ = block_of(buf.shape[2], mesh, pb, 2)
    local = insert_rows_block(buf.to_local(), _local(new, mesh, pn),
                              _local(positions, mesh, pi), offset,
                              buf.shape[2])
    return _wrap(local, mesh, pb, buf.shape)


def insert_pages(buf, new, dest_page, dest_row):
    """:func:`insert_pages_block` on a DTensor pool (NP, Hkv, ps, D): each
    new row is written on the rank that holds its page (and its row of the
    page), at the local index there."""
    mesh, pb = buf.device_mesh, list(buf.placements)
    pn, pi = insert_plan(pb, paged=True)
    page0, _ = block_of(buf.shape[0], mesh, pb, 0)
    row0, _ = block_of(buf.shape[2], mesh, pb, 2)
    local = buf.to_local()
    local = insert_pages_block(local, _local(new, mesh, pn),
                               _local(dest_page, mesh, pi),
                               _local(dest_row, mesh, pi), page0, row0,
                               local.shape == buf.shape)
    return _wrap(local, mesh, pb, buf.shape)


# -- decode-state rows on a mesh (the slot and page helpers of lm.py) --------
def owned(idx, offset: int, size: int):
    """(positions in ``idx``, local indices) of the global indices ``idx``
    (a 1-D long tensor) that fall in a block [offset, offset + size): the
    rows a rank writes, and where in its block."""
    sel = torch.nonzero((idx >= offset) & (idx < offset + size))[:, 0]
    return sel, idx[sel] - offset


def _whole_on(ps, dim):
    return [_R() if _shard_dim(p) == dim else p for p in ps]


def take_rows(leaf, dim: int, idx):
    """``leaf.index_select(dim, idx)`` on a DTensor: ``dim`` gathered,
    the rows taken on every rank, and the result placed as ``leaf`` where
    it has ``leaf``'s length there (a permutation: compaction, defrag), else
    whole on ``dim`` (a slot's view for a prefill chunk or a replay). The
    gather moves the whole leaf; it runs on compaction, defrag, a
    copy-on-write and a slot's view, not at every decode step."""
    mesh, ps = leaf.device_mesh, list(leaf.placements)
    whole = _whole_on(ps, dim)
    rows = _local(leaf, mesh, whole).index_select(dim, idx.to(leaf.device))
    shape = list(leaf.shape)
    shape[dim] = len(idx)
    out = _wrap(rows, mesh, whole, shape)
    if len(idx) == leaf.shape[dim] and whole != ps:
        out = out.redistribute(mesh, ps)
    return out


def update_rows(leaf, dim: int, idx, write):
    """``leaf`` with rows ``idx`` (global indices along ``dim``, a 1-D
    long tensor on the host) rewritten on the ranks that hold them:
    ``write(local_block, at, sel)`` gets this rank's block, the local
    indices ``at`` of the rows it holds and their positions ``sel`` in
    ``idx`` (both on the block's device). Every other rank's block is
    left as it is."""
    mesh, ps = leaf.device_mesh, list(leaf.placements)
    offset, size = block_of(leaf.shape[dim], mesh, ps, dim)
    local = leaf.to_local()
    sel, at = owned(idx, offset, size)
    if len(sel):
        local = write(local, at.to(local.device), sel.to(local.device))
    return _wrap(local, mesh, ps, leaf.shape)


def rows_like(rows, leaf, dim: int):
    """This rank's block of ``rows`` (plain or DTensor, whole along
    ``dim``) under ``leaf``'s placements but for ``dim``."""
    return _local(rows, leaf.device_mesh, _whole_on(list(leaf.placements),
                                                    dim))


def select_rows(new, old, dim: int, keep):
    """``torch.where(keep, new, old)`` along ``dim`` (``keep`` (B,) bool)
    on DTensors of the same placements: each rank merges its own block."""
    mesh, ps = old.device_mesh, list(old.placements)
    offset, size = block_of(old.shape[dim], mesh, ps, dim)
    new_local = _local(new, mesh, ps)
    shape = [1] * old.ndim
    shape[dim] = size
    k = keep[offset:offset + size].reshape(shape)
    return _wrap(torch.where(k, new_local, old.to_local()), mesh, ps,
                 old.shape)


ROUTES = {
    "dense": _dense,
    "rmsnorm": _rows,
    "layernorm": _rows,
    "activation": _elementwise,
    "glu_product": _elementwise,
    "residual": _elementwise,
    "attention": _attention,
    "attention_cache": _attention_cache,
    "attention_paged": _attention_paged,
    "norm_dense_act": _norm_dense_act,
    "embedding": _embedding,
}
