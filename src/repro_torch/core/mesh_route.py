"""The ``kernel`` impl's route for DTensor inputs.

The hand-written kernels are bound through ``ctypes`` and take plain
tensors. When a registry op gets a DTensor, this route

  1. redistributes each input to the placements its local kernel needs
     (a plan per op, below: pure functions of the placements and shapes);
  2. runs the op's kernel impl on the ``to_local()`` shards;
  3. wraps the local outputs as DTensors with the plan's placements.

The ops of the dense family's PFP forward take it: ``embedding``,
``rmsnorm``, ``layernorm``, ``dense``, ``glu_product``, ``activation``,
``attention`` and ``residual``. The others raise on a DTensor (the
batched experts, ``einsum``, the cache and paged attention, the CNN ops
and the fused unit come with the sharded-serving slice, ROADMAP.md); no
op carries on on another path. The ``eager`` impl needs no route: it is
plain torch, and DTensor's own propagation carries it.

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
"""
from __future__ import annotations

import sys
from typing import Callable, Sequence

import torch

from repro_torch.core.gaussian import VAR, GaussianTensor, is_gaussian

# Ops with one function for both impls: both take the route.
SHARED = ("embedding", "residual")
NEXT_SLICE = ("dense_batched", "einsum", "attention_cache",
              "attention_paged", "conv2d_im2col", "maxpool2d",
              "norm_dense_act")


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
    return any(isinstance(t, mod.DTensor) for t in _tensors(args))


def wrap(name: str, fn: Callable) -> Callable:
    """``fn`` (a kernel impl) routed through the DTensor plans when any
    argument is a DTensor; plain arguments go straight to ``fn``."""

    def routed(*args):
        if not has_dtensor(args):
            return fn(*args)
        if name not in ROUTES:
            raise NotImplementedError(
                f"the kernel impl of {name!r} takes no DTensor yet: it comes "
                "with the sharded-serving slice (ROADMAP.md)")
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
    return t if want == ps else t.redistribute(t.device_mesh, want)


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
    return t if want == ps else t.redistribute(t.device_mesh, want)


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
    return t if want == ps else t.redistribute(t.device_mesh, want)


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
        t = t.redistribute(mesh, [_R() if p.is_partial() else p for p in out])
    return t


def _wrap_g(g, mesh, out, shape):
    return GaussianTensor(_wrap(g.mean, mesh, out, shape),
                          _wrap(g.second, mesh, out, shape), g.rep)


def _no_partial(ps):
    return [_R() if p.is_partial() else p for p in ps]


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
    return t if list(t.placements) == list(want) else t.redistribute(
        mesh, want)


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
    return t if list(t.placements) == want else t.redistribute(
        ref.device_mesh, want)


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
    """``t`` with any partial sum reduced (a replica there), else as it
    is: scalars of several partial kinds (a mean's, a sum's) add only
    once reduced."""
    if not has_dtensor((t,)) or not any(p.is_partial() for p in
                                        t.placements):
        return t
    return t.redistribute(t.device_mesh, _no_partial(t.placements))


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


def row_offset(rows: int, mesh, ps) -> int:
    """The first row of this rank's block of ``rows`` rows split by the
    ``Shard(0)`` placements ``ps`` (in mesh order, as DTensor chunks)."""
    offset, size = 0, rows
    for i, p in enumerate(ps):
        if _shard_dim(p) == 0:
            chunk = -(-size // mesh.size(i))
            start = chunk * mesh.get_local_rank(i)
            offset += start
            size = max(0, min(chunk, size - start))
    return offset


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


ROUTES = {
    "dense": _dense,
    "rmsnorm": _rows,
    "layernorm": _rows,
    "activation": _elementwise,
    "glu_product": _elementwise,
    "residual": _elementwise,
    "attention": _attention,
    "embedding": _embedding,
}
