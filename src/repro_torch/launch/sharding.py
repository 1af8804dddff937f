"""Sharding rules: FSDP x TP specs for parameters, batches and decode state.

Counterpart of ``repro/launch/sharding.py``, rule for rule. A spec is a
tuple with one entry per tensor dimension: a mesh axis name, a tuple of
axis names (the dimension split over their product, row-major), or None
(the counterpart of a ``PartitionSpec``; a shorter tuple leaves the
trailing dimensions unsharded). Rules match the reference's tree paths
(``stack/b0/attn/wq/w/mu``), which ``nn.module.param_layout`` gives for
the port's modules, and shard an axis only where its size divides the
mesh axis (``_shard_if``); anything else stays replicated.

Parameters shard over ``data`` (FSDP) and ``model`` (TP) but never over
``pod``; batch dimensions shard over ``pod`` and ``data``.

:func:`placements` turns a spec into DTensor placements on a mesh.
``params_shardings`` / ``batch_shardings`` / ``state_shardings`` give the
placements of a module's parameters (by parameter name), of a batch and
of a decode state; ``distribute_params`` and ``distribute_tree`` place
them, each rank slicing its own block of a full tensor with no
collective.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Mapping, Optional

from repro_torch.launch.mesh import axis_names, axis_size, dp_axes, fsdp_axis


def _shard_if(dim: int, mesh, axis):
    if axis is None:
        return None
    if isinstance(axis, tuple):
        total = 1
        for a in axis:
            total *= axis_size(mesh, a)
        return axis if dim % total == 0 else None
    return axis if dim % axis_size(mesh, axis) == 0 else None


def _spec(entries) -> tuple:
    """A spec from its entries, a one-axis tuple written as the axis (as
    ``PartitionSpec`` normalises it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


# (regex on path, spec-builder(shape, mesh, d, m)) without any leading
# stacked axis. First match wins. ``d`` = the FSDP axis, ``m`` = 'model'.
def _param_rules():
    return [
        (r"embed/table", lambda s, M, d, m: (_shard_if(s[0], M, m), None)),
        (r"lm_head/w", lambda s, M, d, m: (_shard_if(s[0], M, d),
                                           _shard_if(s[1], M, m))),
        (r"attn/w[qkv]/w", lambda s, M, d, m: (_shard_if(s[0], M, d),
                                               _shard_if(s[1], M, m))),
        (r"attn/wo/w", lambda s, M, d, m: (_shard_if(s[0], M, m),
                                           _shard_if(s[1], M, d))),
        (r"(mlp|shared)/w_(up|gate)/w", lambda s, M, d, m: (
            _shard_if(s[0], M, d), _shard_if(s[1], M, m))),
        (r"(mlp|shared)/w_down/w", lambda s, M, d, m: (
            _shard_if(s[0], M, m), _shard_if(s[1], M, d))),
        (r"experts/w_(up|gate)", lambda s, M, d, m: (
            _shard_if(s[0], M, m), _shard_if(s[1], M, d), None)),
        (r"experts/w_down", lambda s, M, d, m: (
            _shard_if(s[0], M, m), None, _shard_if(s[2], M, d))),
        (r"moe/router/w", lambda s, M, d, m: (None, None)),
        (r"rec/w_[xy]/w", lambda s, M, d, m: (_shard_if(s[0], M, d),
                                              _shard_if(s[1], M, m))),
        (r"rec/w_out/w", lambda s, M, d, m: (_shard_if(s[0], M, m),
                                             _shard_if(s[1], M, d))),
        (r"rec/w_[ri]/w", lambda s, M, d, m: (None, _shard_if(s[1], M, m))),
        (r"rec/conv_w", lambda s, M, d, m: (None, _shard_if(s[1], M, m))),
        (r"rec/lam", lambda s, M, d, m: (_shard_if(s[0], M, m),)),
        (r"ssm/in_proj/w", lambda s, M, d, m: (_shard_if(s[0], M, d), None)),
        (r"ssm/out_proj/w", lambda s, M, d, m: (None, _shard_if(s[1], M, d))),
        (r"ssm/conv_w", lambda s, M, d, m: (None, None)),
    ]


def param_pspec(path_str: str, shape, mesh, *, serve: bool = False) -> tuple:
    """The spec of the parameter leaf at ``path_str`` (with the stacked
    leading axis where the path starts with ``stack/``). ``serve=True``
    drops the FSDP factor: TP-only serving weights keep the collectives at
    the TP boundary."""
    d, m = (None if serve else fsdp_axis(mesh)), "model"
    core = re.sub(r"/(mu|rho|srm|var)$", "", path_str)
    if core.endswith("/b"):
        return ()
    scanned = core.startswith("stack/")
    eff_shape = tuple(shape)[1 if scanned else 0:]
    for pat, rule in _param_rules():
        if re.search(pat, core):
            spec = rule(eff_shape, mesh, d, m)
            return (None, *spec) if scanned else tuple(spec)
    return ()  # norms, scalars, biases: replicated


def batch_pspec(name: str, shape, mesh) -> tuple:
    dp = dp_axes(mesh)
    b = shape[0] if len(shape) else 1
    bspec = _shard_if(b, mesh, dp)
    if bspec is None and len(dp) > 1:
        bspec = _shard_if(b, mesh, (dp[-1],))
    rest = [None] * (len(shape) - 1)
    if name in ("frame_embeddings", "image_embeddings") and len(shape) == 3:
        rest[-1] = _shard_if(shape[-1], mesh, "model")
    return _spec((bspec, *rest))


def state_pspec(path_str: str, shape, mesh) -> tuple:
    """Decode-state specs (KV caches (B, Hkv, S, D), recurrent and SSM
    carries), with a leading group axis where the path is stacked. The
    sequence shards over 'model' wherever the KV heads cannot fill it."""
    dp = dp_axes(mesh)
    scanned = path_str.startswith("stack/")
    eff = tuple(shape)[1 if scanned else 0:]
    spec: list = [None] * len(eff)
    batch = (lambda n: _shard_if(n, mesh, dp)
             or _shard_if(n, mesh, (dp[-1],)))
    if len(eff) == 4 and ("k_mu" in path_str or "v_mu" in path_str
                          or "v_var" in path_str):
        b, h, s, _ = eff
        spec[0] = batch(b)
        if _shard_if(h, mesh, "model"):
            spec[1] = "model"
        else:
            spec[2] = _shard_if(s, mesh, "model")
    elif len(eff) == 4:  # SSM state (B, H, P, N)
        spec[0] = batch(eff[0])
        spec[1] = _shard_if(eff[1], mesh, "model")
    elif len(eff) >= 1:
        spec[0] = batch(eff[0])
    if scanned:
        spec = [None] + spec
    return _spec(spec)


# -- placements ---------------------------------------------------------------
def placements(spec: tuple, mesh) -> list:
    """DTensor placements (one per mesh axis) of ``spec``. A dimension over
    several axes must name them in mesh order: DTensor then splits it over
    the first, each block over the next, which gives every rank the block
    of a row-major ``PartitionSpec``."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        members = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in members]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {members} of one dimension "
                             f"must be in mesh order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} uses mesh axis {names[i]} "
                                 "twice")
            out[i] = Shard(dim)
    return out


def replicated(mesh) -> list:
    return placements((), mesh)


def _path(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def params_shardings(module, mesh, *, serve: bool = False) -> dict:
    """{parameter name: placements} for every parameter of ``module``,
    from the reference's rule for its tree path. A stacked leaf (one
    parameter a layer under an ``nn.ModuleList``) gets its stacked shape's
    spec without the leading group axis."""
    from repro_torch.nn.module import param_layout

    params = dict(module.named_parameters(remove_duplicate=False))
    out = {}

    def walk(tree, prefix):
        for key, sub in tree.items():
            path = _path(prefix, key)
            if isinstance(sub, Mapping):
                walk(sub, path)
                continue
            shape = tuple(params[sub.names[0]].shape)
            if sub.stacked:
                shape = (len(sub.names),) + shape
            spec = param_pspec(path, shape, mesh, serve=serve)
            if sub.stacked:
                spec = spec[1:]
            for name in sub.names:
                out[name] = placements(spec, mesh)

    walk(param_layout(module), "")
    return out


def batch_shardings(batch: Mapping, mesh) -> dict:
    """{input name: placements} of a batch of tensors (or shapes)."""
    return {k: placements(batch_pspec(k, tuple(getattr(v, "shape", v)),
                                      mesh), mesh)
            for k, v in batch.items()}


def map_with_path(fn, tree, prefix: str = ""):
    """``tree`` (dicts and NamedTuples of leaves) with each leaf replaced by
    ``fn(path, leaf)``; paths are the reference's (``stack/b0/k_mu``)."""
    if isinstance(tree, Mapping):
        return {k: map_with_path(fn, v, _path(prefix, k))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f),
                                          _path(prefix, f))
                            for f in tree._fields))
    return fn(prefix, tree)


def state_shardings(states, mesh):
    """The placements of a decode state, as a tree of its shape: dicts,
    NamedTuples (KV caches, recurrent and SSM carries) of tensors."""
    return map_with_path(lambda path, leaf: placements(
        state_pspec(path, tuple(leaf.shape), mesh), mesh), states)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and the placements of one tensor on it (the counterpart of
    a ``NamedSharding``): a leaf of the trees ``CheckpointManager.restore``
    takes."""
    mesh: Any
    placements: tuple

    def place(self, tensor):
        return distribute(tensor, self.mesh, self.placements)


def layout_shardings(layout, module, mesh, *, serve: bool = False,
                     prefix: str = ""):
    """``Sharding`` leaves for a ``param_layout`` tree of ``module`` (a
    stacked leaf gets its stacked shape's spec): the ``shardings`` of an
    elastic restore of the reference's parameter tree."""
    if isinstance(layout, Mapping):
        return {k: layout_shardings(v, module, mesh, serve=serve,
                                    prefix=_path(prefix, k))
                for k, v in layout.items()}
    shape = tuple(module.get_parameter(layout.names[0]).shape)
    if layout.stacked:
        shape = (len(layout.names),) + shape
    spec = param_pspec(prefix, shape, mesh, serve=serve)
    return Sharding(mesh, tuple(placements(spec, mesh)))


def distribute(tensor, mesh, placement):
    """``tensor`` (whole, equal on every rank) as a DTensor with
    ``placement``: each rank keeps its own block, no collective runs. A
    dimension of size 1 "split" over a mesh axis of size 1 is placed as a
    replica, which it is: DTensor refuses to squeeze a split dimension."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    placement = [Replicate() if (p.is_shard() and tensor.shape[p.dim] == 1
                                 and mesh.size(i) == 1) else p
                 for i, p in enumerate(placement)]
    return distribute_tensor(tensor.detach(), mesh, placement,
                             src_data_rank=None)


def distribute_params(module, mesh, shardings: Optional[dict] = None, *,
                      serve: bool = False):
    """Replace every parameter of ``module`` in place by a DTensor
    parameter on ``mesh`` (``shardings`` by name, default the rules'),
    keeping ``requires_grad``. Returns ``module``."""
    from torch import nn

    if shardings is None:
        shardings = params_shardings(module, mesh, serve=serve)
    for mod_name, mod in module.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            full = f"{mod_name}.{name}" if mod_name else name
            mod._parameters[name] = nn.Parameter(
                distribute(p, mesh, shardings[full]),
                requires_grad=p.requires_grad)
    return module


def placed_copy(module, mesh, *, serve: bool = False):
    """A copy of ``module`` with its parameters placed on ``mesh`` as
    :func:`distribute_params` places them, ``module`` left as it is. The
    copy has modules of its own; its parameters' blocks are cut from
    ``module``'s tensors, and a replica shares their storage."""
    import copy
    import itertools

    memo = {id(t): t for t in itertools.chain(module.parameters(),
                                              module.buffers())}
    return distribute_params(copy.deepcopy(module, memo), mesh, serve=serve)


def distribute_tree(tree, shardings, mesh):
    """A tree of whole tensors placed by a tree of placements of the same
    shape (``batch_shardings`` / ``state_shardings``)."""
    if isinstance(tree, Mapping):
        return {k: distribute_tree(v, shardings[k], mesh)
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(distribute_tree(getattr(tree, f),
                                            getattr(shardings, f), mesh)
                            for f in tree._fields))
    return distribute(tree, mesh, shardings)
