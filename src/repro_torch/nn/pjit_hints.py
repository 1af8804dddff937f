"""Logical activation-sharding hints.

Counterpart of ``repro/nn/pjit_hints.py``. Model code anchors activations
with *logical* axis names,

    x = constrain(x, "batch", "seq", "embed")

and the launcher binds the names to mesh axes for one (program x mesh)
with :func:`set_rules`. With no rules bound, or on a tensor that is not a
DTensor, ``constrain`` returns its input object unchanged. With rules
bound it ``redistribute``s a DTensor to the spec the reference would
pick: a dimension whose size does not divide a multi-axis rule falls back
to prefixes of it, and no mesh axis is used by two dimensions.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.gaussian import GaussianTensor, is_gaussian
from repro_torch.launch.mesh import MeshSpec, axis_size

_RULES: Optional[dict] = None


def set_rules(rules: Optional[dict]) -> None:
    """rules: {'mesh': a mesh, '<logical>': axis | tuple of axes | None}."""
    global _RULES
    _RULES = rules


def get_rules() -> Optional[dict]:
    return _RULES


def _axis_total(mesh, axis) -> int:
    if axis is None:
        return 1
    members = axis if isinstance(axis, tuple) else (axis,)
    n = 1
    for a in members:
        n *= axis_size(mesh, a)
    return n


def _shorter(ax):
    return ax[:-1] if isinstance(ax, tuple) and len(ax) > 1 else None


def constrain_spec(shape, logical_axes, rules: dict) -> tuple:
    """The spec ``constrain`` picks for a tensor of ``shape`` (one entry a
    dimension), under ``rules``."""
    mesh = rules["mesh"]
    spec, used = [], set()
    for dim, name in zip(shape, logical_axes):
        ax = rules.get(name)
        while ax is not None:
            members = ax if isinstance(ax, tuple) else (ax,)
            if used.intersection(members):
                ax = _shorter(ax)
                continue
            if dim % _axis_total(mesh, ax) == 0:
                used.update(members)
                break
            ax = _shorter(ax)
        spec.append(ax)
    return tuple(spec)


def _is_dtensor(a) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(a, DTensor)


def _redistribute(a, spec):
    from repro_torch.launch.sharding import placements

    want = placements(spec, a.device_mesh)
    if list(a.placements) == want:
        return a
    return a.redistribute(a.device_mesh, want)


def constrain(x, *logical_axes):
    if _RULES is None:
        return x
    probe = x.mean if is_gaussian(x) else x
    if not _is_dtensor(probe):
        return x

    def one(a):
        if a.ndim != len(logical_axes):
            return a
        return _redistribute(a, constrain_spec(a.shape, logical_axes, _RULES))

    if is_gaussian(x):
        return GaussianTensor(one(x.mean), one(x.second), x.rep)
    return one(x)


def kv_spec(shape, rules: dict) -> tuple:
    """The spec ``constrain_kv`` pins a (B, Hkv, S, D) cache tensor to:
    batch over the state's DP axes, heads over 'model' where they divide
    it, else the sequence (as ``launch.sharding.state_pspec``)."""
    mesh = rules["mesh"]
    dp = rules.get("state_batch") or rules.get("batch")
    b, h, s, _ = shape
    spec = [None, None, None, None]
    if dp is not None:
        if b % _axis_total(mesh, dp) == 0:
            spec[0] = dp
        elif isinstance(dp, tuple) and b % _axis_total(mesh, (dp[-1],)) == 0:
            spec[0] = dp[-1]
    model = axis_size(mesh, "model")
    if h % model == 0:
        spec[1] = "model"
    elif s % model == 0:
        spec[2] = "model"
    return tuple(spec)


def constrain_kv(arr):
    """Pin a (B, Hkv, S, D) KV-cache tensor after a one-token update to the
    decode state's sharding."""
    if _RULES is None or arr.ndim != 4 or not _is_dtensor(arr):
        return arr
    return _redistribute(arr, kv_spec(arr.shape, _RULES))


def place_state(states):
    """A fresh decode state placed by the decode-state rules
    (``launch.sharding.state_pspec``) on the bound mesh, when rules with a
    live mesh are bound and the model runs on it; else as it is."""
    if _RULES is None or isinstance(_RULES["mesh"], MeshSpec):
        return states
    from repro_torch.launch import sharding

    mesh = _RULES["mesh"]
    return sharding.distribute_tree(
        states, sharding.state_shardings(states, mesh), mesh)
