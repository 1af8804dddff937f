"""Per-device costs of a program, counted at the aten level.

Counterpart of ``repro/launch/costs.py``. :class:`CostMode` is a
``TorchDispatchMode`` that sees every aten op a program runs on each
device's local shards (a DTensor op is followed down to the local ops and
collectives its sharding propagation issues) and counts, under the
reference's rules:

* exact FLOPs for ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` /
  ``convolution`` (2 x output elements x contraction length), reported
  also apart as ``matmul_flops``;
* one FLOP per output element for every other op;
* input plus output bytes of every op (an unfused upper bound);
* the peak of the live bytes of the storages the run makes (each counted
  from the op that makes it until it is freed): temporaries and outputs,
  without the arguments.

View and metadata ops (``view``, ``transpose``, ``expand``, ``select``,
...) move no data and are not counted. Collectives are read from the
``_c10d_functional`` ops the same mode sees, with the reference's operand
and ring-link formulas (``collective_bytes_scaled``): all-gather operand
= output / g, reduce-scatter operand = output * g, the others the output;
link traffic (g-1)/g of the full buffer for all-gather and reduce-scatter,
2 (g-1)/g for all-reduce, the output for all-to-all. Each collective's
link time uses the rate of the links its group crosses
(``roofline.link_rate``).

DTensor finds each op's output shape by running the op once on fake
tensors of the global shapes (``ShardingPropagator``); while the mode is
on, those runs see no mode, and are neither counted nor tracked.

The reference scales loop bodies by their trip counts because XLA costs a
``while`` body once. The port loops over layers in Python, so every
layer's ops are seen and counted as they run: there is nothing to scale.

Run the program under ``FakeTensorMode`` (nothing is allocated) with the
mode innermost; the counts are per device, from the local shapes.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.roofline import link_rate

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "convolution"}
_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_FREE = {"wait_tensor", "_to_copy_meta", "lift_fresh", "detach",
         "_local_scalar_dense", "empty", "empty_strided", "empty_like"}


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for a in x:
            yield from _leaves(a)
    elif isinstance(x, dict):
        for a in x.values():
            yield from _leaves(a)


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(x))


def _numel(x) -> int:
    return sum(t.numel() for t in _leaves(x))


def _matmul_flops(name, args, out) -> int:
    out_n = _numel(out)
    if name == "convolution":   # weight (out, in / groups, *kernel)
        return 2 * out_n * math.prod(args[1].shape[1:])
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2 * out_n * a.shape[-1]


def _group_ranks(group_name):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return dist.get_process_group_ranks(_resolve_process_group(group_name))


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes and collectives per device (see the module)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.matmul_flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives = {k: {"operand": 0.0, "link": 0.0, "count": 0}
                            for k in _KINDS}
        self.collective_s = 0.0
        self.live = self.peak = 0
        self._storages: Dict[int, int] = {}

    def __enter__(self):
        # DTensor derives each op's output shape by running the op on fake
        # tensors of the *global* shapes; those runs are not the program's
        # work. They run with every mode set aside (this one and the
        # caller's fake mode: DTensor then makes a fake mode of its own
        # for them, so nothing is allocated).
        prop = _propagator()
        if prop is not None:
            run = prop._propagate_tensor_meta_non_cached

            def unseen(op_schema, _run=run):
                from torch.utils._python_dispatch import \
                    _disable_current_modes

                with _disable_current_modes():
                    return _run(op_schema)

            prop._propagate_tensor_meta_non_cached = unseen
        return super().__enter__()

    def __exit__(self, *exc):
        prop = _propagator()
        if prop is not None:
            prop.__dict__.pop("_propagate_tensor_meta_non_cached", None)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        dtensor = _dtensor_class()
        if dtensor is not None and any(issubclass(t, dtensor)
                                       for t in types):
            # Let DTensor run first: its local ops and collectives come
            # back through this mode.
            return NotImplemented
        out = func(*args, **kwargs)
        self._count(func, args, out)
        if not func.is_view:
            self._track(args, out)
        return out

    def _track(self, args, out):
        """Add the storages ``out`` holds that no argument holds and that
        are not tracked yet to the live bytes; each leaves them when it is
        freed."""
        given = {t.untyped_storage()._cdata for t in _leaves(args)}
        for t in _leaves(out):
            storage = t.untyped_storage()
            key = storage._cdata
            if key in given or key in self._storages:
                continue
            self._storages[key] = storage.nbytes()
            self.live += storage.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._release, key)

    def _release(self, key):
        self.live -= self._storages.pop(key, 0)

    def _count(self, func, args, out):
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                group = args[-1]
                self._collective(kind, _bytes(out), _group_ranks(group))
            return
        if name in _FREE or func.is_view or name.endswith("_view"):
            return
        self.ops += 1
        if name in _MATMUL:
            f = _matmul_flops(name, args, out)
            self.flops += f
            self.matmul_flops += f
        else:
            self.flops += _numel(out)
        self.bytes += _bytes(args) + _bytes(out)

    def _collective(self, kind, out_b, ranks):
        g = max(len(ranks), 1)
        if kind == "all-gather":
            operand, link = out_b / g, (g - 1) / g * out_b
        elif kind == "reduce-scatter":
            operand, link = out_b * g, (g - 1) / g * out_b * g
        elif kind == "all-reduce":
            operand, link = out_b, 2 * (g - 1) / g * out_b
        else:
            operand, link = out_b, out_b
        c = self.collectives[kind]
        c["operand"] += operand
        c["link"] += link
        c["count"] += 1
        self.collective_s += link / link_rate(ranks)

    def summary(self) -> Dict[str, object]:
        return {
            "flops": float(self.flops),
            "matmul_flops": float(self.matmul_flops),
            "bytes": float(self.bytes),
            "ops": self.ops,
            "collective_bytes": {k: dict(v) for k, v in
                                 self.collectives.items()},
            "collective_bytes_operand": float(sum(
                v["operand"] for v in self.collectives.values())),
            "collective_bytes_link": float(sum(
                v["link"] for v in self.collectives.values())),
            "collective_s": self.collective_s,
            "peak_bytes": float(self.peak),
        }


def _propagator():
    """DTensor's sharding propagator, where DTensor is loaded."""
    dtensor = _dtensor_class()
    return (None if dtensor is None
            else dtensor._op_dispatcher.sharding_propagator)


def _dtensor_class():
    import sys

    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor
