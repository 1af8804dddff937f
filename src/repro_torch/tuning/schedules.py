"""Schedule descriptors for the port's tuned kernels.

Counterpart of ``repro/tuning/schedules.py``. A :class:`Schedule` is what
the autotuner searches over, the cache persists and the dispatch registry
hands to a kernel wrapper: a frozen set of tile parameters for one op. It
knows nothing of torch or the kernels, so every layer can import it.

Only the fused ``norm_dense_act`` kernel (``csrc/pfp_fused.cu``) takes a
schedule: its axes are the (``block_m``, ``block_n``) output tile it is
instantiated for. No other kernel of the port takes a tile yet, and the
reference's Mosaic ``dims`` axis has no counterpart on the card.

Shape keys are the logical shapes the dispatch layer sees, before any
flattening by the wrappers:

    norm_dense_act  (m, k, n)   m = flattened leading dims of the input
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

# Tile parameter names per op, in canonical order.
OP_BLOCK_NAMES: Dict[str, Tuple[str, ...]] = {
    "norm_dense_act": ("block_m", "block_n"),
}

TUNABLE_OPS = tuple(OP_BLOCK_NAMES)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One point of an op's schedule space (hashable, JSON-able)."""

    op: str
    blocks: Tuple[Tuple[str, int], ...]  # sorted (name, value) pairs

    @classmethod
    def make(cls, op: str, **blocks: int) -> "Schedule":
        names = OP_BLOCK_NAMES.get(op)
        if names is None:
            raise ValueError(f"unknown tunable op {op!r}; "
                             f"expected one of {TUNABLE_OPS}")
        for name, value in blocks.items():
            if name not in names:
                raise ValueError(f"{op}: unknown schedule param {name!r}; "
                                 f"expected a subset of {names}")
            if not isinstance(value, int) or isinstance(value, bool) \
                    or value <= 0:
                raise ValueError(f"{op}.{name}: block sizes must be "
                                 f"positive ints, got {value!r}")
        return cls(op=op, blocks=tuple(sorted(blocks.items())))

    def block(self, name: str, default: Optional[int] = None) -> Optional[int]:
        for key, value in self.blocks:
            if key == name:
                return value
        return default

    def as_dict(self) -> Dict[str, int]:
        return dict(self.blocks)

    def describe(self) -> str:
        """Compact form, e.g. ``norm_dense_act[bm=64/bn=64]``."""
        short = "/".join(f"{_SHORT.get(k, k)}={v}" for k, v in self.blocks)
        return f"{self.op}[{short}]"

    def to_json(self) -> Dict[str, object]:
        return {"op": self.op, "blocks": self.as_dict()}

    @classmethod
    def from_json(cls, payload: Mapping[str, object]) -> "Schedule":
        op = payload["op"]
        blocks = payload["blocks"]
        if not isinstance(op, str) or not isinstance(blocks, Mapping):
            raise ValueError(f"malformed schedule payload: {payload!r}")
        return cls.make(op, **{str(k): v for k, v in blocks.items()})


_SHORT = {"block_m": "bm", "block_n": "bn"}


def shape_key_str(shape_key: Tuple[int, ...]) -> str:
    return "x".join(str(int(d)) for d in shape_key)


def parse_shape_key(text: str) -> Tuple[int, ...]:
    return tuple(int(d) for d in text.split("x"))
