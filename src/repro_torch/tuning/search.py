"""Candidate schedules per op and shape.

Counterpart of ``repro/tuning/search.py``'s ``candidates``. The
reference ranks Pallas block shapes with a VMEM cost model for the TPU;
nothing of it transfers to the card. Here the search space is what
``csrc/pfp_fused.cu`` is instantiated for, ``kernels/pfp_fused.TILES``
(the dense kernel's plans of split 1), cut to the tiles that are legal
for the shape: a tile taller than M rounded up to 16 rows, or wider than
N rounded up to 64 columns, only adds masked threads. A shape where the
unfused chain's dense splits K (``pfp_fused.fusable``) has none: the
fusion pass runs the chain there. Candidates come larger tiles first; on
the card ``measure`` times them, on the CPU the first one is taken. A
shared-memory and register cost model is later work (ROADMAP.md).
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.kernels.pfp_fused import TILES, fusable
from repro_torch.tuning.schedules import TUNABLE_OPS, Schedule

ShapeKey = Tuple[int, ...]


def _round_up(x: int, base: int) -> int:
    return -(-max(int(x), 1) // base) * base


def candidates(op: str, shape_key: ShapeKey, *,
               limit: int = 8) -> List[Schedule]:
    """At most ``limit`` legal schedules for ``op`` at ``shape_key``,
    larger tiles first (ties: the taller one); none where it does not
    fuse."""
    if op not in TUNABLE_OPS:
        raise ValueError(f"unknown tunable op {op!r}; expected one of "
                         f"{TUNABLE_OPS}")
    m, k, n = (int(d) for d in shape_key)
    if not fusable(k, n):
        return []
    legal = [(bm, bn) for bm, bn in TILES
             if bm <= _round_up(m, 16) and bn <= _round_up(n, 64)]
    legal.sort(key=lambda t: (-t[0] * t[1], -t[0]))
    return [Schedule.make(op, block_m=bm, block_n=bn)
            for bm, bn in legal[:max(int(limit), 1)]]
