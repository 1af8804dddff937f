"""Roofline terms of a dry-run cell on NVIDIA H100 cards.

Counterpart of ``repro/launch/roofline.py``, with the H100's rates in
place of the reference's TPU constants. Per (arch x shape x mesh), per
device:

    compute    = FLOPs / PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = sum over collectives of link bytes / the rate of the
                 links its group crosses

The rates are NVIDIA's data-sheet peaks for the H100 SXM part (NVIDIA
H100 80GB HBM3, 700 W), not measurements:

* ``PEAK_FLOPS`` 67 TFLOP/s: fp32 on the SIMT cores, outside the tensor
  cores. The port computes in IEEE fp32 without TF32 (PERF.md's kernel
  bounds use the same rate).
* ``HBM_BW`` 3.35 TB/s of HBM3.
* ``NVLINK_BW`` 450 GB/s each way between the 8 cards of one NVLink
  node (NVLink 4, 900 GB/s both ways together).
* ``NODE_BW`` 50 GB/s a card across nodes: one 400 Gb/s InfiniBand NDR
  adapter a card. A mesh axis whose group spans more than one 8-card node
  (the production meshes' 16-wide axes) runs at this rate.
"""
from __future__ import annotations

PEAK_FLOPS = 67e12    # fp32 SIMT; NVIDIA H100 80GB HBM3, 700 W, data sheet
HBM_BW = 3.35e12      # bytes/s; NVIDIA H100 80GB HBM3, 700 W, data sheet
NVLINK_BW = 450e9     # bytes/s each way; NVIDIA H100 80GB HBM3, 700 W
NODE_BW = 50e9        # bytes/s a card, 400 Gb/s InfiniBand; same card
NODE_CARDS = 8        # cards joined by NVLink in one node
HBM_BYTES = 80e9      # NVIDIA H100 80GB HBM3, 700 W, data sheet


def link_rate(ranks) -> float:
    """The rate a collective over ``ranks`` (global ranks, one card each,
    8 consecutive ranks a node) moves at: NVLink inside one node, the node
    network otherwise."""
    nodes = {r // NODE_CARDS for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NODE_BW


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: float, *, links: int = 1,
                   link_bw: float = NODE_BW,
                   collective_s: float | None = None) -> dict:
    """The three terms, the bottleneck, the step's lower bound and the
    compute share of it. ``collective_s`` (link bytes already divided by
    each group's rate) overrides ``coll_bytes / (link_bw * links)``."""
    compute = flops_per_device / PEAK_FLOPS
    memory = bytes_per_device / HBM_BW
    collective = (collective_s if collective_s is not None
                  else coll_bytes_per_device / (link_bw * links))
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(compute, memory, collective)
    terms["step_time_lower_bound_s"] = total
    terms["roofline_fraction"] = compute / total if total > 0 else 0.0
    return terms


def model_flops(meta: dict, shape_kind: str, seq_len: int, global_batch: int,
                new_tokens: int = 1) -> float:
    """MODEL_FLOPS = 6 N D (train) or 2 N D (inference), N = active params."""
    n = meta["active_params"]
    if shape_kind == "train":
        return 6.0 * n * seq_len * global_batch
    if shape_kind == "prefill":
        return 2.0 * n * seq_len * global_batch
    return 2.0 * n * new_tokens * global_batch
