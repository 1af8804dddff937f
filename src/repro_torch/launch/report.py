"""Aggregate the dry-run's JSONs into the dry-run and roofline tables.

Counterpart of ``repro/launch/report.py``, over ``results/dryrun_torch/``
(or ``--dir``): the same two tables and ``pick_hillclimb_cells``, with the
H100 roofline terms and ``fits_80gb_hbm``.

Usage: ``python -m repro_torch.launch.report [roofline|dryrun|pick]
[pod|multipod] [--dir DIR]``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR


def load(mesh: str = "pod", tag: str = "", results_dir: str = RESULTS_DIR):
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("mesh") != mesh or (r.get("tag") or "") != tag:
            continue
        if r.get("mode_override"):
            continue
        rows.append(r)
    return rows


def _skip_or_error(r, width):
    what = ("skipped (full attention)" if r["status"] == "skipped"
            else f"error: {r.get('error', '')[:60]}")
    return f"| {r['arch']} | {r['shape']} | {what} |" + " — |" * width


def roofline_table(mesh: str = "pod", tag: str = "",
                   results_dir: str = RESULTS_DIR) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "bottleneck | MODEL/counted flops | HBM/dev (est) | fits 80 GB |")
    lines = [hdr, "|" + "---|" * 9]
    for r in load(mesh, tag, results_dir):
        if r["status"] != "ok":
            lines.append(_skip_or_error(r, 6))
            continue
        ratio = r.get("useful_flops_ratio") or 0.0
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3g} | "
            f"{r['memory_s']:.3g} | {r['collective_s']:.3g} | "
            f"{r['bottleneck']} | {ratio:.2f} | "
            f"{r.get('hbm_estimate', 0) / 1e9:.1f} GB | "
            f"{'yes' if r.get('fits_80gb_hbm') else 'NO'} |")
    return "\n".join(lines)


def dryrun_table(mesh: str = "pod", results_dir: str = RESULTS_DIR) -> str:
    hdr = ("| arch | shape | program | build s | run s | flops/dev | "
           "bytes/dev | coll link B/dev | AG/AR/RS/A2A/CP (operand B) |")
    lines = [hdr, "|" + "---|" * 9]
    for r in load(mesh, results_dir=results_dir):
        if r["status"] != "ok":
            lines.append(_skip_or_error(r, 6))
            continue
        cb = r.get("collective_bytes", {})

        def op(kind):
            return f"{cb.get(kind, {}).get('operand', 0):.2g}"

        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['program'].split(':')[-1]} | "
            f"{r['lower_s']} | {r['compile_s']} | "
            f"{r['flops_per_device']:.3g} | {r['bytes_per_device']:.3g} | "
            f"{r['collective_bytes_link']:.3g} | "
            f"{op('all-gather')}/{op('all-reduce')}/{op('reduce-scatter')}/"
            f"{op('all-to-all')}/{op('collective-permute')} |")
    return "\n".join(lines)


def pick_hillclimb_cells(mesh: str = "pod", results_dir: str = RESULTS_DIR):
    """Worst roofline fraction, and most collective-bound."""
    rows = [r for r in load(mesh, results_dir=results_dir)
            if r["status"] == "ok"]
    worst = min(rows, key=lambda r: r.get("roofline_fraction", 1.0))
    coll = max(rows, key=lambda r: (r["collective_s"] /
                                    max(r["step_time_lower_bound_s"], 1e-12)))
    return worst, coll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="roofline",
                    choices=["roofline", "dryrun", "pick"])
    ap.add_argument("mesh", nargs="?", default="pod",
                    choices=["pod", "multipod"])
    ap.add_argument("--dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    if args.which == "roofline":
        print(roofline_table(args.mesh, results_dir=args.dir))
    elif args.which == "dryrun":
        print(dryrun_table(args.mesh, results_dir=args.dir))
    else:
        w, c = pick_hillclimb_cells(args.mesh, results_dir=args.dir)
        print("worst roofline fraction:", w["arch"], w["shape"],
              f"{w.get('roofline_fraction'):.3f}")
        print("most collective-bound:", c["arch"], c["shape"],
              f"coll={c['collective_s']:.3g}s vs "
              f"compute={c['compute_s']:.3g}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
