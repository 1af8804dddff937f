"""Time the norm kernels under each plan that could serve a row width, on a
card.

The numbers that ``kernels/pfp_norms.py``'s ``norm_plan`` rule is chosen
from. For each width the configs use (1536 to 8192) it times RMSNorm and
LayerNorm (VAR input, no activation) at a forward's 2048 rows and at a
4-slot decode step's 4 rows under every instantiated plan of fewest
threads for its groups (``GROUPS``), checks each against the plain version
at NORM_TOL, marks the plan ``norm_plan`` gives, and sums, over the
widths, the rule's times beside the fastest plan's at each width. The
empty kernel's time (``csrc/pfp_floor.cu``) is printed as the floor.

Each time is the median of 5 replays of a CUDA graph of 20 calls, between
CUDA events, operands hot in L2. Usage, on the card::

    python3 tools/norm_plan_sweep.py

Rows go to stdout and, in full, to ``chiprun_out/norm_plan_sweep.json``.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
INNER, REPLAYS = 20, 5
WIDTHS = (1536, 2048, 2560, 3072, 4096, 5120, 6144, 8192)
ROWS = (2048, 4)
NORM_TOL = dict(rtol=1e-4, atol=1e-5)


def device_ms(fn, inner=INNER, replays=REPLAYS):
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return sorted(times)[len(times) // 2]


def main():
    import torch
    if not torch.cuda.is_available():
        print("norm_plan_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import pfp_norms as pn
    from repro_torch.kernels._launch import launch_empty
    _build.load()
    dev = torch.device("cuda")
    floor = device_ms(lambda: launch_empty(dev))
    print(f"empty kernel (floor): {floor:.4f} ms a launch")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, failed = [], []
    for d in WIDTHS:
        mu = torch.randn((max(ROWS), d), generator=g, device=dev)
        var = torch.rand((max(ROWS), d), generator=g, device=dev) + 0.1
        gain = 1.0 + 0.1 * torch.randn(d, generator=g, device=dev)
        bias = 0.1 * torch.randn(d, generator=g, device=dev)
        plans = [pn.NormPlan(pn._threads(d, grp), grp) for grp in pn.GROUPS]
        plans = [p for p in plans if pn.plan_ok(p, d)]
        for norm in ("rmsnorm", "layernorm"):
            b = bias if norm == "layernorm" else None
            plain = (ref.pfp_rmsnorm_ref if norm == "rmsnorm"
                     else ref.pfp_layernorm_ref)
            for m in ROWS:
                x, v = mu[:m], var[:m]
                want = plain(x, v, gain) if b is None else plain(x, v, gain,
                                                                 b)
                row = {"norm": norm, "d": d, "rows": m, "ms": {},
                       "rule": list(pn.norm_plan(d))}
                for plan in plans:
                    def call():
                        return pn.pfp_norm_cuda(x, v, gain, b, norm=norm,
                                                plan=plan)
                    got = call()
                    torch.cuda.synchronize()
                    if not all(torch.allclose(a, w, **NORM_TOL)
                               for a, w in zip(got, want)):
                        failed.append(f"{norm} ({m}, {d}) plan {plan}")
                    row["ms"][str(tuple(plan))] = device_ms(call)
                rows.append(row)
                print(f"{norm:9s} ({m:4d}, {d:4d}) "
                      + "  ".join(f"{p} {ms:.4f}" for p, ms in
                                  row["ms"].items())
                      + f"  rule {tuple(row['rule'])}")
    for norm in ("rmsnorm", "layernorm"):
        for m in ROWS:
            mine = [r for r in rows if r["norm"] == norm and r["rows"] == m]
            rule = sum(r["ms"][str(tuple(r["rule"]))] for r in mine)
            best = sum(min(r["ms"].values()) for r in mine)
            print(f"{norm:9s} rows {m:4d}: norm_plan's plans {rule:.4f} ms "
                  f"summed over the widths, the fastest plan at each width "
                  f"{best:.4f}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "norm_plan_sweep.json").write_text(json.dumps(
        {"card": card.strip(), "floor_ms": floor, "rows": rows,
         "failed": failed}, indent=1))
    if failed:
        print(f"outside NORM_TOL of the plain version: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
