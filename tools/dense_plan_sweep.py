"""Time the dense kernel under each plan that could serve a shape, on a card.

The numbers that ``kernels/pfp_dense.py``'s ``dense_plan`` rule is chosen
from. For each shape it times the plan the rule picks and its rivals:

  * the paper's dense shapes (LeNet-5 and the MLP) at batch 10, 100 and
    1024, Eq. 12 (Eq. 13 for the two first layers), and (B, 64, 128), the
    gate projection of the reduced LM configs: every K split from 1 to 8
    that leaves no rank without K, at TM 1 and 4, on the narrow tile that
    holds all of N;
  * granite-8b's decode shapes (4, K, N) and deepseek-moe-16b's expert
    shapes at a 4-slot step (E 64, C 6): every instantiated ring tile with
    one row per thread whose thread rows cover M;
  * the large regime, Eq. 12 and Eq. 7: granite-8b's forward shapes at
    M 2048 (4 x 512 tokens) and its paged prefill's chunks of 128 rows,
    and deepseek-moe-16b's expert shapes at 4 x 512 tokens (E 64, C 240):
    every wide tile (tn 8) and, as rivals with more blocks, the
    interleaved (64, 4) ring tiles at TM 1 and 4.

Each time is the median of 5 replays of a CUDA graph of 10 calls (of 2
replays of 2 calls above 1e11 operations), between CUDA events, operands
hot in L2 where they fit. Usage, on the card::

    python3 tools/dense_plan_sweep.py

Rows go to stdout and, in full, to ``chiprun_out/dense_plan_sweep.json``.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
INNER, REPLAYS = 10, 5


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
        print("dense_plan_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import pfp_dense as pd
    from repro_torch.kernels.pfp_moe import pfp_dense_batched_cuda
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=dev)

    rows = []

    def run(label, shape, mode, plans, launch, big=False):
        chosen = pd.dense_plan(*shape, mode=mode)
        for plan in dict.fromkeys([chosen] + plans):
            ms = (device_ms(lambda: launch(plan), 2, 2) if big
                  else device_ms(lambda: launch(plan)))
            rows.append({"shape": label, "mode": mode, "plan": list(plan),
                         "chosen": plan == chosen, "ms": ms})
            print(f"{label:28s} mode {mode} {str(tuple(plan)):22s} "
                  f"{'*' if plan == chosen else ' '} {ms:.4f} ms")

    for b in (10, 100, 1024):
        for m, k, n, mode in ((784 * b, 25, 6, 1), (196 * b, 150, 16, 0),
                              (b, 784, 120, 0), (b, 120, 84, 0),
                              (b, 84, 10, 0), (b, 784, 100, 1),
                              (b, 100, 100, 0), (b, 100, 10, 0),
                              (b, 64, 128, 0)):
            xa, xb = draw(m, k), draw(m, k).abs()
            wa, wb = draw(k, n, scale=0.1), draw(k, n, scale=0.1).abs()
            bn, tn = next(t for t in pd._NARROW if t[0] >= n)
            # Splits that leave every rank some K (ranges of whole tiles).
            splits = [s for s in range(1, pd.MAX_SPLIT + 1)
                      if (s - 1) * (-(-k // s) + 15) // 16 * 16 < k]
            plans = [pd.DensePlan(s, bn, tn, tm, pd.RING_STAGES)
                     for s in splits for tm in (1, 4)]
            run(str((m, k, n)), (m, n, k), mode, plans,
                lambda p: pd.pfp_dense_cuda(xa, xb, wa, wb, mode=mode,
                                            plan=p))
            del xa, xb, wa, wb
    decode = [(1, 4, 4096, n) for n in (4096, 1024, 14336, 49152)]
    decode += [(1, 4, 14336, 4096), (64, 6, 2048, 1408), (64, 6, 1408, 2048)]
    for e, m, k, n in decode:
        xa, xb = draw(e, m, k), draw(e, m, k).abs()
        wa, wb = draw(e, k, n, scale=0.1), draw(e, k, n, scale=0.1).abs()
        plans = [pd.DensePlan(1, bn, tn, 1, st) for bn, tn, tm, st in pd.TILES
                 if tm == 1 and st > 1 and pd.thread_rows(bn, tn) >= m]
        if e == 1:
            launch = (lambda p: pd.pfp_dense_cuda(
                xa[0], xb[0], wa[0], wb[0], mode=0, plan=p))
        else:
            launch = (lambda p: pfp_dense_batched_cuda(
                xa, xb, wa, wb, mode=0, plan=p))
        run(str((e, m, k, n)), (m, n, k, e), 0, plans, launch)
        del xa, xb, wa, wb
    large = [(1, m, k, n) for m in (2048, 128)
             for k, n in ((4096, 4096), (4096, 1024), (4096, 14336),
                          (14336, 4096), (4096, 49152))]
    large += [(64, 240, 2048, 1408), (64, 240, 1408, 2048)]
    plans = [pd.DensePlan(1, bn, tn, tm, st) for bn, tn, tm, st in pd.TILES
             if tn == 8]
    plans += [pd.DensePlan(1, 64, 4, tm, pd.RING_STAGES) for tm in (4, 1)]
    for e, m, k, n in large:
        xa, xb = draw(e, m, k), draw(e, m, k).abs()
        wa, wb = draw(e, k, n, scale=0.1), draw(e, k, n, scale=0.1).abs()
        big = 6 * e * m * k * n > 1e11
        for mode in (0, 2):
            if e == 1:
                launch = (lambda p: pd.pfp_dense_cuda(
                    xa[0], xb[0], wa[0], wb[0], mode=mode, plan=p))
            else:
                launch = (lambda p: pfp_dense_batched_cuda(
                    xa, xb, wa, wb, mode=mode, plan=p))
            run(str((e, m, k, n)), (m, n, k, e), mode, plans, launch, big)
        del xa, xb, wa, wb
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "dense_plan_sweep.json").write_text(json.dumps(
        {"card": card.strip(), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
