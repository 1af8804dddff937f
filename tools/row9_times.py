"""Time the attention kernel without a cache (row 9) in several trees.

Each tree is a directory holding ``src/repro_torch`` (``git archive <rev>
src/repro_torch | tar -x -C <dir>``, or a copy with the kernel edited, to
see what one part of it costs). All trees build at once, each into its
own ``build/``; then each is timed alone, in a child process, at four
causal / full shapes (B, H, Hkv, T, D): granite-8b's forward (4, 32, 8,
512, 128) causal and full, 64 sequences of 128 (many light blocks) and one
of 2048 (long blocks), with CUDA events around a CUDA graph of 10 calls
(median of 7 replays). One JSON line per tree; on the card:

    python3 tools/row9_times.py build/ab/parent build/ab/change
"""
import json
import subprocess
import sys
from pathlib import Path

SHAPES = ((4, 32, 8, 512, 128, True), (4, 32, 8, 512, 128, False),
          (64, 32, 8, 128, 128, True), (1, 32, 8, 2048, 128, True))


def _use(tree):
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch.kernels import _build
    _build.load()
    return _build


def child(tree):
    import torch
    _use(tree)
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    out = {"tree": tree}
    for b, h, hkv, t, d, causal in SHAPES:
        q = torch.randn((b, h, t, d), generator=g, device=dev)
        k, vm = (torch.randn((b, hkv, t, d), generator=g, device=dev)
                 for _ in range(2))
        vv = torch.randn((b, hkv, t, d), generator=g, device=dev).abs()

        def call():
            return ops.pfp_attention(q, k, vm, vv, scale=d ** -0.5,
                                     causal=causal)

        call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(10):
                call()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 10)
        out[f"{b}x{t} {'causal' if causal else 'full'}"] = sorted(times)[3]
    print(json.dumps(out))


def main(trees):
    builds = [subprocess.Popen([sys.executable, __file__, "--build", t])
              for t in trees]
    for proc in builds:
        proc.wait()
    failed = 0
    for tree in trees:
        run = subprocess.run([sys.executable, __file__, "--child", tree],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(f"{tree}: failed\n{run.stderr[-2000:]}", file=sys.stderr)
            failed += 1
        else:
            print(run.stdout.strip().splitlines()[-1], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--build"]:
        print(sys.argv[2], "built in",
              f"{_use(sys.argv[2]).BUILD_INFO['seconds']:.1f} s")
    elif sys.argv[1:2] == ["--child"]:
        child(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
