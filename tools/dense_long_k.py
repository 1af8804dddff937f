"""The dense kernel's error at long K against fp64, on a card.

For each shape (M, K, N), ``chip_smoke.long_k_errors`` runs row 1 (Eq.
12) on ``chip_smoke.operands`` (unit Gaussians, weights scaled by 0.1):
the kernel at its plan, the kernel with K unsplit (one fp32 chain a row),
the plain version (``kernels/ref.py``) and the plain version on operands
rounded to TF32 and to bf16, each held against an fp64 product. A line
gives each one's (mean, var) error in units of u sqrt(K) sum|products|
(u = 2^-24; ``chip_smoke.LONG_K_BOUND`` is the bound ``long_k_check``
holds split calls to), the plan and the kernel's distance from the plain
version in DENSE_TOL. The shapes are granite-8b's at K 4096 and at its
down projection's K 14336, musicgen-medium's at K 6144, at a decode
step's 4 rows, a verify pass's 16, a prefill chunk's 128 and a forward's
2048. Usage, on the card::

    python3 tools/dense_long_k.py

Lines go to stdout; the card's name and power limit come first.
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = ((4, 4096, 4096), (16, 4096, 4096), (16, 4096, 14336),
          (4, 6144, 1536), (4, 14336, 4096), (16, 14336, 4096),
          (128, 14336, 4096), (2048, 14336, 4096))


def main():
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("dense_long_k: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (IEEE fp32 for cuBLAS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    device = torch.device("cuda")
    for shape in SHAPES:
        e = cs.long_k_errors(device, shape, 123)
        parts = [f"{shape} plan {e['plan']}"]
        parts += [f"{name} {e[name][0]:.4f} / {e[name][1]:.4f}"
                  for name in ("kernel", "unsplit", "plain", "tf32", "bf16")]
        parts.append(f"kernel-plain {e['dense_tol']:.3f} DENSE_TOL")
        print(" | ".join(parts), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
