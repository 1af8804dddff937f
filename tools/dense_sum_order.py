"""Emulate the dense kernel's fp32 summation order on the CPU.

Row 1 (Eq. 12) sums each output's K terms in one fmaf chain, or in S
chains over contiguous K ranges of whole 16-k tiles whose sums are then
added in range order (``kernels/pfp_dense.py`` ``split_k``). This script
rebuilds that order in numpy, each fmaf rounded to fp32 from an exact
fp64 product, on ``chip_smoke.operands``-like inputs (unit Gaussians,
weights scaled by 0.1, second moments var + mu^2, from a seed), and
prints the (mean, var) error from an fp64 product in units of
u sqrt(K) sum|products| (u = 2^-24), the unit ``chip_smoke.long_k_check``
uses, for S = 1, 4 and 8 and for the plain product on inputs rounded to
TF32 and to bf16. Usage::

    python3 tools/dense_sum_order.py [M K N]     # default 4 14336 256

It needs no card; at the default shape it takes about 10 s.
"""
import sys

import numpy as np
import torch

U = 2.0 ** -24


def operands(m, k, n, seed=900):
    g = torch.Generator().manual_seed(seed)
    mx = torch.randn((m, k), generator=g)
    vx = torch.nn.functional.softplus(torch.randn((m, k), generator=g))
    g = torch.Generator().manual_seed(seed + 1)
    mw = 0.1 * torch.randn((k, n), generator=g)
    vw = 0.1 * torch.nn.functional.softplus(torch.randn((k, n), generator=g))
    return [t.double().numpy() for t in (mx, vx + mx * mx, mw, vw + mw * mw)]


def f32(x):
    return x.astype(np.float32).astype(np.float64)


def chains(mx, sx, mw, sw, split):
    """The kernel's order: per range, acc = fmaf(a, w, acc) for the mean
    and acc = fmaf(srm_x, srm_w, acc), fmaf(-mu_x^2, mu_w^2, acc) for the
    variance; the range sums added in order."""
    k = mx.shape[1]
    chunk = -(-(-(-k // split)) // 16) * 16
    total = None
    for r in range(split):
        lo, hi = min(k, r * chunk), min(k, (r + 1) * chunk)
        mean = np.zeros((mx.shape[0], mw.shape[1]))
        var = np.zeros_like(mean)
        for j in range(lo, hi):
            a, b = mx[:, j:j + 1], sx[:, j:j + 1]
            w, v = mw[j:j + 1], sw[j:j + 1]
            mean = f32(mean + a * w)
            var = f32(var + b * v)
            var = f32(var - f32(a * a) * f32(w * w))
        total = (mean, var) if total is None else (
            f32(total[0] + mean), f32(total[1] + var))
    return total


def rounded(x, bits):
    """fp32 values rounded to ``bits`` explicit mantissa bits."""
    mant, exp = np.frexp(x)
    scale = 2.0 ** (bits + 1)
    return np.ldexp(np.round(mant * scale) / scale, exp)


def main(argv):
    m, k, n = (int(a) for a in argv) if argv else (4, 14336, 256)
    mx, sx, mw, sw = operands(m, k, n)
    exact = (mx @ mw, sx @ sw - (mx * mx) @ (mw * mw))
    unit = U * np.sqrt(k)
    scale = (unit * (np.abs(mx) @ np.abs(mw)),
             unit * (sx @ sw + (mx * mx) @ (mw * mw)))

    def show(name, got):
        errs = [float((np.abs(g - x) / a).max())
                for g, x, a in zip(got, exact, scale)]
        print(f"{(m, k, n)} {name:9s} mean {errs[0]:.4f} var {errs[1]:.4f}",
              flush=True)

    for split in (1, 4, 8):
        show(f"chains {split}", chains(mx, sx, mw, sw, split))
    for name, bits in (("tf32", 10), ("bf16", 7)):
        q = [rounded(t, bits) for t in (mx, sx, mw, sw)]
        show(name, (q[0] @ q[2], q[1] @ q[3] - (q[0] ** 2) @ (q[2] ** 2)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
