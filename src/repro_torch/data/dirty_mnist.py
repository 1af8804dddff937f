"""Procedurally-rendered Dirty-MNIST (paper §4): no dataset files needed.

The port's own copy of ``repro/data/dirty_mnist.py``. It uses numpy only,
so both packages make the same images from the same seed.

Three splits matching the paper's evaluation protocol:
  * clean      — synthetic 28x28 "digits": class-conditional glyphs rendered
                 from fixed stroke templates + noise (in-domain, low both
                 uncertainties).
  * ambiguous  — convex blends of two different-class glyphs (Ambiguous-
                 MNIST analogue: high aleatoric uncertainty).
  * ood        — structured textures (stripes/checkers/blobs) with digit-like
                 intensity statistics (Fashion-MNIST analogue: epistemic).

The generator is deterministic given a seed, fast (numpy only), and the
training set is clean+ambiguous (the paper trains on MNIST+Ambiguous and
holds out the OOD set).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

_GRID = 28

# 5x7 bitmap font for digits 0-9 (classic LCD-style strokes).
_FONT = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],
    3: ["11110", "00001", "00001", "01110", "00001", "00001", "11110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _glyph(digit: int) -> np.ndarray:
    rows = _FONT[digit]
    g = np.array([[float(c) for c in r] for r in rows], np.float32)
    return g


def _render(digit: int, rng: np.random.Generator) -> np.ndarray:
    """Upscale the glyph with random placement/scale/shear + blur + noise."""
    g = _glyph(digit)
    scale = rng.uniform(2.6, 3.4)
    h, w = int(7 * scale), int(5 * scale)
    ys = (np.arange(h) / scale).astype(int).clip(0, 6)
    xs = (np.arange(w) / scale).astype(int).clip(0, 4)
    big = g[np.ix_(ys, xs)]
    shear = rng.uniform(-0.15, 0.15)
    out = np.zeros((_GRID, _GRID), np.float32)
    oy = rng.integers(0, _GRID - h + 1)
    ox = rng.integers(0, _GRID - w + 1)
    for r in range(h):
        shift = int(round(shear * (r - h / 2)))
        x0 = np.clip(ox + shift, 0, _GRID - w)
        out[oy + r, x0 : x0 + w] = np.maximum(out[oy + r, x0 : x0 + w], big[r])
    # cheap blur
    k = np.array([0.25, 0.5, 0.25], np.float32)
    out = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), 0, out)
    out = np.apply_along_axis(lambda m: np.convolve(m, k, "same"), 1, out)
    out = out + rng.normal(0, 0.05, out.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0)


def make_clean(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n)
    imgs = np.stack([_render(int(c), rng) for c in labels])
    return imgs.astype(np.float32), labels.astype(np.int32)


def make_ambiguous(n: int, seed: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Blends of two digits; label = the dominant component (soft truth)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 10, n)
    off = rng.integers(1, 10, n)
    b = (a + off) % 10
    w = rng.uniform(0.35, 0.65, n).astype(np.float32)
    imgs = np.stack([
        np.clip(wi * _render(int(ai), rng) + (1 - wi) * _render(int(bi), rng),
                0, 1)
        for ai, bi, wi in zip(a, b, w)
    ])
    labels = np.where(w >= 0.5, a, b)
    return imgs.astype(np.float32), labels.astype(np.int32)


def make_ood(n: int, seed: int = 2) -> np.ndarray:
    """Texture images (stripes / checker / blobs) — the Fashion-MNIST role."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, _GRID, _GRID), np.float32)
    yy, xx = np.meshgrid(np.arange(_GRID), np.arange(_GRID), indexing="ij")
    for i in range(n):
        kind = rng.integers(0, 3)
        if kind == 0:   # stripes
            f = rng.uniform(0.3, 1.5)
            th = rng.uniform(0, np.pi)
            out[i] = 0.5 + 0.5 * np.sin(f * (np.cos(th) * xx + np.sin(th) * yy))
        elif kind == 1:  # checker
            s = rng.integers(2, 6)
            out[i] = ((yy // s + xx // s) % 2).astype(np.float32)
        else:            # blobs
            img = rng.normal(0, 1, (_GRID, _GRID))
            k = np.ones(5, np.float32) / 5
            for ax in (0, 1):
                img = np.apply_along_axis(
                    lambda m: np.convolve(m, k, "same"), ax, img)
            img = (img - img.min()) / (np.ptp(img) + 1e-9)
            out[i] = img
        out[i] += rng.normal(0, 0.05, (_GRID, _GRID))
    return np.clip(out, 0, 1).astype(np.float32)


def dirty_mnist(n_train: int = 4000, n_eval: int = 1000, seed: int = 0):
    """Returns the paper's dataset structure.

    train: clean+ambiguous mixture with labels;
    eval:  dict of {clean, ambiguous, ood} splits.
    """
    xc, yc = make_clean(n_train // 2, seed)
    xa, ya = make_ambiguous(n_train // 2, seed + 1)
    x_train = np.concatenate([xc, xa])
    y_train = np.concatenate([yc, ya])
    perm = np.random.default_rng(seed + 2).permutation(len(x_train))
    x_train, y_train = x_train[perm], y_train[perm]

    ec, lc = make_clean(n_eval, seed + 10)
    ea, la = make_ambiguous(n_eval, seed + 11)
    eo = make_ood(n_eval, seed + 12)
    return (x_train, y_train), {
        "clean": (ec, lc), "ambiguous": (ea, la), "ood": (eo, None)}


def batches(x, y, batch_size: int, *, seed: int = 0, epochs: int = 1):
    """Deterministic, step-indexed batch iterator (restart-reproducible)."""
    n = len(x)
    for e in range(epochs):
        perm = np.random.default_rng(seed + e).permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            idx = perm[i : i + batch_size]
            yield x[idx], (y[idx] if y is not None else None)
