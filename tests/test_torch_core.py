"""The port's moment algebra and layer plumbing against the JAX reference.

Inputs come from numpy and go through ``repro.core`` and ``repro_torch.core``
alike; results are compared elementwise in fp32. Tolerances: elementwise
formulas rtol 1e-5 / atol 1e-5, the reference's own activation and
max-pool tolerance (Eq. 9 cancels to ~1e-6 in fp32 when mu << -sigma, and
the two frameworks' erf differ in the last bits there); dense contractions
rtol 1e-5 / atol 1e-4 (tests/test_kernels.py: the two frameworks sum in
different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pfp_layers as jlayers
from repro.core import pfp_math as jmath
from repro.core.gaussian import GaussianTensor as JGT
from repro_torch.core import pfp_layers, pfp_math
from repro_torch.core.gaussian import SRM, VAR, GaussianTensor

RNG_SEED = 1234


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _moments(shape, seed, var_scale=1.0):
    rng = np.random.default_rng(seed)
    mu = rng.normal(0.0, 2.0, shape).astype(np.float32)
    var = (var_scale * rng.gamma(1.0, 1.0, shape)).astype(np.float32)
    return mu, var


def test_relu_moments_match_reference_including_point_mass():
    mu, var = _moments((64, 33), RNG_SEED)
    # Every fourth element a point mass, on both sides of the threshold.
    var[::4] = 0.0
    var[1::8] = 1e-13
    var[2::8] = 1e-12
    got = pfp_math.relu_moments(torch.from_numpy(mu), torch.from_numpy(var))
    want = jmath.relu_moments(jnp.asarray(mu), jnp.asarray(var))
    for g, w in zip(got, want):
        _close(g, w)
    det = var <= 1e-12
    np.testing.assert_array_equal(got[0].numpy()[det], np.maximum(mu, 0)[det])


def test_clark_max_moments_match_reference_including_degenerate():
    ma, va = _moments((50, 7), RNG_SEED + 1)
    mb, vb = _moments((50, 7), RNG_SEED + 2)
    va[::3], vb[::3] = 0.0, 0.0       # both deterministic
    va[1::3] = 0.0                    # one deterministic
    args = (ma, va, mb, vb)
    got = pfp_math.clark_max_moments(*map(torch.from_numpy, args))
    want = jmath.clark_max_moments(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["gelu", "silu", "tanh", "sigmoid"])
def test_gauss_hermite_moments_match_reference(kind):
    mu, var = _moments((40, 9), RNG_SEED + 3)
    var[::5] = 0.0
    got = getattr(pfp_math, f"{kind}_moments")(torch.from_numpy(mu),
                                               torch.from_numpy(var))
    want = getattr(jmath, f"{kind}_moments")(jnp.asarray(mu), jnp.asarray(var))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", ["srm", "var", "first_layer"])
def test_dense_moments_match_reference(form):
    mx, vx = _moments((9, 37), RNG_SEED + 4)
    mw, vw = _moments((37, 11), RNG_SEED + 5, var_scale=0.01)
    if form == "srm":
        args = (mx, vx + mx ** 2, mw, vw + mw ** 2)
    elif form == "var":
        args = (mx, vx, mw, vw)
    else:
        args = (mx, mw, vw)
    fn = f"dense_moments_{form}"
    got = getattr(pfp_math, fn)(*map(torch.from_numpy, args))
    want = getattr(jmath, fn)(*map(jnp.asarray, args))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-4)


def test_gaussian_rep_conversions_round_trip():
    mu, var = _moments((5, 6), RNG_SEED + 6)
    g = GaussianTensor(torch.from_numpy(mu), torch.from_numpy(var), VAR)
    s = g.to_srm()
    assert s.rep == SRM and g.to_var() is g and s.to_srm() is s
    _close(s.second, var + mu ** 2)
    _close(s.to_var().second, var, atol=1e-5)
    summed = g + s
    _close(summed.mean, 2 * mu)
    _close(summed.var, 2 * var, atol=1e-5)


@pytest.mark.parametrize("padding,shape,kernel", [
    ("SAME", (2, 8, 8, 3), (5, 5, 3, 4)),     # LeNet's 5x5 SAME, pad 2
    ("VALID", (1, 7, 9, 2), (3, 2, 2, 5)),    # ragged, even kernel width
    ("SAME", (1, 6, 5, 1), (2, 4, 1, 2)),     # asymmetric SAME padding
])
def test_im2col_feature_order_matches_reference(padding, shape, kernel):
    """Patches are channel-major (cin, kh, kw) and the HWIO weight is
    reshaped to match, as in repro/core/pfp_layers.py:208-209."""
    mu, var = _moments(shape, RNG_SEED + 7)
    wm, wv = _moments(kernel, RNG_SEED + 8)
    xp, w2 = pfp_layers.im2col(
        GaussianTensor(torch.from_numpy(mu), torch.from_numpy(var), VAR),
        GaussianTensor(torch.from_numpy(wm), torch.from_numpy(wv), VAR),
        padding=padding)
    jxp, jw2 = jlayers.im2col(JGT(jnp.asarray(mu), jnp.asarray(var), "var"),
                              JGT(jnp.asarray(wm), jnp.asarray(wv), "var"),
                              padding=padding)
    assert xp.rep == SRM and tuple(xp.shape) == tuple(jxp.shape)
    _close(xp.mean, jxp.mean)
    _close(xp.second, jxp.second, atol=1e-5)
    _close(w2.mean, jw2.mean)
    _close(w2.second, jw2.second)


@pytest.mark.parametrize("formulation", ["srm", "var"])
def test_eager_conv_and_maxpool_match_reference(formulation):
    mu, var = _moments((2, 6, 8, 3), RNG_SEED + 9, var_scale=0.1)
    wm, wv = _moments((5, 5, 3, 4), RNG_SEED + 10, var_scale=1e-3)
    wm *= 0.2
    x = GaussianTensor(torch.from_numpy(mu), torch.from_numpy(var), VAR)
    w = GaussianTensor(torch.from_numpy(wm), torch.from_numpy(wv), VAR)
    jx = JGT(jnp.asarray(mu), jnp.asarray(var), "var")
    jw = JGT(jnp.asarray(wm), jnp.asarray(wv), "var")
    x_in = x.to_srm() if formulation == "srm" else x
    jx_in = jx.to_srm() if formulation == "srm" else jx
    got = pfp_layers.pfp_conv2d_im2col(x_in, w, padding="SAME",
                                       formulation=formulation)
    want = jlayers.pfp_conv2d_im2col(jx_in, jw, padding="SAME",
                                     formulation=formulation)
    _close(got.mean, want.mean, rtol=1e-5, atol=1e-4)
    _close(got.var, want.var, rtol=1e-5, atol=1e-4)
    pooled = pfp_layers.pfp_maxpool2d(got)
    jpooled = jlayers.pfp_maxpool2d(want)
    _close(pooled.mean, jpooled.mean, rtol=1e-5, atol=1e-4)
    _close(pooled.var, jpooled.var, rtol=1e-5, atol=1e-4)
