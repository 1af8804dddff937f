"""The port's four kernels against the JAX package's Pallas kernels.

On the CPU each wrapper of ``repro_torch.kernels.ops`` runs its kernel's
plain version; here it is held against ``repro.kernels.ops.<op>(...,
impl="kernel")``, the Pallas kernel in interpret mode, on ragged shapes.
Tolerances are the reference's own (tests/test_kernels.py): dense rtol
1e-5 / atol 1e-4, activation and max pool rtol 1e-5 / atol 1e-5.

The tests marked ``gpu`` hold each CUDA kernel against its plain version
on the card and skip where there is none. JAX is imported only by the
tests that need it, so this file also runs on a machine without it:
``python -m pytest -m gpu tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels._launch import LAUNCHES

DENSE_TOL = dict(rtol=1e-5, atol=1e-4)
ELEMENTWISE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jops():
    pytest.importorskip("jax")
    from repro.kernels import ops as jax_ops
    return jax_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pair(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    mu = (scale * rng.normal(size=shape)).astype(np.float32)
    var = (scale * np.log1p(np.exp(rng.normal(size=shape)))).astype(np.float32)
    return mu, var


def _dense_operands(m, k, n, seed, form):
    """(x_a, x_b, w_a, w_b) as numpy for one dense formulation."""
    mx, vx = _pair((m, k), seed)
    mw, vw = _pair((k, n), seed + 1, 0.1)
    if form == "srm":
        return mx, vx + mx ** 2, mw, vw + mw ** 2
    if form == "var":
        return mx, vx, mw, vw
    return mx, mx, mw, vw                     # first layer: (x, x, mu_w, var_w)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.cpu() if isinstance(
            g, torch.Tensor) else g), np.asarray(w), **tol)


def _port_dense(form, *args):
    if form == "var":
        return ops.pfp_dense_var(*args)
    return ops.pfp_dense(*args, first_layer=form == "first_layer")


DENSE_SHAPES = [
    (33, 100, 53),      # nothing aligned
    (100, 784, 100),    # MLP dense0 at batch 100
    (392, 150, 16),     # LeNet conv1 im2col at batch 2
    (7, 25, 6),         # LeNet conv0 im2col width
]


@pytest.mark.parametrize("form", ["srm", "first_layer", "var"])
@pytest.mark.parametrize("m,k,n", DENSE_SHAPES)
def test_dense_matches_pallas_kernel(jops, form, m, k, n):
    args = _dense_operands(m, k, n, m * k + n, form)
    got = _port_dense(form, *map(torch.from_numpy, args))
    if form == "var":
        want = jops.pfp_dense_var(*args, impl="kernel")
    else:
        want = jops.pfp_dense(*args, impl="kernel",
                              first_layer=form == "first_layer")
    _close(got, want, DENSE_TOL)


def test_dense_flattens_leading_dims(jops):
    mx, vx = _pair((2, 5, 33), 7)
    mw, vw = _pair((33, 12), 8, 0.1)
    args = (mx, vx + mx ** 2, mw, vw + mw ** 2)
    got = ops.pfp_dense(*map(torch.from_numpy, args))
    want = jops.pfp_dense(*args, impl="kernel")
    assert tuple(got[0].shape) == (2, 5, 12)
    _close(got, want, DENSE_TOL)


@pytest.mark.parametrize("kind", ["relu", "gelu", "silu", "tanh", "sigmoid"])
def test_activation_matches_pallas_kernel(jops, kind):
    mu, var = _pair((3, 37, 70), 11)
    var[0, ::3] = 0.0                          # ReLU's point-mass branch
    got = ops.pfp_activation(torch.from_numpy(mu), torch.from_numpy(var),
                             kind=kind)
    want = jops.pfp_activation(mu, var, kind=kind, impl="kernel")
    _close(got, want, ELEMENTWISE_TOL)


@pytest.mark.parametrize("shape", [(2, 6, 10, 5), (1, 28, 28, 6), (3, 14, 4, 16)])
def test_maxpool_matches_pallas_kernel(jops, shape):
    mu, var = _pair(shape, 13)
    var[0, 0, :2] = 0.0                        # a deterministic window
    got = ops.pfp_maxpool2d(torch.from_numpy(mu), torch.from_numpy(var))
    want = jops.pfp_maxpool2d(mu, var, impl="kernel")
    _close(got, want, ELEMENTWISE_TOL)


def test_cpu_tensors_run_the_plain_versions():
    """The CPU path is the plain version itself and launches nothing."""
    before = dict(LAUNCHES)
    args = [torch.from_numpy(a) for a in _dense_operands(9, 20, 7, 3, "srm")]
    got = ops.pfp_dense(*args)
    want = ref.pfp_dense_ref(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    mu, var = (torch.from_numpy(a) for a in _pair((2, 4, 6, 3), 5))
    assert all(torch.equal(g, w) for g, w in
               zip(ops.pfp_maxpool2d(mu, var), ref.pfp_maxpool2d_ref(mu, var)))
    assert all(torch.equal(g, w) for g, w in
               zip(ops.pfp_activation(mu, var), ref.pfp_relu_ref(mu, var)))
    assert LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("form", ["srm", "first_layer", "var"])
@pytest.mark.parametrize("m,k,n", DENSE_SHAPES + [(78400, 25, 6),
                                                  (100, 120, 84)])
def test_dense_kernel_matches_plain_on_card(cuda, form, m, k, n):
    args = [torch.from_numpy(a).to(cuda)
            for a in _dense_operands(m, k, n, m + k + n, form)]
    counter = {"srm": "dense", "var": "dense_var",
               "first_layer": "dense_first_layer"}[form]
    before = LAUNCHES[counter]
    got = _port_dense(form, *args)
    torch.cuda.synchronize()
    if form == "var":
        want = ref.pfp_dense_var_ref(*args)
    elif form == "first_layer":
        want = ref.pfp_dense_first_layer_ref(args[0], args[2], args[3])
    else:
        want = ref.pfp_dense_ref(*args)
    _close(got, [w.cpu() for w in want], DENSE_TOL)
    assert LAUNCHES[counter] == before + 1


@pytest.mark.gpu
def test_dense_kernel_eq12_cancellation_on_card(cuda):
    """srm ~= mu^2: the variance is a small difference of two large sums.
    The kernel's error against fp64 must be no worse than 4x that of the
    fp32 plain version (TF32 would be ~1000x worse)."""
    g = torch.Generator().manual_seed(0)
    mx = torch.relu(torch.randn((100, 784), generator=g)) + 0.1
    mw = 0.05 * torch.randn((784, 100), generator=g)
    sx = mx * mx + 1e-6 * torch.rand((100, 784), generator=g)
    sw = mw * mw + 4e-7
    mx, sx, mw, sw = (a.to(cuda) for a in (mx, sx, mw, sw))
    _, var_k = ops.pfp_dense(mx, sx, mw, sw)
    _, var_p = ref.pfp_dense_ref(mx, sx, mw, sw)
    d = [a.double() for a in (mx, sx, mw, sw)]
    var_64 = d[1] @ d[3] - (d[0] * d[0]) @ (d[2] * d[2])
    err_k = float((var_k.double() - var_64).abs().max())
    err_p = float((var_p.double() - var_64).abs().max())
    assert err_k <= 4 * err_p, (err_k, err_p)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["relu", "gelu", "silu", "tanh", "sigmoid"])
def test_activation_kernel_matches_plain_on_card(cuda, kind):
    mu, var = (torch.from_numpy(a).to(cuda) for a in _pair((5, 28, 28, 6), 17))
    var[0] = 0.0
    before = LAUNCHES["activation"]
    got = ops.pfp_activation(mu, var, kind=kind)
    torch.cuda.synchronize()
    _close(got, [w.cpu() for w in ref.pfp_activation_ref(mu, var, kind)],
           ELEMENTWISE_TOL)
    assert LAUNCHES["activation"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(100, 28, 28, 6), (3, 14, 4, 16)])
def test_maxpool_kernel_matches_plain_on_card(cuda, shape):
    mu, var = (torch.from_numpy(a).to(cuda) for a in _pair(shape, 19))
    var[0, 0] = 0.0
    before = LAUNCHES["maxpool2d"]
    got = ops.pfp_maxpool2d(mu, var)
    torch.cuda.synchronize()
    _close(got, [w.cpu() for w in ref.pfp_maxpool2d_ref(mu, var)],
           ELEMENTWISE_TOL)
    assert LAUNCHES["maxpool2d"] == before + 1
