"""The registry's general contraction ``einsum`` against the JAX package.

The same numpy operands (x in SRM form or deterministic, w a Gaussian in
SRM form, made from a numpy seed) go through ``repro.core.pfp_layers.
pfp_einsum`` / ``repro.core.dispatch`` and the port:

  * the ``eager`` impl against the reference's ``pfp_einsum`` on dense,
    batched, depthwise and one unlisted spec, both formulations and a
    deterministic x (Eq. 13);
  * the ``kernel`` impl's routes: dense-shaped specs onto the dense kernel,
    'bmk,bkn->bmn' onto the batched dense kernel and the depthwise taps
    'wbtr,wr->btr' lifted onto the batched dense kernel (R channels as R
    experts of a (B*T, W) x (W, 1) product), each against the reference's
    kernel impl (``_dense_kernel``, ``_dense_batched_kernel`` and
    ``_depthwise_kernel``: the Pallas kernels in interpret mode). On the
    CPU the port's kernel impl runs each kernel's plain version;
  * an unlisted spec runs eagerly under ``kernel`` and counts one fallback.

Tolerance as tests/test_moe.py's op level: mean atol 1e-5, var atol 1e-4,
rtol 0.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dispatch
from repro_torch.core.gaussian import SRM, GaussianTensor
from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts

MEAN_TOL = dict(rtol=0.0, atol=1e-5)
VAR_TOL = dict(rtol=0.0, atol=1e-4)
# spec -> (x shape, w shape)
SPECS = {
    "btk,kn->btn": ((2, 5, 24), (24, 9)),
    "ecd,edf->ecf": ((3, 7, 20), (3, 20, 6)),
    "wbtr,wr->btr": ((4, 2, 13, 10), (4, 10)),
    "bthd,hd->bth": ((2, 3, 4, 8), (4, 8)),   # no kernel: eager
}
KERNEL_SPECS = ("btk,kn->btn", "ecd,edf->ecf", "wbtr,wr->btr")


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import dispatch as jdispatch
    from repro.core import pfp_layers as jlayers
    from repro.core.gaussian import SRM as JSRM
    from repro.core.gaussian import GaussianTensor as JGaussian
    return dict(jnp=jnp, dispatch=jdispatch, layers=jlayers, SRM=JSRM,
                G=JGaussian)


def _operands(spec, seed=0):
    """x (mean, srm), w (mean, srm) as numpy, SRM = mean^2 + a variance."""
    xs, ws = SPECS[spec]
    rng = np.random.default_rng(seed)
    xm = rng.normal(size=xs).astype(np.float32)
    xv = (0.1 * rng.random(xs)).astype(np.float32)
    wm = (rng.normal(size=ws) / np.sqrt(ws[-2] if len(ws) > 1 else 1)
          ).astype(np.float32)
    wv = (0.01 * rng.random(ws)).astype(np.float32)
    return (xm, xv + xm * xm), (wm, wv + wm * wm)


def _port(pair):
    return GaussianTensor(torch.from_numpy(pair[0]),
                          torch.from_numpy(pair[1]), SRM)


def _ref(jax_ref, pair):
    jnp = jax_ref["jnp"]
    return jax_ref["G"](jnp.asarray(pair[0]), jnp.asarray(pair[1]),
                        jax_ref["SRM"])


def _check(got, want):
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               **MEAN_TOL)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var),
                               **VAR_TOL)


@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["gaussian", "deterministic"])
@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_eager_matches_reference(jax_ref, spec, formulation, deterministic):
    x, w = _operands(spec)
    if deterministic:
        got = dispatch.pfp_einsum(spec, torch.from_numpy(x[0]), _port(w),
                                  formulation=formulation, impl="eager")
        want = jax_ref["layers"].pfp_einsum(
            spec, jax_ref["jnp"].asarray(x[0]), _ref(jax_ref, w),
            formulation=formulation)
    else:
        got = dispatch.pfp_einsum(spec, _port(x), _port(w),
                                  formulation=formulation, impl="eager")
        want = jax_ref["layers"].pfp_einsum(
            spec, _ref(jax_ref, x).to_var() if formulation == "var"
            else _ref(jax_ref, x), _ref(jax_ref, w), formulation=formulation)
    _check(got, want)


@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("spec", KERNEL_SPECS)
def test_kernel_routes_match_reference_kernels(jax_ref, spec, formulation):
    """Each route of the kernel impl against the reference's own kernel
    path: the dense, batched and depthwise lifts onto its Pallas kernels."""
    x, w = _operands(spec, seed=1)
    jd = jax_ref["dispatch"]
    jx, jw = _ref(jax_ref, x), _ref(jax_ref, w)
    jx = jx.to_var() if formulation == "var" else jx
    want = {"btk,kn->btn": jd._dense_kernel,
            "ecd,edf->ecf": jd._dense_batched_kernel,
            "wbtr,wr->btr": jd._depthwise_kernel}[spec](jx, jw, formulation)
    reset_launch_counts()
    dispatch.reset_fallbacks()
    got = dispatch.pfp_einsum(spec, _port(x), _port(w),
                              formulation=formulation, impl="kernel")
    _check(got, want)
    assert dispatch.FALLBACKS == {}
    assert all(v == 0 for v in LAUNCHES.values())  # CPU: plain versions


def test_depthwise_lift_matches_the_direct_contraction():
    """The lift reshapes (W, B, T, R) taps into R experts of (B*T, W) and
    back: under ``kernel`` it gives the eager contraction at the op
    tolerance, both formulations and a deterministic x."""
    spec = "wbtr,wr->btr"
    x, w = _operands(spec, seed=2)
    for xin in (_port(x), torch.from_numpy(x[0])):
        for formulation in ("srm", "var"):
            kw = dict(formulation=formulation)
            got = dispatch.pfp_einsum(spec, xin, _port(w), impl="kernel", **kw)
            want = dispatch.pfp_einsum(spec, xin, _port(w), impl="eager",
                                       **kw)
            assert got.mean.shape == (2, 13, 10)
            torch.testing.assert_close(got.mean, want.mean, **MEAN_TOL)
            torch.testing.assert_close(got.var, want.var, **VAR_TOL)


def test_unlisted_spec_counts_one_fallback(jax_ref):
    spec = "bthd,hd->bth"
    x, w = _operands(spec, seed=3)
    dispatch.reset_fallbacks()
    got = dispatch.pfp_einsum(spec, _port(x), _port(w), impl="kernel")
    assert dispatch.FALLBACKS == {f"einsum:{spec}:srm": 1}
    _check(got, jax_ref["layers"].pfp_einsum(spec, _ref(jax_ref, x),
                                             _ref(jax_ref, w)))
    dispatch.reset_fallbacks()


def test_unknown_formulation_raises():
    x, w = _operands("btk,kn->btn")
    with pytest.raises(ValueError, match="formulation"):
        dispatch.pfp_einsum("btk,kn->btn", _port(x), _port(w),
                            formulation="exact")
