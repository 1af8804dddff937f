"""The Mamba2 / SSD block (``nn/ssm.py``) against the JAX package.

One JAX init of the block (d_model 32, expand 2, heads of 16, state 8,
conv width 4; sigma_init 0.02), raw for DETERMINISTIC and converted with
calibration factor 0.4 for PFP, is carried across with
``load_numpy_params`` (the Bayesian ``conv_w`` and the plain ``a_log``,
``dt_bias``, ``d_skip`` and ``norm_g``). The same numpy inputs, made from a
seed, go through ``repro.nn.ssm.mamba2_apply`` (``impl="xla"``, and
``impl="kernel"``: the silu, GLU product and RMSNorm Pallas kernels in
interpret mode) and the port's, under both port impls and both
formulations, without and with a carried state (random), at T 24 in chunks
of 8 (three chunks: the inter-chunk pass) and T 1 (a decode step). A
sequence that is no multiple of the chunk raises, as in the reference.
Outputs and the new state at rtol 1e-4 / atol 1e-5 (means) and rtol 1e-3 /
atol 1e-6 (variances).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.gaussian import VAR, GaussianTensor
from repro_torch.core.modes import Mode
from repro_torch.nn import ssm
from repro_torch.nn.module import Context, load_numpy_params

D, N, P, EXPAND, SIGMA, CAL = 32, 8, 16, 2, 0.02, 0.4
DIMS = dict(d_state=N, expand=EXPAND, head_dim=P)
HEADS = EXPAND * D // P
MEAN_TOL = dict(rtol=1e-4, atol=1e-5)
VAR_TOL = dict(rtol=1e-3, atol=1e-6)


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.bayes.convert import svi_to_pfp
    from repro.core.gaussian import VAR as JVAR
    from repro.core.gaussian import GaussianTensor as JGaussian
    from repro.core.modes import Mode as JMode
    from repro.nn import ssm as jssm
    from repro.nn.module import Context as JContext
    raw = jssm.mamba2_init(jax.random.PRNGKey(0), D, sigma_init=SIGMA,
                           **DIMS)
    # dt_bias and d_skip away from their init (0 and 1), so both count.
    rng = np.random.default_rng(5)
    raw = dict(raw, dt_bias=jnp.asarray(rng.normal(size=HEADS), jnp.float32),
               d_skip=jnp.asarray(rng.uniform(0.5, 1.5, HEADS), jnp.float32),
               norm_g=jnp.asarray(rng.uniform(0.5, 1.5, 2 * D), jnp.float32))
    pfp = svi_to_pfp(raw, calibration_factor=CAL)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jax=jax, jnp=jnp, ssm=jssm, G=JGaussian, VAR=JVAR,
                Mode=JMode, Context=JContext, raw=raw, pfp=pfp,
                trees={"det": tree(raw), "pfp": tree(pfp)})


def _block(jax_ref, kind):
    return load_numpy_params(ssm.Mamba2(D, device="cpu", **DIMS),
                             jax_ref["trees"][kind])


def _inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(2, t, D)).astype(np.float32)
    var = (0.05 * rng.random((2, t, D))).astype(np.float32)
    return mean, var


def _state(seed=1):
    rng = np.random.default_rng(seed)
    s_mean = (0.3 * rng.normal(size=(2, HEADS, P, N))).astype(np.float32)
    s_var = (0.01 * rng.random((2, HEADS, P, N))).astype(np.float32)
    conv_mean = rng.normal(size=(2, 3, EXPAND * D + 2 * N)).astype(np.float32)
    conv_srm = (conv_mean ** 2 + 0.05 * rng.random(conv_mean.shape)).astype(
        np.float32)
    return s_mean, s_var, conv_mean, conv_srm


def _run_ref(jax_ref, pfp, x, state, chunk, impl="xla", formulation="srm"):
    jnp = jax_ref["jnp"]
    if pfp:
        xin = jax_ref["G"](jnp.asarray(x[0]), jnp.asarray(x[1]),
                           jax_ref["VAR"])
        ctx = jax_ref["Context"](mode=jax_ref["Mode"].PFP, impl=impl,
                                 formulation=formulation)
        params = jax_ref["pfp"]
    else:
        xin = jnp.asarray(x[0])
        ctx = jax_ref["Context"](mode=jax_ref["Mode"].DETERMINISTIC)
        params = jax_ref["raw"]
    st = (None if state is None else jax_ref["ssm"].SSMState(
        *(jnp.asarray(a) for a in state)))
    return jax_ref["ssm"].mamba2_apply(params, xin, ctx, chunk=chunk,
                                       state=st, **DIMS)


def _run_port(block, pfp, x, state, chunk, impl="eager", formulation="srm"):
    if pfp:
        xin = GaussianTensor(torch.from_numpy(x[0]), torch.from_numpy(x[1]),
                             VAR)
        ctx = Context(mode=Mode.PFP, impl=impl, formulation=formulation,
                      device="cpu")
    else:
        xin = torch.from_numpy(x[0])
        ctx = Context(mode=Mode.DETERMINISTIC, device="cpu")
    st = (None if state is None else ssm.SSMState(
        *(torch.from_numpy(a) for a in state)))
    return ssm.mamba2_apply(block, xin, ctx, chunk=chunk, state=st, **DIMS)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol,
                               err_msg=what)


def _compare(got, want, pfp):
    out, st = got
    wout, wst = want
    if pfp:
        _close(out.mean, wout.mean, MEAN_TOL, "mean")
        _close(out.var, wout.var, VAR_TOL, "var")
        assert float(out.var.min()) > 0
    else:
        _close(out, wout, MEAN_TOL, "out")
    assert (st is None) == (wst is None)
    if st is not None:
        for name in ssm.SSMState._fields:
            tol = VAR_TOL if name in ("s_var", "conv_srm") else MEAN_TOL
            _close(getattr(st, name), getattr(wst, name), tol, name)


SHAPES = {"t24": (24, 8), "t1": (1, 1)}   # (T, chunk)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_deterministic_matches_reference(jax_ref, shape, carried):
    t, chunk = SHAPES[shape]
    state = _state() if carried else None
    x = _inputs(t)
    _compare(_run_port(_block(jax_ref, "det"), False, x, state, chunk),
             _run_ref(jax_ref, False, x, state, chunk), pfp=False)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_pfp_matches_reference(jax_ref, impl, formulation, carried, shape):
    t, chunk = SHAPES[shape]
    state = _state() if carried else None
    x = _inputs(t)
    want = _run_ref(jax_ref, True, x, state, chunk,
                    impl="xla" if impl == "eager" else "kernel",
                    formulation=formulation)
    got = _run_port(_block(jax_ref, "pfp"), True, x, state, chunk,
                    impl=impl, formulation=formulation)
    _compare(got, want, pfp=True)


@pytest.mark.parametrize("pfp", [False, True], ids=["det", "pfp"])
def test_ragged_sequence_raises_as_reference(jax_ref, pfp):
    x = _inputs(20)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        _run_ref(jax_ref, pfp, x, None, 8)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        _run_port(_block(jax_ref, "pfp" if pfp else "det"), pfp, x, None, 8)


def test_init_state_and_leaves(jax_ref):
    st = ssm.init_ssm_state(3, D, device="cpu", **DIMS)
    want = jax_ref["ssm"].init_ssm_state(3, D, **DIMS)
    for a, b in zip(st, want):
        assert tuple(a.shape) == tuple(b.shape) and not a.any()
    block = _block(jax_ref, "pfp")
    tree = jax_ref["trees"]["pfp"]
    for name in ("a_log", "dt_bias", "d_skip", "norm_g"):
        np.testing.assert_array_equal(getattr(block, name).numpy(),
                                      tree[name])
    assert set(block.conv_w.keys()) == {"mu", "srm"}
