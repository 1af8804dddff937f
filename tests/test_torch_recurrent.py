"""The RG-LRU recurrent block (``nn/recurrent.py``) against the JAX package.

One JAX init of the block (d_model 24, d_rnn 16, conv width 4; sigma_init
0.02), raw for DETERMINISTIC and converted with calibration factor 0.4 for
PFP, is carried across with ``load_numpy_params`` (the Bayesian ``conv_w``
and the plain ``lam`` included). The same numpy inputs, made from a seed,
go through ``repro.nn.recurrent.rglru_block_apply`` (``impl="xla"``, and
``impl="kernel"``: the Pallas kernels in interpret mode) and the port's,
under both port impls and both formulations, without and with a carried
state (random, so that the carry matters), at T 13 and 1 (neither a power
of two, and a decode step). Outputs and the new state at rtol 1e-4 / atol
1e-5 (means) and rtol 1e-3 / atol 1e-6 (variances): the port's doubling
scan adds in another order than ``jax.lax.associative_scan``. The scan
itself is held to ``associative_scan`` at T 1, 5, 13 and 64, with and
without an initial state, at rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.gaussian import VAR, GaussianTensor
from repro_torch.core.modes import Mode
from repro_torch.nn import recurrent
from repro_torch.nn.module import Context, load_numpy_params

D, R, SIGMA, CAL = 24, 16, 0.02, 0.4
MEAN_TOL = dict(rtol=1e-4, atol=1e-5)
VAR_TOL = dict(rtol=1e-3, atol=1e-6)
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.bayes.convert import svi_to_pfp
    from repro.core.gaussian import VAR as JVAR
    from repro.core.gaussian import GaussianTensor as JGaussian
    from repro.core.modes import Mode as JMode
    from repro.nn import recurrent as jrec
    from repro.nn.module import Context as JContext
    raw = jrec.rglru_init(jax.random.PRNGKey(0), D, R, sigma_init=SIGMA)
    pfp = svi_to_pfp(raw, calibration_factor=CAL)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(jax=jax, jnp=jnp, rec=jrec, G=JGaussian, VAR=JVAR,
                Mode=JMode, Context=JContext, raw=raw, pfp=pfp,
                trees={"det": tree(raw), "pfp": tree(pfp)})


def _block(jax_ref, kind):
    return load_numpy_params(recurrent.RGLRU(D, R, device="cpu"),
                             jax_ref["trees"][kind])


def _inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(2, t, D)).astype(np.float32)
    var = (0.05 * rng.random((2, t, D))).astype(np.float32)
    return mean, var


def _state(seed=1):
    """A carried state: (h_mean, h_var, conv_mean, conv_srm)."""
    rng = np.random.default_rng(seed)
    h_mean = rng.normal(size=(2, R)).astype(np.float32)
    h_var = (0.05 * rng.random((2, R))).astype(np.float32)
    conv_mean = rng.normal(size=(2, 3, R)).astype(np.float32)
    conv_srm = (conv_mean ** 2 + 0.05 * rng.random((2, 3, R))).astype(
        np.float32)
    return h_mean, h_var, conv_mean, conv_srm


def _run_ref(jax_ref, pfp, x, state, impl="xla", formulation="srm"):
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
    st = (None if state is None else jax_ref["rec"].RecurrentState(
        *(jnp.asarray(a) for a in state)))
    return jax_ref["rec"].rglru_block_apply(params, xin, ctx, state=st)


def _run_port(block, pfp, x, state, impl="eager", formulation="srm"):
    if pfp:
        xin = GaussianTensor(torch.from_numpy(x[0]), torch.from_numpy(x[1]),
                             VAR)
        ctx = Context(mode=Mode.PFP, impl=impl, formulation=formulation,
                      device="cpu")
    else:
        xin = torch.from_numpy(x[0])
        ctx = Context(mode=Mode.DETERMINISTIC, device="cpu")
    st = (None if state is None else recurrent.RecurrentState(
        *(torch.from_numpy(a) for a in state)))
    return recurrent.rglru_block_apply(block, xin, ctx, state=st)


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
        for name in recurrent.RecurrentState._fields:
            tol = VAR_TOL if name in ("h_var", "conv_srm") else MEAN_TOL
            _close(getattr(st, name), getattr(wst, name), tol, name)


@pytest.mark.parametrize("t", [13, 1])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_deterministic_matches_reference(jax_ref, t, carried):
    state = _state() if carried else None
    x = _inputs(t)
    _compare(_run_port(_block(jax_ref, "det"), False, x, state),
             _run_ref(jax_ref, False, x, state), pfp=False)


@pytest.mark.parametrize("t", [13, 1])
@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_pfp_matches_reference(jax_ref, impl, formulation, carried, t):
    """The port's eager impl against the reference's xla impl, its kernel
    impl (the depthwise conv lifted onto row 12's plain version) against
    the reference's kernel impl (the Pallas kernels in interpret mode)."""
    state = _state() if carried else None
    x = _inputs(t)
    want = _run_ref(jax_ref, True, x, state,
                    impl="xla" if impl == "eager" else "kernel",
                    formulation=formulation)
    got = _run_port(_block(jax_ref, "pfp"), True, x, state, impl=impl,
                    formulation=formulation)
    _compare(got, want, pfp=True)


@pytest.mark.parametrize("t", [1, 5, 13, 64])
@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
def test_scan_matches_associative_scan(jax_ref, t, h0):
    rng = np.random.default_rng(t)
    a = rng.uniform(0.5, 1.0, size=(3, t, 7)).astype(np.float32)
    u = rng.normal(size=(3, t, 7)).astype(np.float32)
    h = rng.normal(size=(3, 7)).astype(np.float32) if h0 else None
    jnp = jax_ref["jnp"]
    want = jax_ref["rec"]._linear_scan(
        jnp.asarray(a), jnp.asarray(u), None if h is None else jnp.asarray(h))
    got = recurrent._linear_scan(torch.from_numpy(a), torch.from_numpy(u),
                                 None if h is None else torch.from_numpy(h))
    _close(got, want, SCAN_TOL, "scan")
    # and the sequential recurrence it computes
    seq, prev = [], (np.zeros((3, 7), np.float32) if h is None else h)
    for i in range(t):
        prev = a[:, i] * prev + u[:, i]
        seq.append(prev)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), **SCAN_TOL)


def test_init_state_and_leaves(jax_ref):
    st = recurrent.init_recurrent_state(3, R, device="cpu")
    want = jax_ref["rec"].init_recurrent_state(3, R)
    for a, b in zip(st, want):
        assert tuple(a.shape) == tuple(b.shape) and not a.any()
    block = _block(jax_ref, "pfp")
    np.testing.assert_array_equal(block.lam.numpy(),
                                  jax_ref["trees"]["pfp"]["lam"])
    assert set(block.conv_w.keys()) == {"mu", "srm"}
