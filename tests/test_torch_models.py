"""MLP and LeNet-5 in the port against the JAX reference, end to end.

One JAX init per model (full width, sigma_init=1e-3, converted with
calibration factor 0.4) is carried across with ``load_numpy_params``;
the same numpy images (batch 4) go through both packages. The JAX side
runs ``impl="xla"``, whose equality with its Pallas kernels
tests/test_impl_dispatch.py pins. Tolerances are that file's model-level
ones: mean rtol 1e-3 / atol 1e-4, var rtol 1e-2 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bayes import metrics as jmetrics
from repro.bayes.convert import \
    fit_calibration_factor as jax_fit_calibration_factor
from repro.bayes.convert import svi_to_pfp as jax_svi_to_pfp
from repro.core.modes import Mode as JMode
from repro.models.simple import (lenet5_forward, lenet5_init, mlp_forward,
                                 mlp_init)
from repro.nn.module import Context as JContext
from repro_torch.bayes import metrics
from repro_torch.bayes.convert import fit_calibration_factor, svi_to_pfp
from repro_torch.core.modes import Mode
from repro_torch.models.simple import MLP, LeNet5
from repro_torch.nn.module import Context, load_numpy_params

KEY = jax.random.PRNGKey(0)
CAL = 0.4
MODELS = {
    "mlp": (mlp_init, mlp_forward, MLP, (4, 784)),
    "lenet5": (lenet5_init, lenet5_forward, LeNet5, (4, 28, 28, 1)),
}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setups():
    """name -> (variational tree, converted tree, images, JAX forward)."""
    out = {}
    for name, (init, forward, _, shape) in MODELS.items():
        params = init(KEY, sigma_init=1e-3)
        pfp = jax_svi_to_pfp(params, calibration_factor=CAL)
        x = np.random.default_rng(0).random(shape, dtype=np.float32)
        out[name] = (_numpy_tree(params), _numpy_tree(pfp), x, forward, pfp)
    return out


@pytest.fixture(scope="module")
def jax_logits(setups):
    cache = {}

    def get(name, mode, formulation="srm"):
        key = (name, mode, formulation)
        if key not in cache:
            _, _, x, forward, pfp = setups[name]
            out = forward(pfp, jnp.asarray(x),
                          JContext(mode=mode, impl="xla",
                                   formulation=formulation))
            cache[key] = (np.asarray(out.mean), np.asarray(out.var)) \
                if mode == JMode.PFP else np.asarray(out)
        return cache[key]

    return get


def _port_model(name, tree):
    return load_numpy_params(MODELS[name][2](device="cpu"), tree)


@pytest.mark.parametrize("impl", ["eager", "kernel"])
@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("name", list(MODELS))
def test_pfp_logits_match_reference(setups, jax_logits, name, formulation,
                                    impl):
    _, pfp_tree, x, _, _ = setups[name]
    model = _port_model(name, pfp_tree)
    out = model(x, Context(mode=Mode.PFP, formulation=formulation, impl=impl,
                           device="cpu"))
    want_mean, want_var = jax_logits(name, JMode.PFP, formulation)
    assert out.var.min() > 0
    np.testing.assert_allclose(out.mean.numpy(), want_mean, rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(out.var.numpy(), want_var, rtol=1e-2,
                               atol=1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_deterministic_logits_match_reference(setups, jax_logits, name):
    params_tree, _, x, _, _ = setups[name]
    model = _port_model(name, params_tree)
    out = model(x, Context(mode="deterministic", device="cpu"))
    np.testing.assert_allclose(out.numpy(), jax_logits(name, JMode.DETERMINISTIC),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("rep", ["srm", "var"])
def test_svi_to_pfp_matches_reference(setups, rep):
    params_tree = setups["lenet5"][0]
    model = _port_model("lenet5", params_tree)
    converted = svi_to_pfp(model, calibration_factor=CAL, rep=rep)
    want = jax_svi_to_pfp(params_tree, calibration_factor=CAL, rep=rep)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        flat[".".join(p.key for p in path)] = np.asarray(leaf)
    got = {k: v.numpy() for k, v in converted.named_parameters()}
    assert set(got) == set(flat)
    for k in flat:
        np.testing.assert_allclose(got[k], flat[k], rtol=1e-6, atol=0)
    # The source model keeps its variational leaves.
    assert {k.rsplit(".", 1)[1] for k, _ in model.named_parameters()} == {
        "mu", "rho"}


def test_fit_calibration_factor_matches_reference():
    scores = {0.1: 0.5, 0.3: 0.9, 0.4: 0.9, 1.0: 0.7}   # tie: first one wins
    got = fit_calibration_factor(scores.get, candidates=tuple(scores))
    assert got == jax_fit_calibration_factor(scores.get,
                                             candidates=tuple(scores))
    assert got == (0.3, 0.9)


def test_predictive_metrics_match_reference_on_shared_samples():
    rng = np.random.default_rng(3)
    samples = (3.0 * rng.normal(size=(30, 8, 10))).astype(np.float32)
    got = metrics.predictive_metrics_from_samples(torch.from_numpy(samples))
    want = jmetrics.predictive_metrics_from_samples(jnp.asarray(samples))
    for key in ("total", "aleatoric", "mi", "mean_probs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(want["pred"]))


def test_auroc_and_accuracy_match_reference():
    rng = np.random.default_rng(4)
    pos = np.round(rng.normal(1.0, 1.0, 57), 1)   # rounded: many ties
    neg = np.round(rng.normal(0.0, 1.0, 91), 1)
    assert metrics.auroc(torch.from_numpy(pos), neg) == jmetrics.auroc(pos, neg)
    pred, labels = rng.integers(0, 3, 40), rng.integers(0, 3, 40)
    assert metrics.accuracy(torch.from_numpy(pred), labels) == \
        jmetrics.accuracy(pred, labels)


def test_sample_pfp_logits_follow_eq11():
    mean = torch.tensor([[1.0, -2.0, 0.5]])
    var = torch.tensor([[0.25, 4.0, 0.0]])
    draw = lambda: metrics.sample_pfp_logits(  # noqa: E731
        torch.Generator().manual_seed(5), mean, var, 20000)
    samples = draw()
    assert torch.equal(samples, draw())
    np.testing.assert_allclose(samples.mean(0).numpy(), mean.numpy(),
                               atol=0.05)
    np.testing.assert_allclose(samples.std(0).numpy(), var.sqrt().numpy(),
                               rtol=0.03, atol=1e-6)
