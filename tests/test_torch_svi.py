"""SVI mode of the port against the JAX reference, on the CPU.

* The MLP 784-100-100-10 and LeNet-5 (reference init, sigma_init 1e-3,
  batch 4): SVI logits with the reference's own noise. The test rebuilds
  every leaf's eps from the reference's key scheme
  (``fold_in(fold_in(key, counter), layer_tag)``, counter 1, 2, ... in the
  order the forward resolves the leaves, layer_tag 0) and hands it to the
  port through ``Context.eps``. Tolerance: rtol 1e-5 / atol 1e-5 (both
  sides run the same fp32 products on the same samples).
* ``gaussian_kl``, ``total_kl``, ``KLSchedule`` and ``elbo_loss`` on the
  same trees and logits: rtol 1e-6 (1e-5 for the sums over a whole tree).
* The sampler of converted leaves, statistically: 20000 draws of a (mu,
  srm) and a (mu, var) leaf match mean mu and variance srm - mu^2 within
  five standard errors.
* ``predictive_metrics_from_sample_rows``: row b equals the per-row
  reduction bit for bit, and the reference's rows within rtol 1e-5.
* The trainable parameters' names are the reference tree's leaf paths
  (for the LM, with the stacked layer group's index taken out).
* The kernel impl refuses operands that need a gradient, and
  ``svi_to_pfp`` hands out no tensor that requires one.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bayes import metrics as jmetrics
from repro.bayes import variational as jvar
from repro.configs import reduced_config as jax_reduced_config
from repro.core.modes import Mode as JMode
from repro.models import lm as jlm
from repro.models.simple import (lenet5_forward, lenet5_init, mlp_forward,
                                 mlp_init)
from repro.nn.module import Context as JContext
from repro_torch.bayes import metrics, variational
from repro_torch.bayes.convert import svi_to_pfp
from repro_torch.configs import reduced_config
from repro_torch.core.modes import Mode
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.simple import MLP, LeNet5
from repro_torch.nn.module import (BayesParam, Context, load_numpy_params,
                                   resolve_weight)

KEY = jax.random.PRNGKey(0)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
MODELS = {
    "mlp": (mlp_init, mlp_forward, MLP, (4, 784)),
    "lenet5": (lenet5_init, lenet5_forward, LeNet5, (4, 28, 28, 1)),
}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf_paths(tree):
    return {".".join(p.key for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}


class ReferenceEps:
    """The reference's eps for each leaf, in resolve order: leaf c (1, 2,
    ...) of a forward under ``key`` draws
    ``normal(fold_in(fold_in(key, c), layer_tag))`` (nn/module.py
    ``Context.next_key``). With ``leaves_per_key``, the keys advance to
    the next entry of ``keys`` every that many leaves (one microbatch's
    forward each)."""

    def __init__(self, keys, leaves_per_key=None, layer_tag=0):
        self.keys = list(keys)
        self.per = leaves_per_key
        self.tag = layer_tag
        self.calls = 0

    def __call__(self, mu):
        i, c = ((0, self.calls) if self.per is None
                else divmod(self.calls, self.per))
        self.calls += 1
        k = jax.random.fold_in(jax.random.fold_in(self.keys[i], c + 1),
                               self.tag)
        return torch.from_numpy(np.array(
            jax.random.normal(k, tuple(mu.shape), jnp.float32)))


_JIT = {}


def _jit_svi(forward):
    """The reference's SVI forward, jitted once per model."""
    if forward not in _JIT:
        _JIT[forward] = jax.jit(lambda p, x, key: forward(
            p, x, JContext(mode=JMode.SVI, key=key)))
    return _JIT[forward]


@pytest.fixture(scope="module")
def trees():
    return {name: jax.jit(functools.partial(init, sigma_init=1e-3))(KEY)
            for name, (init, _, _, _) in MODELS.items()}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", list(MODELS))
def test_svi_logits_match_reference_with_its_noise(trees, name, seed):
    _, forward, cls, shape = MODELS[name]
    params = trees[name]
    x = np.random.default_rng(seed).random(shape, dtype=np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(_jit_svi(forward)(params, jnp.asarray(x), key))
    model = load_numpy_params(cls(device="cpu"), _numpy_tree(params))
    eps = ReferenceEps([key])
    got = model(x, Context(mode=Mode.SVI, device="cpu", eps=eps))
    assert eps.calls == sum(isinstance(m, BayesParam)
                            for m in model.modules())
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    det = model(x, Context(mode=Mode.DETERMINISTIC, device="cpu"))
    assert not np.allclose(det.numpy(), want, rtol=0, atol=1e-7)


def test_eps_of_the_wrong_shape_is_refused():
    model = MLP(d_hidden=8, device="cpu")
    ctx = Context(mode=Mode.SVI, device="cpu",
                  eps=lambda mu: torch.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        model(np.zeros((1, 784), np.float32), ctx)


# ---------------------------------------------------------------------------
# KL, annealing, ELBO
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prior_sigma", [1.0, 0.3])
def test_gaussian_kl_matches_reference(prior_sigma):
    rng = np.random.default_rng(0)
    mu = rng.normal(0, 0.5, (37, 11)).astype(np.float32)
    rho = rng.uniform(-8, 0, (37, 11)).astype(np.float32)
    got = variational.gaussian_kl(torch.from_numpy(mu), torch.from_numpy(rho),
                                  prior_sigma)
    want = jvar.gaussian_kl(jnp.asarray(mu), jnp.asarray(rho), prior_sigma)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", list(MODELS))
def test_total_kl_matches_reference(trees, name):
    model = load_numpy_params(MODELS[name][2](device="cpu"),
                              _numpy_tree(trees[name]))
    for prior_sigma in (1.0, 0.1):
        np.testing.assert_allclose(
            float(variational.total_kl(model, prior_sigma)),
            float(jvar.total_kl(trees[name], prior_sigma)), rtol=1e-5)


def test_total_kl_counts_only_variational_leaves(trees):
    """A converted model has no rho, so its KL is zero, as in the
    reference."""
    model = load_numpy_params(MLP(device="cpu"), _numpy_tree(trees["mlp"]))
    assert float(variational.total_kl(svi_to_pfp(model))) == 0.0


def test_kl_schedule_matches_reference():
    for alpha, steps in ((0.25, 150), (0.25, 100), (1.0, 1), (0.5, 0)):
        got, want = variational.KLSchedule(alpha, steps), jvar.KLSchedule(
            alpha, steps)
        for step in (0, 1, 50, 99, 100, 150, 500):
            np.testing.assert_allclose(got(step), float(want(step)),
                                       rtol=1e-6, atol=0)


@pytest.mark.parametrize("aux", [0.0, 0.37])
def test_elbo_loss_matches_reference(trees, aux):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (2, 5, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (2, 5)).astype(np.int32)
    model = load_numpy_params(MLP(device="cpu"), _numpy_tree(trees["mlp"]))
    loss, stats = variational.elbo_loss(
        torch.from_numpy(logits), torch.from_numpy(labels), model,
        kl_scale=0.2, num_data=1000, aux_loss=aux)
    want, want_stats = jvar.elbo_loss(
        jnp.asarray(logits), jnp.asarray(labels), trees["mlp"], kl_scale=0.2,
        num_data=1000, aux_loss=aux)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for k in ("nll", "kl"):
        np.testing.assert_allclose(float(stats[k]), float(want_stats[k]),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# The sampler of converted leaves
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rep", ["srm", "var"])
def test_converted_leaf_samples_have_its_moments(rep):
    n, d = 20000, 16
    rng = np.random.default_rng(4)
    mu = rng.normal(0, 1, d).astype(np.float32)
    var = rng.uniform(0.01, 2.0, d).astype(np.float32)
    second = var + mu * mu if rep == "srm" else var
    leaf = BayesParam(**{"mu": torch.from_numpy(np.tile(mu, (n, 1))),
                         rep: torch.from_numpy(np.tile(second, (n, 1)))})
    ctx = Context(mode=Mode.SVI, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    draws = resolve_weight(leaf, ctx).numpy().astype(np.float64)
    want_var = (second - mu * mu if rep == "srm" else var).astype(np.float64)
    assert np.all(np.abs(draws.mean(0) - mu) < 5 * np.sqrt(want_var / n))
    assert np.all(np.abs(draws.var(0) - want_var)
                  < 5 * want_var * np.sqrt(2.0 / n))


def test_a_negative_converted_variance_samples_the_mean():
    """sigma = sqrt(max(var, 0)), as in the reference: a leaf whose SRM
    rounds below mu^2 draws exactly mu."""
    mu = torch.tensor([1.0, -2.0])
    leaf = BayesParam(mu=mu, srm=torch.square(mu) - 1e-3)
    ctx = Context(mode=Mode.SVI, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(resolve_weight(leaf, ctx), mu)


# ---------------------------------------------------------------------------
# Eq. 1-3 over rows of samples
# ---------------------------------------------------------------------------
def test_sample_rows_equal_the_per_row_reduction_bit_for_bit():
    rng = np.random.default_rng(5)
    samples = rng.normal(0, 4, (6, 30, 10)).astype(np.float32)
    rows = metrics.predictive_metrics_from_sample_rows(
        torch.from_numpy(samples))
    want = jmetrics.predictive_metrics_from_sample_rows(jnp.asarray(samples))
    for b in range(len(samples)):
        one = metrics.predictive_metrics_from_samples(
            torch.from_numpy(samples[b, :, None]))
        for k, v in one.items():
            assert torch.equal(rows[k][b], v[0]), (k, b)
    for k in rows:
        np.testing.assert_allclose(rows[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Parameter names and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(MODELS))
def test_trainable_names_are_the_reference_leaf_paths(trees, name):
    model = MODELS[name][2](device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert names == _leaf_paths(trees[name])
    assert not any(p.requires_grad for p in model.parameters())


def test_lm_trainable_names_are_the_reference_leaf_paths():
    """Norm gains included; the port's ``stack.{g}.`` is the reference's
    stacked axis of ``stack.``."""
    arch = "granite-8b"
    tree = jax.eval_shape(lambda: jlm.init_params(jax_reduced_config(arch),
                                                  KEY))
    model = lm.init_params(reduced_config(arch), device="cpu")
    names = {n for n, _ in model.named_parameters()}
    groups = len(model.stack)
    unstacked = {n.replace(f"stack.{g}.", "stack.", 1) for n in names
                 for g in range(groups) if n.startswith(f"stack.{g}.")}
    assert unstacked | {n for n in names if not n.startswith("stack.")} \
        == _leaf_paths(tree)
    assert "stack.0.b0.ln1.g" in names and "lm_head.w.rho" in names


def test_kernel_impl_refuses_operands_that_need_a_gradient(trees):
    model = load_numpy_params(LeNet5(device="cpu"),
                              _numpy_tree(trees["lenet5"]))
    x = np.random.default_rng(0).random((2, 28, 28, 1), dtype=np.float32)
    model.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        model(x, Context(mode=Mode.PFP, impl="kernel", device="cpu"))
    with torch.no_grad():
        out = model(x, Context(mode=Mode.PFP, impl="kernel", device="cpu"))
    # The eager impl stays differentiable.
    eager = model(x, Context(mode=Mode.PFP, impl="eager", device="cpu"))
    assert eager.mean.requires_grad
    np.testing.assert_allclose(out.mean.numpy(), eager.mean.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    a = torch.ones(3, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.pfp_activation(a, torch.ones(3, 4), kind="relu")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.pfp_dense(torch.ones(2, 3), torch.ones(2, 3), a.T, a.T)


def test_svi_to_pfp_hands_out_no_tensor_that_requires_grad():
    cfg = dataclasses.replace(reduced_config("granite-8b"), num_layers=1)
    for model in (MLP(d_hidden=8, device="cpu"),
                  lm.init_params(cfg, device="cpu")):
        model.requires_grad_(True)
        for rep in ("srm", "var"):
            converted = svi_to_pfp(model, calibration_factor=0.4, rep=rep)
            assert not any(p.requires_grad for p in converted.parameters())
            assert all(p.grad_fn is None for p in converted.parameters())
        assert all(p.requires_grad for p in model.parameters())
