"""The dense transformer LM in the port against the JAX reference.

One JAX init of the reduced granite-8b (d_model 64, 4 heads of 16, 2 KV
heads, d_ff 128, vocab 97, 2 layers; sigma_init 0.02 so that the logit
variances are well above the tolerance's atol) is converted with
calibration factor 0.4 and carried across with ``load_numpy_params``,
stacked layer group and norm gains included. The same numpy token ids go
through ``repro.models.lm.forward`` and the port's ``lm.forward``.
Tolerances are tests/test_impl_dispatch.py's model-level ones: mean rtol
1e-3 / atol 1e-4, var rtol 1e-2 / atol 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.bayes.convert import svi_to_pfp as jax_svi_to_pfp
from repro.configs import reduced_config as jax_reduced_config
from repro.core.modes import Mode as JMode
from repro.models import lm as jlm
from repro.nn.module import Context as JContext
from repro_torch.bayes.convert import svi_to_pfp
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.modes import Mode
from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
from repro_torch.models import lm
from repro_torch.nn.module import Context, load_numpy_params

ARCH = "granite-8b"
SIGMA = 0.02
CAL = 0.4
MEAN_TOL = dict(rtol=1e-3, atol=1e-4)
VAR_TOL = dict(rtol=1e-2, atol=1e-5)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(custom_positions: bool):
    rng = np.random.default_rng(0)
    b, t = 2, 16
    inputs = {"tokens": rng.integers(0, 97, (b, t)).astype(np.int32)}
    if custom_positions:  # two packed segments: positions restart halfway
        half = np.broadcast_to(np.arange(t // 2, dtype=np.int32), (b, t // 2))
        inputs["positions"] = np.concatenate([half, half], axis=1)
    return inputs


@pytest.fixture(scope="module")
def trees():
    cfg = dataclasses.replace(jax_reduced_config(ARCH), sigma_init=SIGMA)
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    pfp = jax_svi_to_pfp(params, calibration_factor=CAL)
    return cfg, _numpy_tree(params), _numpy_tree(pfp), pfp, params


@pytest.fixture(scope="module")
def jax_logits(trees):
    cfg, _, _, pfp, params = trees
    cache = {}

    def get(mode=JMode.PFP, impl="xla", formulation="srm",
            attention_mode="mean_field", custom_positions=False):
        key = (mode, impl, formulation, attention_mode, custom_positions)
        if key not in cache:
            ctx = JContext(mode=mode, impl=impl, formulation=formulation,
                           attention_mode=attention_mode)
            tree = pfp if mode == JMode.PFP else params
            out, _, _ = jlm.forward(tree, cfg,
                                    {k: jax.numpy.asarray(v) for k, v in
                                     _inputs(custom_positions).items()}, ctx)
            cache[key] = ((np.asarray(out.mean), np.asarray(out.var))
                          if mode == JMode.PFP else np.asarray(out))
        return cache[key]

    return get


def _port(tree):
    return load_numpy_params(lm.init_params(reduced_config(ARCH),
                                            device="cpu"), tree)


def _check(out, want):
    assert out.var.min() > 0
    np.testing.assert_allclose(out.mean.numpy(), want[0], **MEAN_TOL)
    np.testing.assert_allclose(out.var.numpy(), want[1], **VAR_TOL)


def test_reduced_config_matches_reference():
    got = dataclasses.asdict(reduced_config(ARCH))
    want = dataclasses.asdict(jax_reduced_config(ARCH))
    assert got == {k: want[k] for k in got}
    full = get_config(ARCH)
    assert (full.d_model, full.num_heads, full.num_kv_heads, full.head_dim,
            full.d_ff, full.vocab_size, full.num_layers) == \
        (4096, 32, 8, 128, 14336, 49152, 36)


@pytest.mark.parametrize("attention_mode", ["mean_field", "variance_corrected"])
@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_pfp_logits_match_reference(trees, jax_logits, impl, formulation,
                                    attention_mode):
    model = _port(trees[2])
    out, aux, state = lm.forward(
        model, model.cfg, _inputs(False),
        Context(mode=Mode.PFP, impl=impl, formulation=formulation,
                attention_mode=attention_mode, device="cpu"))
    assert tuple(out.mean.shape) == (2, 16, 97) and state is None
    assert all(float(v) == 0.0 for v in aux.values())
    _check(out, jax_logits(formulation=formulation,
                           attention_mode=attention_mode))


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_pfp_logits_match_reference_pallas_kernels(trees, jax_logits, impl):
    """The JAX side through its Pallas kernels (interpret mode)."""
    model = _port(trees[2])
    out, _, _ = model(_inputs(False), Context(mode=Mode.PFP, impl=impl,
                                              device="cpu"))
    _check(out, jax_logits(impl="kernel"))


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_custom_positions_take_the_chunked_core(trees, jax_logits, impl):
    model = _port(trees[2])
    out, _, _ = model(_inputs(True), Context(mode=Mode.PFP, impl=impl,
                                             device="cpu"))
    _check(out, jax_logits(custom_positions=True))
    # Remapped positions change the result: the fallback is not a no-op.
    plain, _, _ = model(_inputs(False), Context(mode=Mode.PFP, impl=impl,
                                                device="cpu"))
    assert not torch.allclose(out.mean, plain.mean)


def test_deterministic_logits_match_reference(trees, jax_logits):
    model = _port(trees[1])
    out, _, _ = model(_inputs(False), Context(mode="deterministic",
                                              device="cpu"))
    np.testing.assert_allclose(out.numpy(),
                               jax_logits(mode=JMode.DETERMINISTIC),
                               **MEAN_TOL)


def test_svi_to_pfp_converts_the_lm_tree(trees):
    """Bayesian leaves convert as in the reference; norm gains are plain
    parameters and pass through unchanged."""
    _, params_tree, pfp_tree, _, _ = trees
    converted = svi_to_pfp(_port(params_tree), calibration_factor=CAL)
    want = _port(pfp_tree)
    got = dict(converted.named_parameters())
    ref = dict(want.named_parameters())
    assert set(got) == set(ref)
    assert "stack.1.b0.ln2.g" in got and "lm_head.w.srm" in got
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-6,
                                   atol=0)


def test_load_numpy_params_carries_the_stacked_layers(trees):
    pfp_tree = trees[2]
    model = _port(pfp_tree)
    for i in range(2):
        np.testing.assert_array_equal(
            model.stack[i].b0.attn.wq.w.srm.numpy(),
            pfp_tree["stack"]["b0"]["attn"]["wq"]["w"]["srm"][i])
        np.testing.assert_array_equal(model.stack[i].b0.ln1.g.numpy(),
                                      pfp_tree["stack"]["b0"]["ln1"]["g"][i])
    short = jax.tree_util.tree_map(lambda a: a, pfp_tree)
    short["stack"] = jax.tree_util.tree_map(lambda a: a[:1], pfp_tree["stack"])
    with pytest.raises(ValueError, match="stacked leaf"):
        _port(short)


def test_kernel_impl_on_cpu_launches_nothing(trees):
    model = _port(trees[2])
    reset_launch_counts()
    model(_inputs(False), Context(mode=Mode.PFP, device="cpu"))
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES


def test_unported_modes_raise(trees):
    model = _port(trees[2])
    with pytest.raises(ValueError, match="attention mode"):
        model(_inputs(False), Context(mode=Mode.PFP, attention_mode="exact",
                                      device="cpu"))
    with pytest.raises(NotImplementedError, match="family"):
        lm.init_params(dataclasses.replace(reduced_config(ARCH), family="cnn"),
                       device="cpu")
