"""Reduced llama-3.2-vision-90b (the VLM backbone) in the port against the
JAX reference.

The config, full and reduced, equals the reference's field for field (and
in ``param_count()``, layer kinds and pattern); the reduced one keeps one
super-block: 4 self-attention layers and a cross-attention layer (5
layers, d_model 64, 4 query heads of 16 over 2 KV heads, 8 image tokens).
One init, drawn in the port from seed 0 with sigma_init 0.02 and handed
to the reference as its tree (``numpy_params``), is converted by the
reference's ``svi_to_pfp`` with calibration factor 0.4 and carried back
with ``load_numpy_params``. The same numpy token ids and image embeddings
(B, 8, 64) go through ``repro.models.lm`` and the port: ``forward`` (PFP
under both port impls and both formulations, and DETERMINISTIC),
``prefill`` of 12 tokens and 3 ``decode_step`` calls on the contiguous
cache and through the paged pool (pages of 4), the image embeddings fed at
every step; the reference's prefilled state carried across with
``load_numpy_decode_state``. The cross block holds no decode state: both
state trees have the reference's keys, none for it. Tolerances are the
model-level ones of tests/test_impl_dispatch.py: mean rtol 1e-3 / atol
1e-4, var rtol 1e-2 / atol 1e-5.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.modes import Mode
from repro_torch.models import lm
from repro_torch.nn.module import Context, load_numpy_params, numpy_params

ARCH = "llama-3.2-vision-90b"
SIGMA, CAL = 0.02, 0.4
MEAN_TOL = dict(rtol=1e-3, atol=1e-4)
VAR_TOL = dict(rtol=1e-2, atol=1e-5)
B, PROMPT, MAX_LEN, STEPS, PAGE = 2, 12, 16, 3, 4


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.bayes.convert import svi_to_pfp
    from repro.configs import get_config as jget
    from repro.configs import reduced_config as jreduced
    from repro.core.modes import Mode as JMode
    from repro.models import lm as jlm
    from repro.nn.module import Context as JContext
    return dict(jax=jax, jnp=jnp, svi_to_pfp=svi_to_pfp, get=jget,
                reduced=jreduced, Mode=JMode, lm=jlm, Context=JContext)


@pytest.fixture(scope="module")
def setup(jax_ref):
    """The reference cfg, raw and converted reference params, their numpy
    trees and the reference's passes, each compiled once."""
    jax, jlm, jnp = jax_ref["jax"], jax_ref["lm"], jax_ref["jnp"]
    cfg = dataclasses.replace(jax_ref["reduced"](ARCH), sigma_init=SIGMA)
    port = lm.init_params(
        dataclasses.replace(reduced_config(ARCH), sigma_init=SIGMA),
        generator=torch.Generator().manual_seed(0), device="cpu")
    raw = jax.tree_util.tree_map(jnp.asarray, numpy_params(port))
    pfp = jax_ref["svi_to_pfp"](raw, calibration_factor=CAL)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    ctx = jax_ref["Context"]
    forward = jax.jit(lambda p, inputs, mode, form: jlm.forward(
        p, cfg, inputs, ctx(mode=mode, formulation=form))[0],
        static_argnums=(2, 3))
    pfp_ctx = functools.partial(ctx, mode=jax_ref["Mode"].PFP)
    prefill = jax.jit(lambda p, inputs: jlm.prefill(p, cfg, inputs,
                                                    pfp_ctx(), MAX_LEN))
    step = jax.jit(lambda p, inputs, st: jlm.decode_step(p, cfg, inputs, st,
                                                         pfp_ctx()))
    return dict(cfg=cfg, raw=raw, pfp=pfp,
                trees={"det": tree(raw), "pfp": tree(pfp)}, forward=forward,
                prefill=prefill, step=step)


def _port(setup, kind="pfp"):
    cfg = dataclasses.replace(reduced_config(ARCH), sigma_init=SIGMA)
    return load_numpy_params(lm.init_params(cfg, device="cpu"),
                             setup["trees"][kind])


def _tokens(t=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, 97, (B, t)).astype(
        np.int32)


def _images(seed=5):
    return np.random.default_rng(seed).normal(size=(B, 8, 64)).astype(
        np.float32)


def _inputs(tokens, **extra):
    return {"tokens": tokens, "image_embeddings": _images(), **extra}


def _ctx(impl="eager", formulation="srm"):
    return Context(mode=Mode.PFP, impl=impl, formulation=formulation,
                   device="cpu")


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol,
                               err_msg=what)


def _logits_close(got, want):
    assert float(got.var.min()) > 0
    _close(got.mean, want.mean, MEAN_TOL, "mean")
    _close(got.var, want.var, VAR_TOL, "var")


def _jnp_inputs(jnp, inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def test_config_matches_reference(jax_ref):
    for port, ref in ((get_config(ARCH), jax_ref["get"](ARCH)),
                      (reduced_config(ARCH), jax_ref["reduced"](ARCH))):
        got, want = dataclasses.asdict(port), dataclasses.asdict(ref)
        assert got == {k: want[k] for k in got}
        assert port.param_count() == ref.param_count()
        assert port.pattern == ref.pattern == ("attn",) * 4 + ("cross",)
        assert ([port.layer_kind(i) for i in range(port.num_layers)]
                == [ref.layer_kind(i) for i in range(ref.num_layers)])
    small = reduced_config(ARCH)
    assert (small.num_layers, small.num_image_tokens) == (5, 8)
    assert round(get_config(ARCH).param_count() / 1e9, 2) == 87.67
    assert "vlm" in lm.FAMILIES


@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_forward_matches_reference(jax_ref, setup, impl, formulation):
    model = _port(setup)
    inputs = _inputs(_tokens())
    got, _, _ = lm.forward(model, model.cfg, inputs, _ctx(impl, formulation))
    want = setup["forward"](setup["pfp"], _jnp_inputs(jax_ref["jnp"], inputs),
                            jax_ref["Mode"].PFP, formulation)
    assert tuple(got.mean.shape) == (B, PROMPT, 97)
    _logits_close(got, want)


def test_deterministic_forward_matches_reference(jax_ref, setup):
    model = _port(setup, "det")
    inputs = _inputs(_tokens())
    got, _, _ = lm.forward(model, model.cfg, inputs,
                           Context(mode=Mode.DETERMINISTIC, device="cpu"))
    want = setup["forward"](setup["raw"], _jnp_inputs(jax_ref["jnp"], inputs),
                            jax_ref["Mode"].DETERMINISTIC, "srm")
    _close(got, want, MEAN_TOL)


def test_images_move_the_logits(setup):
    """The cross layer reads the image embeddings: other images, other
    logits at every position."""
    model = _port(setup)
    ctx = _ctx("kernel")
    one, _, _ = lm.forward(model, model.cfg, _inputs(_tokens()), ctx)
    other, _, _ = lm.forward(model, model.cfg,
                             {"tokens": _tokens(),
                              "image_embeddings": _images(seed=6)}, ctx)
    assert bool((one.mean != other.mean).any(-1).all())


@pytest.fixture(scope="module")
def ref_decode(jax_ref, setup):
    """The reference's prefill and STEPS decode steps: (last logits, the
    prefilled state, [(tokens, logits)] a step)."""
    jnp, params = jax_ref["jnp"], setup["pfp"]
    last, states = setup["prefill"](params,
                                    _jnp_inputs(jnp, _inputs(_tokens())))
    prefilled, steps = states, []
    for i in range(STEPS):
        tok = _tokens(1, seed=10 + i)
        pos = np.full((B, 1), PROMPT + i, np.int32)
        logits, states = setup["step"](
            params, _jnp_inputs(jnp, _inputs(tok, positions=pos)), states)
        steps.append((tok, logits))
    return last, prefilled, steps


def test_cross_block_holds_no_decode_state(jax_ref, setup):
    cfg, port_cfg = setup["cfg"], _port(setup).cfg
    jlm = jax_ref["lm"]
    contiguous = lm.init_decode_state(port_cfg, B, MAX_LEN, device="cpu")
    paged = lm.init_paged_decode_state(port_cfg, 9, PAGE, device="cpu")
    want_contiguous = jlm.init_decode_state(cfg, B, MAX_LEN)
    want_paged = jlm.init_paged_decode_state(cfg, 9, PAGE)
    for got, want in ((contiguous, want_contiguous), (paged, want_paged)):
        assert set(got) == set(want) == {"stack"}
        assert set(got["stack"]) == set(want["stack"]) == {"b0", "b1", "b2",
                                                           "b3"}
        for name, st in got["stack"].items():
            assert ([tuple(a.shape) for a in st]
                    == [tuple(a.shape) for a in want["stack"][name]])
    assert type(paged["stack"]["b0"]).__name__ == "PagedKVCache"


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_prefill_and_decode_match_reference(jax_ref, setup, ref_decode,
                                           impl):
    want_last, want_prefilled, want_steps = ref_decode
    model = _port(setup)
    last, states = lm.prefill(model, model.cfg, _inputs(_tokens()),
                              _ctx(impl), MAX_LEN)
    assert tuple(last.mean.shape) == (B, 1, 97)
    _logits_close(last, want_last)
    flat = jax_ref["jax"].tree_util.tree_map(np.asarray, want_prefilled)
    assert set(states["stack"]) == set(flat["stack"])
    for name, cache in states["stack"].items():
        for field, a, b in zip(cache._fields, cache, flat["stack"][name]):
            _close(a, b, VAR_TOL if field == "v_var" else MEAN_TOL,
                   f"{name} {field}")
    for i, (tok, want) in enumerate(want_steps):
        logits, states = lm.decode_step(
            model, model.cfg,
            _inputs(tok, positions=np.full((B, 1), PROMPT + i)), states,
            _ctx(impl))
        _logits_close(logits, want)


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_paged_decode_matches_reference(setup, ref_decode, impl):
    """The prompt as one chunk through the paged decode step (slot b owns
    pages 1 + b P ..), then the same steps, images fed at each: the
    reference's logits; the draft step takes the images too."""
    want_last, _, want_steps = ref_decode
    model = _port(setup)
    pages = MAX_LEN // PAGE
    table = np.stack([np.arange(1, 1 + pages) + b * pages for b in range(B)]
                     ).astype(np.int32)
    states = lm.init_paged_decode_state(model.cfg, 1 + B * pages, PAGE,
                                        device="cpu")
    fed = [(_tokens(), np.broadcast_to(np.arange(PROMPT), (B, PROMPT)))]
    fed += [(tok, np.full((B, 1), PROMPT + i))
            for i, (tok, _) in enumerate(want_steps)]
    wants = [want_last] + [w for _, w in want_steps]
    for (tok, pos), want in zip(fed, wants):
        inputs = _inputs(tok, positions=pos, page_table=table,
                         cache_len=np.full((B,), pos[0, -1] + 1))
        draft, _ = lm.draft_decode_step(model, model.cfg, inputs, states,
                                        _ctx(impl))
        logits, states = lm.decode_step(model, model.cfg, inputs, states,
                                        _ctx(impl))
        assert "b4" not in states["stack"]
        if logits.mean.shape[1] > 1:
            logits = type(logits)(logits.mean[:, -1:], logits.second[:, -1:],
                                  logits.rep)
            draft = draft[:, -1:]
        _logits_close(logits, want)
        assert tuple(draft.shape) == tuple(logits.mean.shape)


def test_decode_state_carries_across_from_the_reference(jax_ref, setup,
                                                       ref_decode):
    """The reference's prefilled caches, converted, decode in the port as
    its own do; and the port's state goes back as the reference's tree."""
    _, prefilled, steps = ref_decode
    jax = jax_ref["jax"]
    states = lm.load_numpy_decode_state(
        jax.tree_util.tree_map(np.asarray, prefilled), device="cpu")
    assert {type(v).__name__ for v in states["stack"].values()} == {
        "KVCache"}
    model = _port(setup)
    tok, want = steps[0]
    logits, new = lm.decode_step(
        model, model.cfg, _inputs(tok, positions=np.full((B, 1), PROMPT)),
        states, _ctx("kernel"))
    _logits_close(logits, want)
    back = {"stack": {k: type(prefilled["stack"][k])(*(a.numpy() for a in v))
                      for k, v in new["stack"].items()}}
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(
                jax.tree_util.tree_map(np.asarray, prefilled)))
