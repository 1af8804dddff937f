"""Reduced yi-6b, internlm2-20b and gemma-7b in the port against the JAX
reference.

The three configs, full and reduced, equal the reference's field for field
(and in ``param_count()``); gemma's reduced config keeps MHA (4 KV heads of
4) and its GeGLU. One init of each reduced config (d_model 64, vocab 97, 2
layers, heads of 16; sigma_init 0.02), drawn in the port from seed 0 and
handed to the reference as its tree (``numpy_params``: a JAX init costs
more than the tests it feeds), is converted by the reference's
``svi_to_pfp`` with calibration factor 0.4 and carried back with
``load_numpy_params``. The same numpy token ids go through
``repro.models.lm`` and the port: ``forward`` (PFP under both port impls
and both formulations, and DETERMINISTIC), ``prefill`` of 12 tokens and 3
``decode_step`` calls on the contiguous cache, and the same prompt and
steps through the paged pool (pages of 4). Row 9's plain version at
gemma-7b's head_dim 256 is held to the reference's Pallas kernel in
interpret mode. Tolerances are the model-level ones of
tests/test_impl_dispatch.py: mean rtol 1e-3 / atol 1e-4, var rtol 1e-2 /
atol 1e-5; attention rtol 1e-4 / atol 1e-5.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.modes import Mode
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.nn.module import Context, load_numpy_params, numpy_params

ARCHS = ("yi-6b", "internlm2-20b", "gemma-7b")
SIGMA, CAL = 0.02, 0.4
MEAN_TOL = dict(rtol=1e-3, atol=1e-4)
VAR_TOL = dict(rtol=1e-2, atol=1e-5)
ATT_TOL = dict(rtol=1e-4, atol=1e-5)
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
    from repro.kernels import ops as jops
    from repro.models import lm as jlm
    from repro.nn.module import Context as JContext
    return dict(jax=jax, jnp=jnp, svi_to_pfp=svi_to_pfp, get=jget,
                reduced=jreduced, Mode=JMode, lm=jlm, Context=JContext,
                ops=jops)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request, jax_ref):
    """(arch, reference cfg, raw and converted reference params, their
    numpy trees, the reference's passes compiled once each)."""
    jax, jlm = jax_ref["jax"], jax_ref["lm"]
    cfg = dataclasses.replace(jax_ref["reduced"](request.param),
                              sigma_init=SIGMA)
    port = lm.init_params(
        dataclasses.replace(reduced_config(request.param), sigma_init=SIGMA),
        generator=torch.Generator().manual_seed(0), device="cpu")
    raw = jax.tree_util.tree_map(jax_ref["jnp"].asarray, numpy_params(port))
    pfp = jax_ref["svi_to_pfp"](raw, calibration_factor=CAL)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    ctx = jax_ref["Context"]
    forward = jax.jit(lambda p, t, mode, form: jlm.forward(
        p, cfg, {"tokens": t}, ctx(mode=mode, formulation=form))[0],
        static_argnums=(2, 3))
    pfp_ctx = functools.partial(ctx, mode=jax_ref["Mode"].PFP)
    prefill = jax.jit(lambda p, t: jlm.prefill(p, cfg, {"tokens": t},
                                               pfp_ctx(), MAX_LEN))
    step = jax.jit(lambda p, inputs, st: jlm.decode_step(p, cfg, inputs, st,
                                                         pfp_ctx()))
    return dict(arch=request.param, cfg=cfg, raw=raw, pfp=pfp,
                trees={"det": tree(raw), "pfp": tree(pfp)}, forward=forward,
                prefill=prefill, step=step)


def _port(setup, kind="pfp"):
    cfg = dataclasses.replace(reduced_config(setup["arch"]), sigma_init=SIGMA)
    return load_numpy_params(lm.init_params(cfg, device="cpu"),
                             setup["trees"][kind])


def _tokens(t=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, 97, (B, t)).astype(
        np.int32)


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


def test_configs_and_param_count_match_reference(jax_ref):
    for arch in ARCHS:
        for port, ref in ((get_config(arch), jax_ref["get"](arch)),
                          (reduced_config(arch), jax_ref["reduced"](arch))):
            got, want = dataclasses.asdict(port), dataclasses.asdict(ref)
            assert got == {k: want[k] for k in got}
            assert port.param_count() == ref.param_count()
            assert port.pattern == ref.pattern == ("attn",)
    gemma = reduced_config("gemma-7b")
    assert (gemma.num_heads, gemma.num_kv_heads, gemma.activation,
            gemma.gated_mlp) == (4, 4, "gelu", True)
    assert get_config("gemma-7b").head_dim == 256
    assert round(get_config("yi-6b").param_count() / 1e6) == 6061
    assert round(get_config("internlm2-20b").param_count() / 1e6) == 19861


@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_forward_matches_reference(jax_ref, setup, impl, formulation):
    model = _port(setup)
    tokens = _tokens()
    got, _, _ = lm.forward(model, model.cfg, {"tokens": tokens},
                           _ctx(impl, formulation))
    want = setup["forward"](setup["pfp"], jax_ref["jnp"].asarray(tokens),
                            jax_ref["Mode"].PFP, formulation)
    assert tuple(got.mean.shape) == (B, PROMPT, 97)
    _logits_close(got, want)


def test_deterministic_forward_matches_reference(jax_ref, setup):
    model = _port(setup, "det")
    tokens = _tokens()
    got, _, _ = lm.forward(model, model.cfg, {"tokens": tokens},
                           Context(mode=Mode.DETERMINISTIC, device="cpu"))
    want = setup["forward"](setup["raw"], jax_ref["jnp"].asarray(tokens),
                            jax_ref["Mode"].DETERMINISTIC, "srm")
    _close(got, want, MEAN_TOL)


@pytest.fixture(scope="module")
def ref_decode(jax_ref, setup):
    """The reference's prefill and STEPS decode steps: (last logits,
    [(tokens, logits)] a step)."""
    jnp, params = jax_ref["jnp"], setup["pfp"]
    last, states = setup["prefill"](params, jnp.asarray(_tokens()))
    steps = []
    for i in range(STEPS):
        tok = _tokens(1, seed=10 + i)
        logits, states = setup["step"](
            params, {"tokens": jnp.asarray(tok),
                     "positions": jnp.full((B, 1), PROMPT + i, jnp.int32)},
            states)
        steps.append((tok, logits))
    return last, steps


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_prefill_and_decode_match_reference(setup, ref_decode, impl):
    want_last, want_steps = ref_decode
    model = _port(setup)
    last, states = lm.prefill(model, model.cfg, {"tokens": _tokens()},
                              _ctx(impl), MAX_LEN)
    assert tuple(last.mean.shape) == (B, 1, 97)
    _logits_close(last, want_last)
    for i, (tok, want) in enumerate(want_steps):
        logits, states = lm.decode_step(
            model, model.cfg,
            {"tokens": tok, "positions": np.full((B, 1), PROMPT + i)},
            states, _ctx(impl))
        _logits_close(logits, want)


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_paged_decode_matches_reference(setup, ref_decode, impl):
    """The prompt as one chunk through the paged decode step (slot b owns
    pages 1 + b P ..), then the same steps: the contiguous reference's
    logits."""
    want_last, want_steps = ref_decode
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
        logits, states = lm.decode_step(
            model, model.cfg,
            {"tokens": tok, "positions": pos, "page_table": table,
             "cache_len": np.full((B,), pos[0, -1] + 1)}, states,
            _ctx(impl))
        if logits.mean.shape[1] > 1:
            logits = type(logits)(logits.mean[:, -1:], logits.second[:, -1:],
                                  logits.rep)
        _logits_close(logits, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lengths", [(9, 9), (5, 13), (16, 7)])
def test_row9_plain_version_at_head_dim_256(jax_ref, lengths, causal):
    """gemma-7b's head_dim: the port's op on CPU tensors (row 9's plain
    version) against the reference's ``ops.pfp_attention`` under the
    kernel impl (the Pallas kernel in interpret mode), G 1 and G 2, Tq
    equal to, below and above Tk."""
    tq, tk = lengths
    rng = np.random.default_rng(tq * 31 + tk)
    d = 256
    for h, hkv in ((2, 2), (4, 2)):
        q = rng.normal(size=(1, h, tq, d)).astype(np.float32)
        k, vm = (rng.normal(size=(1, hkv, tk, d)).astype(np.float32)
                 for _ in range(2))
        vv = np.log1p(np.exp(rng.normal(size=(1, hkv, tk, d)))).astype(
            np.float32)
        got = ops.pfp_attention(*(torch.from_numpy(a) for a in (q, k, vm,
                                                                 vv)),
                                scale=d ** -0.5, causal=causal)
        want = jax_ref["ops"].pfp_attention(q, k, vm, vv, scale=d ** -0.5,
                                            causal=causal, impl="kernel")
        for g, w in zip(got, want):
            _close(g, w, ATT_TOL)
