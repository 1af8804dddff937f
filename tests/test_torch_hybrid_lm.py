"""Reduced recurrentgemma-2b (hybrid) and mamba2-370m (ssm) in the port
against the JAX reference.

One init of each reduced config (d_model 64, vocab 97; recurrentgemma: 5
layers, one stacked (rec, rec, attn) group and a 2-layer tail, 4 query
heads of 16 over 1 KV head, window 8, d_rnn 64; mamba2: 4 SSM layers,
state 16, heads of 32, chunks of 8; sigma_init 0.02), drawn in the port
from seed 0 and handed to the reference as its tree (``numpy_params``: a
JAX init costs more than the tests it feeds), is converted by the
reference's ``svi_to_pfp`` with calibration factor 0.4 and carried back
with ``load_numpy_params``. The
same numpy token ids go through ``repro.models.lm`` and the port:
``forward`` (PFP under both port impls and both formulations, and
DETERMINISTIC), ``prefill`` of 16 tokens (past the window of 8; two SSM
chunks) and 3 ``decode_step`` calls (logits, then the carries and caches
of every layer), the reference's prefilled state carried across with
``load_numpy_decode_state``, and the slot helpers on the carries. Also
``param_count()`` and the configs equal to the reference's, and
``init_paged_decode_state`` refusing both families with ``ValueError``.
Tolerances are the model-level ones of tests/test_impl_dispatch.py: mean
rtol 1e-3 / atol 1e-4, var rtol 1e-2 / atol 1e-5.
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

ARCHS = ("recurrentgemma-2b", "mamba2-370m")
SIGMA, CAL = 0.02, 0.4
MEAN_TOL = dict(rtol=1e-3, atol=1e-4)
VAR_TOL = dict(rtol=1e-2, atol=1e-5)
B, PROMPT, MAX_LEN, STEPS = 2, 16, 24, 3


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


@pytest.fixture(scope="module", params=ARCHS)
def setup(request, jax_ref):
    """(arch, reference cfg, raw and converted reference params, their
    numpy trees)."""
    jax, jlm = jax_ref["jax"], jax_ref["lm"]
    cfg = dataclasses.replace(jax_ref["reduced"](request.param),
                              sigma_init=SIGMA)
    port = lm.init_params(
        dataclasses.replace(reduced_config(request.param), sigma_init=SIGMA),
        generator=torch.Generator().manual_seed(0), device="cpu")
    raw = jax.tree_util.tree_map(jax_ref["jnp"].asarray, numpy_params(port))
    pfp = jax_ref["svi_to_pfp"](raw, calibration_factor=CAL)
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    # The reference's passes, each compiled once (jit) per shape; decode
    # under PFP and Eq. 12.
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
    assert reduced_config("recurrentgemma-2b").num_layers == 5
    assert round(get_config("mamba2-370m").param_count() / 1e6, 1) == 419.1
    assert round(get_config("recurrentgemma-2b").param_count() / 1e6) == 3550


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
    """The reference's prefill and STEPS decode steps: (last logits, the
    prefilled state, [(tokens, logits, state)] a step)."""
    jnp, params = jax_ref["jnp"], setup["pfp"]
    last, states = setup["prefill"](params, jnp.asarray(_tokens()))
    prefilled, steps = states, []
    for i in range(STEPS):
        tok = _tokens(1, seed=10 + i)
        logits, states = setup["step"](
            params, {"tokens": jnp.asarray(tok),
                     "positions": jnp.full((B, 1), PROMPT + i, jnp.int32)},
            states)
        steps.append((tok, logits, states))
    return last, prefilled, steps


def _states_close(got, want, jax):
    """Every layer's carry or cache: means at MEAN_TOL, second moments at
    VAR_TOL."""
    flat_want = jax.tree_util.tree_map(np.asarray, want)

    def walk(g, w, path):
        if isinstance(g, dict):
            assert set(g) == set(w), path
            for k in g:
                walk(g[k], w[k], path + (k,))
            return
        assert type(g).__name__ == type(w).__name__, path
        for name, a, b in zip(g._fields, g, w):
            tol = VAR_TOL if name in ("h_var", "s_var", "conv_srm",
                                      "v_var") else MEAN_TOL
            _close(a, b, tol, f"{path} {name}")

    walk(got, flat_want, ())


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_prefill_and_decode_match_reference(jax_ref, setup, ref_decode,
                                           impl):
    want_last, want_prefilled, want_steps = ref_decode
    model = _port(setup)
    last, states = lm.prefill(model, model.cfg, {"tokens": _tokens()},
                              _ctx(impl), MAX_LEN)
    assert tuple(last.mean.shape) == (B, 1, 97)
    _logits_close(last, want_last)
    _states_close(states, want_prefilled, jax_ref["jax"])
    kinds = {type(s).__name__ for s in
             list(states.get("stack", {}).values())
             + [v for k, v in states.items() if k != "stack"]}
    assert kinds == ({"RecurrentState", "KVCache"}
                     if setup["arch"] == "recurrentgemma-2b" else {"SSMState"})
    for i, (tok, want, want_states) in enumerate(want_steps):
        logits, states = lm.decode_step(
            model, model.cfg,
            {"tokens": tok, "positions": np.full((B, 1), PROMPT + i)},
            states, _ctx(impl))
        _logits_close(logits, want)
    _states_close(states, want_states, jax_ref["jax"])


def test_decode_state_carries_across_from_the_reference(jax_ref, setup,
                                                       ref_decode):
    """The reference's prefilled carries and caches, converted, decode in
    the port as its own do."""
    _, prefilled, steps = ref_decode
    states = lm.load_numpy_decode_state(
        jax_ref["jax"].tree_util.tree_map(np.asarray, prefilled),
        device="cpu")
    types = {type(v).__name__ for v in states.values() if not isinstance(
        v, dict)} | {type(v).__name__ for v in states.get("stack",
                                                          {}).values()}
    assert types <= {"RecurrentState", "SSMState", "KVCache"}
    model = _port(setup)
    tok, want, _ = steps[0]
    logits, _ = lm.decode_step(model, model.cfg,
                               {"tokens": tok,
                                "positions": np.full((B, 1), PROMPT)},
                               states, _ctx("kernel"))
    _logits_close(logits, want)


def test_slot_helpers_on_the_carries(jax_ref, setup, ref_decode):
    """take / write / reset / select along each carry's slot axis, as the
    reference's helpers do on the same state."""
    jlm = jax_ref["lm"]
    _, prefilled, _ = ref_decode
    states = lm.load_numpy_decode_state(
        jax_ref["jax"].tree_util.tree_map(np.asarray, prefilled),
        device="cpu")
    fresh = lm.init_decode_state(_port(setup).cfg, B, MAX_LEN, device="cpu")
    jfresh = jlm.init_decode_state(setup["cfg"], B, MAX_LEN)
    keep = np.asarray([True, False])
    pairs = [
        (lm.take_decode_slots(states, [1, 0]),
         jlm.take_decode_slots(prefilled, np.asarray([1, 0]))),
        (lm.write_decode_slot(fresh, 1, lm.take_decode_slots(states, [0])),
         jlm.write_decode_slot(jfresh, 1,
                               jlm.take_decode_slots(prefilled,
                                                     np.asarray([0])))),
        (lm.reset_decode_slot(states, 0), jlm.reset_decode_slot(prefilled, 0)),
        (lm.select_decode_slots(states, fresh, torch.from_numpy(keep)),
         jlm.select_decode_slots(prefilled, jfresh,
                                 jax_ref["jnp"].asarray(keep))),
    ]
    for got, want in pairs:
        flat_got = jax_ref["jax"].tree_util.tree_leaves(
            lm._map_with_path(lambda p, a: a.numpy(), got))
        flat_want = [np.asarray(a) for a in
                     jax_ref["jax"].tree_util.tree_leaves(want)]
        assert len(flat_got) == len(flat_want)
        for a, b in zip(flat_got, flat_want):
            np.testing.assert_array_equal(a, b)


def test_paged_state_refuses_both_families(jax_ref, setup):
    cfg = _port(setup).cfg
    with pytest.raises(ValueError, match="attention-family"):
        lm.init_paged_decode_state(cfg, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="attention-family"):
        jax_ref["lm"].init_paged_decode_state(setup["cfg"], 8, 4)
    # the attention families still page
    paged = lm.init_paged_decode_state(reduced_config("granite-8b"), 8, 4,
                                       device="cpu")
    assert type(paged["stack"]["b0"]).__name__ == "PagedKVCache"
