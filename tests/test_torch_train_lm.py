"""One SVI train step of the reduced LMs in the port against the JAX
reference, on the CPU.

Reduced granite-8b and deepseek-moe-16b, one step each, with every
``rho`` at -30: sigma = exp(-30) ~ 9e-14, so a sample rounds to ``mu``
wherever mu is not tiny and either package's noise will do. The step is
taken at state step 5 of ``KLSchedule(0.25, 10)``, so the KL term
weighs in (at step 0 it weighs nothing and rho's gradient would be
noise). deepseek's routing is compared first. The MoE aux loss at rtol
1e-5; loss, nll, kl, grad_norm and lr at rtol 1e-4 (at rho = -30 the
KL is an fp32 sum of some 1e5-1e6 terms of about 30 each, whose order
of summation differs between the packages); Adam's first moments (the
gradients) at rtol 1e-3 / atol 1e-4 of the tensor's largest; the
updated parameters at rtol 1e-5 / atol 1e-6, except elements whose
gradient is near zero: Adam's first step moves every element by about
lr = 1e-3 whatever its gradient's size, so there the rounding gap can
grow to anything up to lr, and those are held to 2 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bayes.variational import KLSchedule as JKLSchedule
from repro.configs import reduced_config as jax_reduced_config
from repro.core.modes import Mode as JMode
from repro.models import lm as jlm
from repro.nn.module import Context as JContext
from repro.training import optimizer as jopt
from repro.training.train_loop import TrainState as JTrainState
from repro.training.train_loop import \
    make_svi_train_step as jmake_svi_train_step
from repro_torch.bayes.variational import KLSchedule
from repro_torch.configs import reduced_config
from repro_torch.core.modes import Mode
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models import lm
from repro_torch.nn import moe
from repro_torch.nn.module import Context, load_numpy_params
from repro_torch.training.optimizer import Adam
from repro_torch.training.train_loop import (init_train_state,
                                             make_svi_train_step)

KEY = jax.random.PRNGKey(0)
AUX_TOL = dict(rtol=1e-5, atol=0)
LM_METRIC_TOL = dict(rtol=1e-4, atol=0)
MOMENT_TOL = dict(rtol=1e-3, atol=1e-4)      # atol: of the largest moment
LM_PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


def _flat(tree):
    """A reference tree as {dotted path: numpy array}."""
    return {".".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


LM_ARCHS = ("granite-8b", "deepseek-moe-16b")
LM_STEP, LM_ANNEAL, LM_BATCH, LM_SEQ = 5, 10, 2, 16


def _tight(tree):
    """Every variational leaf's rho set to -30."""
    def fix(path, leaf):
        return (jnp.full_like(leaf, -30.0)
                if getattr(path[-1], "key", None) == "rho" else leaf)
    return jax.tree_util.tree_map_with_path(fix, tree)


def _jax_routes_of(fn):
    """Run ``fn`` recording the expert ids at every ``jax.lax.top_k``."""
    log, orig = [], jax.lax.top_k

    def top_k(operand, k):
        vals, idx = orig(operand, k)
        jax.debug.callback(lambda i: log.append(np.array(i)), idx,
                           ordered=True)
        return vals, idx

    jax.lax.top_k = top_k
    try:
        fn()
    finally:
        jax.lax.top_k = orig
    return log


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_svi_train_step_matches_reference(arch):
    jcfg = jax_reduced_config(arch)
    params = jax.jit(lambda key: _tight(jlm.init_params(jcfg, key)))(KEY)
    batch = TokenPipeline(jcfg.vocab_size, LM_SEQ, LM_BATCH).batch(0)
    kl = dict(alpha_max=0.25, anneal_steps=LM_ANNEAL)
    kw = dict(num_data=LM_BATCH * LM_SEQ * LM_ANNEAL)
    model = load_numpy_params(lm.init_params(reduced_config(arch),
                                             device="cpu"),
                              jax.tree_util.tree_map(np.asarray, params))
    tokens = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    if arch == "deepseek-moe-16b":   # routing first
        jaux = {}
        ref_ids = _jax_routes_of(lambda: jaux.update(jax.jit(
            lambda p: jlm.forward(p, jcfg, jbatch, JContext(
                mode=JMode.SVI, key=KEY))[1])(params)))
        with torch.no_grad(), moe.record_routing() as routes:
            _, aux, _ = lm.forward(model, model.cfg, tokens, Context(
                mode=Mode.SVI, device="cpu",
                generator=torch.Generator().manual_seed(0)))
        assert len(routes) == len(ref_ids) > 0
        for r, want in zip(routes, ref_ids):
            np.testing.assert_array_equal(r.expert_idx.numpy(), want)

    def jfwd(p, b, ctx):
        logits, aux, _ = jlm.forward(p, jcfg, b, ctx)
        return logits, aux

    jadam = jopt.Adam(learning_rate=1e-3, clip_norm=1.0)
    jstate = JTrainState(params, jadam.init(params),
                         jnp.asarray(LM_STEP, jnp.int32))
    jstate, jmetrics = jax.jit(jmake_svi_train_step(
        jfwd, jadam, kl_schedule=JKLSchedule(**kl), **kw))(
        jstate, jbatch, KEY)

    def fwd(m, b, ctx):
        logits, aux, _ = lm.forward(m, m.cfg, b, ctx)
        return logits, aux

    adam = Adam(learning_rate=1e-3, clip_norm=1.0)
    state = init_train_state(model, adam)._replace(step=LM_STEP)
    state, metrics = make_svi_train_step(
        fwd, adam, kl_schedule=KLSchedule(**kl), **kw)(
        state, tokens, torch.Generator().manual_seed(0))
    if arch == "deepseek-moe-16b":
        assert float(jaux["loss"]) > 0
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                                   **AUX_TOL)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   err_msg=k, **LM_METRIC_TOL)
    m, want_m = _stacked(state.opt_state.m), _flat(jstate.opt_state.m)
    assert set(m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(
            m[k], want_m[k], rtol=MOMENT_TOL["rtol"],
            atol=MOMENT_TOL["atol"] * float(np.abs(want_m[k]).max()),
            err_msg=f"m {k}")
    _close_adam_step(_stacked(dict(model.named_parameters())),
                     _flat(jstate.params), _flat(jstate.opt_state.m),
                     lr=1e-3)


def _stacked(named):
    """The port's {name: tensor} with ``stack.{g}.`` entries stacked along
    a leading group axis, under the reference's ``stack.`` path."""
    out, groups = {}, {}
    for name, t in named.items():
        t = t.detach().numpy()
        parts = name.split(".")
        if parts[0] == "stack":
            groups.setdefault(".".join(["stack"] + parts[2:]), {})[
                int(parts[1])] = t
        else:
            out[name] = t
    out.update({k: np.stack([v[i] for i in sorted(v)])
                for k, v in groups.items()})
    return out


def _close_adam_step(got, want, grad_moment, lr):
    """Parameters after one Adam step at LM_PARAM_TOL, except where the
    gradient is near zero (its first moment under 1e-4 of the tensor's
    largest): there Adam's step g / (|g| + eps) turns the packages'
    rounding gap into anything up to lr, so those elements are held to
    the step's bound, 2 lr apart at most."""
    assert set(got) == set(want)
    for k in want:
        m = np.abs(grad_moment[k])
        small = m < 1e-4 * m.max()
        np.testing.assert_allclose(got[k][~small], want[k][~small],
                                   err_msg=f"param {k}", **LM_PARAM_TOL)
        assert np.all(np.abs(got[k] - want[k])[small] <= 2 * lr), k
