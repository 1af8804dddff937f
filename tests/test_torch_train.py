"""SVI training in the port against the JAX reference, on the CPU.

* ``Adam.update``: two updates on the same numpy parameters and
  gradients, plain, clipped (``clip_norm`` below the gradients' norm), with
  decoupled ``weight_decay`` and under ``cosine_schedule``. Parameters,
  moments, ``grad_norm`` and ``lr`` at rtol 1e-5 / atol 1e-8.
* ``make_svi_train_step``: three steps of a narrow MLP (d_hidden 16) and
  of LeNet-5 against the reference's jitted step, on the same Dirty-MNIST
  batches and the reference's own noise (rebuilt from its key scheme and
  handed in through the context's eps hook), one MLP case with
  ``num_microbatches=2``. Metrics at rtol 1e-5; after three steps the
  parameters at rtol 1e-4 / atol 1e-5 and the moments at rtol 1e-3 / atol
  1e-4 of the tensor's largest moment. Adam moves an element by about lr
  (3e-3) a step whatever its gradient's size, so an element whose
  gradient is near zero (two microbatches' nearly cancelling) carries the
  two packages' rounding into the parameter at up to a few 1e-6; atol
  1e-5 is 0.1% of three steps' reach.
* One SVI train step of the reduced LMs: tests/test_torch_train_lm.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bayes.variational import KLSchedule as JKLSchedule
from repro.models.simple import (lenet5_forward, lenet5_init, mlp_forward,
                                 mlp_init)
from repro.training import optimizer as jopt
from repro.training.train_loop import init_train_state as jinit_train_state
from repro.training.train_loop import \
    make_svi_train_step as jmake_svi_train_step
from repro_torch.bayes.variational import KLSchedule
from repro_torch.data.dirty_mnist import batches, dirty_mnist
from repro_torch.models.simple import MLP, LeNet5
from repro_torch.nn.module import BayesParam, load_numpy_params
from repro_torch.training import optimizer
from repro_torch.training.optimizer import Adam, cosine_schedule
from repro_torch.training.train_loop import (init_train_state,
                                             make_svi_train_step)

KEY = jax.random.PRNGKey(0)
ADAM_TOL = dict(rtol=1e-5, atol=1e-8)
METRIC_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
MOMENT_TOL = dict(rtol=1e-3, atol=1e-4, scaled=True)


def _flat(tree):
    """A reference tree as {dotted path: numpy array}."""
    return {".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got: dict, want: dict, tol, what):
    """Each entry at ``tol``; ``tol['atol']`` is scaled by the entry's
    largest reference magnitude where ``tol`` says ``scaled``."""
    assert set(got) == set(want), what
    for k in want:
        g = got[k]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        t = dict(tol)
        if t.pop("scaled", False):
            t["atol"] *= float(np.abs(want[k]).max())
        np.testing.assert_allclose(g, want[k], err_msg=f"{what} {k}", **t)


class ReferenceEps:
    """The reference's eps, leaf by leaf in resolve order: leaf c (1, 2,
    ...) of the forward under key ``keys[i]`` draws
    ``normal(fold_in(fold_in(keys[i], c), 0))``; the key advances every
    ``leaves`` leaves (one forward, or one microbatch's)."""

    def __init__(self, keys, leaves):
        self.keys, self.leaves, self.calls = list(keys), leaves, 0

    def __call__(self, mu):
        i, c = divmod(self.calls, self.leaves)
        self.calls += 1
        k = jax.random.fold_in(jax.random.fold_in(self.keys[i], c + 1), 0)
        return torch.from_numpy(np.array(
            jax.random.normal(k, tuple(mu.shape), jnp.float32)))


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------
ADAMS = {
    "plain": dict(learning_rate=1e-3),
    "clip": dict(learning_rate=1e-3, clip_norm=0.5),
    "decay": dict(learning_rate=2e-3, weight_decay=0.01),
    "cosine": dict(learning_rate=("cosine", 1e-2, 2, 10), clip_norm=50.0),
}


def _adam(module, cfg):
    cfg = dict(cfg)
    lr = cfg.pop("learning_rate")
    if isinstance(lr, tuple):
        lr = module.cosine_schedule(*lr[1:])
    return module.Adam(learning_rate=lr, **cfg)


@pytest.mark.parametrize("name", list(ADAMS))
def test_adam_update_matches_reference(name):
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    port, ref = _adam(optimizer, ADAMS[name]), _adam(jopt, ADAMS[name])
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state, jstate = port.init(p), ref.init(jp)
    for g in grads:
        p, state, stats = port.update(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, state, p)
        jp, jstate, jstats = ref.update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        _close(p, _flat(jp), ADAM_TOL, "params")
        _close(state.m, _flat(jstate.m), ADAM_TOL, "m")
        _close(state.v, _flat(jstate.v), ADAM_TOL, "v")
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                       err_msg=k, **ADAM_TOL)
        assert state.step == int(jstate.step)
    if name == "clip":   # the clip was active
        assert float(stats["grad_norm"]) > ADAMS[name]["clip_norm"]


def test_cosine_schedule_matches_reference():
    port, ref = cosine_schedule(3e-3, 5, 40), jopt.cosine_schedule(3e-3, 5, 40)
    for step in range(0, 45, 3):
        np.testing.assert_allclose(port(step), float(ref(jnp.int32(step))),
                                   **ADAM_TOL)


# ---------------------------------------------------------------------------
# The SVI train step of the paper models
# ---------------------------------------------------------------------------
PAPER = {   # name: reference init and forward, port class, image view
    "mlp": (functools.partial(mlp_init, d_hidden=16), mlp_forward,
            functools.partial(MLP, d_hidden=16),
            lambda x: x.reshape(len(x), -1)),
    "lenet5": (lenet5_init, lenet5_forward, LeNet5, lambda x: x[..., None]),
}
N_TRAIN, BATCH, STEPS = 200, 20, 3


@pytest.fixture(scope="module")
def data():
    (x, y), _ = dirty_mnist(n_train=N_TRAIN, n_eval=2)
    return [(bx, by) for bx, by in batches(x, y, BATCH, epochs=1)][:STEPS]


@pytest.mark.parametrize("name,micro", [("mlp", 1), ("mlp", 2),
                                        ("lenet5", 1)])
def test_svi_train_steps_match_reference(data, name, micro):
    init, forward, cls, view = PAPER[name]
    params = jax.jit(functools.partial(init, sigma_init=1e-3))(KEY)
    kl = dict(alpha_max=0.25, anneal_steps=2)
    kw = dict(num_data=N_TRAIN, num_microbatches=micro)

    jadam = jopt.Adam(learning_rate=3e-3)
    jstate = jinit_train_state(params, jadam)
    jbatches = [{"x": jnp.asarray(view(bx)), "targets": jnp.asarray(by)}
                for bx, by in data]
    # Compiled once ahead of time: called through jax.jit, the step
    # compiles again on every call here.
    jstep = jax.jit(jmake_svi_train_step(
        lambda p, b, ctx: (forward(p, b["x"], ctx), 0.0), jadam,
        kl_schedule=JKLSchedule(**kl), **kw)).lower(
        jstate, jbatches[0], KEY).compile()

    model = load_numpy_params(cls(device="cpu"),
                              jax.tree_util.tree_map(np.asarray, params))
    leaves = sum(isinstance(m, BayesParam) for m in model.modules())
    adam = Adam(learning_rate=3e-3)
    step = make_svi_train_step(
        lambda m, b, ctx: (m(b["x"], ctx), 0.0), adam,
        kl_schedule=KLSchedule(**kl), **kw)
    state = init_train_state(model, adam)

    for i, (bx, by) in enumerate(data):
        key = jax.random.PRNGKey(i)
        jstate, jmetrics = jstep(jstate, jbatches[i], key)
        keys = ([key] if micro == 1 else
                [jax.random.fold_in(key, j) for j in range(micro)])
        eps = ReferenceEps(keys, leaves)
        state, metrics = step(state, {"x": torch.from_numpy(view(bx)),
                                      "targets": torch.from_numpy(by)},
                              eps=eps)
        assert eps.calls == leaves * micro
        _close({k: float(v) for k, v in metrics.items()},
               {k: float(v) for k, v in jmetrics.items()}, METRIC_TOL,
               f"step {i} metric")
    assert state.step == int(jstate.step) == STEPS
    assert state.opt_state.step == int(jstate.opt_state.step) == STEPS
    _close(dict(model.named_parameters()), _flat(jstate.params), PARAM_TOL,
           "param")
    _close(state.opt_state.m, _flat(jstate.opt_state.m), MOMENT_TOL, "m")
    _close(state.opt_state.v, _flat(jstate.opt_state.v), MOMENT_TOL, "v")
