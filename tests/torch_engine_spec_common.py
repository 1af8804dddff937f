"""Shared fixtures and helpers of the port's escalation and speculation
tests (``tests/test_torch_engine_spec*.py``), not a test file.

Reduced granite-8b (d_model 64, 2 layers, vocab 97; sigma_init 1e-3), one
JAX init converted and carried across with ``load_numpy_params``; 3 slots
of 24 rows, prefill windows of 3, 6 prompt tokens a step; the reference's
routers of ``tests/test_speculative.py`` (``OPEN``: everything continues,
``FORCE``: every token takes a 2-sample SVI second opinion, ``GATED``:
thresholds inside the model's MI range) and its tolerance ``MI_ATOL``.
The test files import the fixtures they use from here.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro_torch.configs import reduced_config
from repro_torch.models import lm
from repro_torch.nn.module import BayesParam, load_numpy_params
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import (Engine, EngineConfig,
                                        RequestScheduler, RouterConfig,
                                        SchedulerConfig, UncertaintyRouter,
                                        poisson_trace, run_load)
from torch_reference_noise import ReferenceLMEps, leaf_schedule

ARCH = "granite-8b"
SIGMA = 1e-3
SLOTS, MAX_LEN, SAMPLES, SEED = 3, 24, 8, 0
CHUNK, BUDGET = 3, 6
PAGES = [1, 4, MAX_LEN]
EOS = 9     # uid 2's third token in _trace(): an eos served mid-block
# tests/test_speculative.py: MI parity tolerance across pass shapes.
MI_ATOL = 2e-5
LOGIT_TOL = dict(rtol=1e-3, atol=1e-4)   # _parity's mean tolerance
ROUTERS = {
    # Wide open: every token CONTINUEs (the always-accept extreme).
    "open": dict(mi_continue=1e9, mi_abstain=2e9),
    # Every token takes the SVI second opinion.
    "force": dict(mi_continue=-1.0, mi_abstain=1e9, escalate_samples=2,
                  svi_mi_abstain=1e9),
    # Thresholds inside the reduced model's MI range (~7e-5..1e-4).
    "gated": dict(mi_continue=8e-5, mi_abstain=1e9, escalate_samples=2,
                  svi_mi_abstain=1e9),
}


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro import obs as jobs
    from repro.bayes.convert import svi_to_pfp as jsvi_to_pfp
    from repro.configs import reduced_config as jax_reduced_config
    from repro.core.modes import Mode as JMode
    from repro.models import lm as jlm
    from repro.nn.module import Context as JContext
    from repro.serving import engine as jengine
    cfg = dataclasses.replace(jax_reduced_config(ARCH), sigma_init=SIGMA)
    params = jsvi_to_pfp(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    return dict(jax=jax, jnp=jnp, obs=jobs, engine=jengine, lm=jlm,
                Context=JContext, Mode=JMode, cfg=cfg, params=params,
                tree=jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def port_model(jax_ref):
    cfg = dataclasses.replace(reduced_config(ARCH), sigma_init=SIGMA)
    return cfg, load_numpy_params(lm.init_params(cfg, device="cpu"),
                                  jax_ref["tree"])


@pytest.fixture(scope="module")
def schedule(port_model):
    cfg, model = port_model
    block = model.stack[0]["b0"]
    return leaf_schedule(cfg, sum(isinstance(m, BayesParam)
                                   for m in block.modules()))


def _reference_noise(jax_ref, seed=SEED, samples=SAMPLES, vocab=97):
    """The reference engine's Eq. 11 noise of (uid, token index)."""
    jax, jnp = jax_ref["jax"], jax_ref["jnp"]
    key = jax.random.PRNGKey(seed)

    @functools.lru_cache(maxsize=None)
    def noise(uid, tok_idx):
        k = jax.random.fold_in(jax.random.fold_in(key, uid & 0x7FFFFFFF),
                               tok_idx)
        k_samp, _ = jax.random.split(k)
        return np.asarray(jax.random.normal(k_samp, (samples, 1, vocab),
                                            jnp.float32))
    return noise


def _reference_svi_eps(jax_ref, schedule, samples, seed=SEED):
    """The reference engine's second-opinion noise of (uid, token index):
    ``fold_in(fold_in(key(seed + 1), uid), tok_idx)`` split ``samples``
    ways, one sample key a forward."""
    jax = jax_ref["jax"]
    key = jax.random.PRNGKey(seed + 1)

    def eps(uid, tok_idx):
        k = jax.random.fold_in(jax.random.fold_in(key, uid & 0x7FFFFFFF),
                               tok_idx)
        return [ReferenceLMEps(kj, schedule)
                for kj in jax.random.split(k, samples)]
    return eps


def _engine(model, *, router="open", page_size=4, tracer=None, **kw):
    cfg, m = model
    return Engine(cfg, m, EngineConfig(slots=SLOTS, max_len=MAX_LEN,
                                       num_uncertainty_samples=SAMPLES,
                                       seed=SEED, page_size=page_size, **kw),
                  router=UncertaintyRouter(cfg, RouterConfig(
                      **ROUTERS[router])),
                  scheduler=RequestScheduler(SchedulerConfig(
                      prefill_chunk=CHUNK, prefill_budget=BUDGET)),
                  tracer=tracer, device="cpu")


def _ref_engine(jax_ref, *, router="open", page_size=None, tracer=None,
                **kw):
    E = jax_ref["engine"]
    return E.Engine(
        jax_ref["cfg"], jax_ref["params"],
        E.EngineConfig(slots=SLOTS, max_len=MAX_LEN,
                       num_uncertainty_samples=SAMPLES, seed=SEED,
                       page_size=page_size, **kw),
        router=E.UncertaintyRouter(jax_ref["cfg"],
                                   E.RouterConfig(**ROUTERS[router])),
        scheduler=E.RequestScheduler(E.SchedulerConfig(
            prefill_chunk=CHUNK, prefill_budget=BUDGET)),
        tracer=tracer)


def _trace(make=poisson_trace, n=6, seed=4):
    """tests/test_speculative.py's trace, from either package."""
    return make(n, rate=0.8, vocab_size=97, seed=seed, prompt_len=(2, 7),
                max_new_tokens=(1, 5))


def _common_prefix_trace(n=4, prefix_len=9, tail_len=3, max_new=4):
    system = np.arange(1, prefix_len + 1, dtype=np.int32)
    return [Request(uid=i,
                    prompt=np.concatenate(
                        [system, np.full(tail_len, 50 + i, np.int32)]),
                    max_new_tokens=max_new, arrival=float(2 * i))
            for i in range(n)]


def _served(eng, trace, max_steps=2000):
    run_load(eng, trace, max_steps=max_steps)
    eng.pool.check_invariants()
    assert eng.pool.live == 0
    if getattr(eng, "prefix", None) is not None:
        eng.prefix.check_invariants(eng.pool)
    return {r.uid: (list(r.generated), [float(m) for m in r.mi_trace],
                    r.finish_reason) for r in eng.finished}


def _assert_same_stream(got, want):
    """Tokens and finish reasons equal; MI traces within MI_ATOL (across
    the two packages)."""
    assert set(got) == set(want)
    for uid in want:
        assert (got[uid][0], got[uid][2]) == (want[uid][0], want[uid][2]), \
            f"uid {uid}: {got[uid]} != {want[uid]}"
        assert len(got[uid][1]) == len(want[uid][1])
        np.testing.assert_allclose(got[uid][1], want[uid][1], rtol=0,
                                   atol=MI_ATOL, err_msg=f"uid {uid}")


def _assert_bit_for_bit(got, want):
    """Port against port: tokens, finish reasons and MI traces equal. The
    reference's own invariants allow MI_ATOL between pass shapes; the
    port's passes keep a row's bits (the plain torch ops here at M >= 2,
    the kernels on the card), so a replay against a wrong snapshot shows
    even where it moves MI by less than MI_ATOL."""
    _assert_same_stream(got, want)
    assert got == want


@pytest.fixture(scope="module")
def plain(port_model):
    """The plain (non-speculative) engine's stream, once per setting."""
    cache = {}

    def run(page_size, router="open", trace=_trace, **kw):
        key = (page_size, router, trace, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = _served(_engine(port_model, page_size=page_size,
                                         router=router, **kw), trace())
        return cache[key]
    return run
