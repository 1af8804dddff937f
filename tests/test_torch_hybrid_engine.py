"""The port's serving engine on the hybrid and SSM families.

Reduced recurrentgemma-2b and mamba2-370m (sigma_init 1e-3), one init
each drawn in the port from seed 0, handed to the reference as its tree
(``numpy_params``), converted by the reference's ``svi_to_pfp`` and carried
back with ``load_numpy_params``; 2 slots of
16 rows, prefill chunks of 3, 6 prompt tokens a step. Both families feed
each prompt token once, in exact-length chunks, on the contiguous pool.

Against the reference's ``Engine`` with its noise handed in (the Eq. 11
noise through ``Engine._noise_override``, the second opinion's weight
noise through ``Engine._svi_eps_override``, rebuilt per leaf as
tests/test_torch_engine_spec.py does): tokens and finish reasons equal,
MI within MI_TOL (the engine tests' tolerance) with every token
continuing, and within MI_ATOL (tests/test_speculative.py's) with every
token taking a 2-sample SVI second opinion. The escalation replay, from the
carries of ``_prev_states`` (the state before the step), reproduces the
routed logits right after prefill and mid-decode, at rtol 1e-5 / atol
1e-5 as the reference's own test. The paged pool, prefix sharing and
speculation refuse both families with ``ValueError``.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core.modes import Mode
from repro_torch.models import lm
from repro_torch.nn.module import (BayesParam, Context, load_numpy_params,
                                   numpy_params)
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import (Engine, EngineConfig,
                                        RequestScheduler, RouterConfig,
                                        SchedulerConfig, UncertaintyRouter,
                                        run_load)

ARCHS = ("recurrentgemma-2b", "mamba2-370m")
SIGMA = 1e-3
SLOTS, MAX_LEN, SAMPLES, SEED = 2, 16, 8, 0
CHUNK, BUDGET = 3, 6
MI_TOL = dict(rtol=1e-2, atol=1e-5)
MI_ATOL = 2e-5
REPLAY_TOL = dict(rtol=1e-5, atol=1e-5)
ROUTERS = {
    "open": dict(mi_continue=1e9, mi_abstain=2e9, escalate_samples=0),
    "force": dict(mi_continue=-1.0, mi_abstain=1e9, escalate_samples=2,
                  svi_mi_abstain=1e9),
}


@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.bayes.convert import svi_to_pfp
    from repro.configs import reduced_config as jreduced
    from repro.models import lm as jlm
    from repro.serving import batcher as jbatcher
    from repro.serving import engine as jengine

    @functools.partial(jax.jit, static_argnums=3)
    def draw(key, counter, tag, shape):
        """``Context.next_key``'s normal draw for one leaf."""
        k = jax.random.fold_in(jax.random.fold_in(key, counter), tag)
        return jax.random.normal(k, shape, jnp.float32)

    return dict(jax=jax, jnp=jnp, svi_to_pfp=svi_to_pfp, reduced=jreduced,
                lm=jlm, batcher=jbatcher, engine=jengine, draw=draw)


@pytest.fixture(scope="module")
def models(jax_ref):
    """arch -> (reference cfg and params, port cfg and model), built on
    first use."""
    jax, built = jax_ref["jax"], {}

    def get(arch):
        if arch not in built:
            jcfg = dataclasses.replace(jax_ref["reduced"](arch),
                                       sigma_init=SIGMA)
            cfg = dataclasses.replace(reduced_config(arch), sigma_init=SIGMA)
            raw = numpy_params(lm.init_params(
                cfg, generator=torch.Generator().manual_seed(0),
                device="cpu"))
            params = jax_ref["svi_to_pfp"](
                jax.tree_util.tree_map(jax_ref["jnp"].asarray, raw))
            port = load_numpy_params(
                lm.init_params(cfg, device="cpu"),
                jax.tree_util.tree_map(np.asarray, params))
            built[arch] = dict(jcfg=jcfg, params=params, cfg=cfg, model=port)
        return built[arch]
    return get


@pytest.fixture(params=ARCHS)
def model(request, models):
    return models(request.param)


def _leaf_schedule(cfg, model):
    """(layer_tag, counter) of every Bayesian leaf of one reference LM
    forward, in the order the port resolves them: the embedding and the LM
    head on the outer context (tag 0), a stacked group's blocks on one
    counter under tag g, a tail layer under 2000 + i."""
    def leaves(block):
        return sum(isinstance(m, BayesParam) for m in block.modules())

    sched, counters = [(0, 1)], {}
    for name, _, group in lm._layers(cfg):
        if group is None:
            tag = 2000 + int(name[4:])
            block = getattr(model, name)
        else:
            tag, block = group, model.stack[group][name]
        start = counters.get(tag, 0)
        sched += [(tag, start + c) for c in range(1, leaves(block) + 1)]
        counters[tag] = start + leaves(block)
    return sched + [(0, 2)]


class ReferenceLMEps:
    """``Context.eps`` handing the port the reference's SVI noise of one LM
    forward under ``key``: leaf n draws ``normal(fold_in(fold_in(key,
    counter), tag))`` with (tag, counter) the n-th entry of ``schedule``."""

    def __init__(self, jax_ref, key, schedule):
        self.draw, self.key, self.schedule = jax_ref["draw"], key, schedule
        self.calls = 0

    def __call__(self, mu):
        tag, counter = self.schedule[self.calls]
        self.calls += 1
        return torch.from_numpy(np.array(self.draw(
            self.key, counter, tag, tuple(mu.shape))))


def _reference_noise(jax_ref, vocab=97):
    jax, jnp = jax_ref["jax"], jax_ref["jnp"]
    key = jax.random.PRNGKey(SEED)

    @functools.lru_cache(maxsize=None)
    def noise(uid, tok_idx):
        k = jax.random.fold_in(jax.random.fold_in(key, uid & 0x7FFFFFFF),
                               tok_idx)
        k_samp, _ = jax.random.split(k)
        return np.asarray(jax.random.normal(k_samp, (SAMPLES, 1, vocab),
                                            jnp.float32))
    return noise


def _reference_svi_eps(jax_ref, schedule, samples):
    jax = jax_ref["jax"]
    key = jax.random.PRNGKey(SEED + 1)

    def eps(uid, tok_idx):
        k = jax.random.fold_in(jax.random.fold_in(key, uid & 0x7FFFFFFF),
                               tok_idx)
        return [ReferenceLMEps(jax_ref, kj, schedule)
                for kj in jax.random.split(k, samples)]
    return eps


def _engine(m, router="open", **kw):
    cfg = m["cfg"]
    return Engine(cfg, m["model"],
                  EngineConfig(slots=SLOTS, max_len=MAX_LEN,
                               num_uncertainty_samples=SAMPLES, seed=SEED,
                               **kw),
                  router=UncertaintyRouter(cfg,
                                           RouterConfig(**ROUTERS[router])),
                  scheduler=RequestScheduler(SchedulerConfig(
                      prefill_chunk=CHUNK, prefill_budget=BUDGET)),
                  device="cpu")


def _ref_engine(jax_ref, m, router="open"):
    E = jax_ref["engine"]
    return E.Engine(
        m["jcfg"], m["params"],
        E.EngineConfig(slots=SLOTS, max_len=MAX_LEN,
                       num_uncertainty_samples=SAMPLES, seed=SEED),
        router=E.UncertaintyRouter(m["jcfg"],
                                   E.RouterConfig(**ROUTERS[router])),
        scheduler=E.RequestScheduler(E.SchedulerConfig(
            prefill_chunk=CHUNK, prefill_budget=BUDGET)))


def _trace():
    """Four prompts of 3-9 tokens (up to three chunks, the last of one
    token or three, so the reference compiles two chunk shapes), two
    queued behind full slots."""
    rng = np.random.default_rng(3)
    return [Request(uid=100 + i,
                    prompt=rng.integers(0, 97, n).astype(np.int32),
                    max_new_tokens=int(rng.integers(1, 5)),
                    arrival=float(i // 2))
            for i, n in enumerate((6, 4, 9, 7))]


def _short_trace():
    """Two prompts of 4 and 7 tokens: each ends in a one-token chunk, so
    every second opinion replays one token (the reference compiles one
    SVI pass)."""
    return [Request(uid=200, prompt=np.arange(1, 5, dtype=np.int32),
                    max_new_tokens=3),
            Request(uid=201, prompt=np.arange(10, 17, dtype=np.int32),
                    max_new_tokens=2)]


def _served(eng, trace):
    run_load(eng, trace, max_steps=500)
    eng.pool.check_invariants()
    assert eng.pool.live == 0
    return {r.uid: (list(r.generated), [float(x) for x in r.mi_trace],
                    r.finish_reason) for r in eng.finished}


def _against_reference(jax_ref, m, router, trace):
    want = _served(_ref_engine(jax_ref, m, router),
                   [jax_ref["batcher"].Request(**{
                       f.name: getattr(r, f.name)
                       for f in dataclasses.fields(r)})
                    for r in copy.deepcopy(trace)])
    eng = _engine(m, router)
    assert not eng._static_chunks
    eng._noise_override = _reference_noise(jax_ref)
    if router == "force":
        eng._svi_eps_override = _reference_svi_eps(
            jax_ref, _leaf_schedule(m["cfg"], m["model"]), 2)
    got = _served(eng, copy.deepcopy(trace))
    assert sorted(got) == sorted(want)
    tol = MI_TOL if router == "open" else dict(rtol=0.0, atol=MI_ATOL)
    for uid in want:
        assert got[uid][0] == want[uid][0], uid
        assert got[uid][2] == want[uid][2], uid
        np.testing.assert_allclose(got[uid][1], want[uid][1], **tol)
    return eng


def test_engine_matches_reference(jax_ref, model):
    """Every token continues: exact-length prefill chunks and lockstep
    decode on the contiguous pool."""
    eng = _against_reference(jax_ref, model, "open", _trace())
    assert eng.metrics.summary()["escalations"] == 0


def test_escalating_engine_matches_reference(jax_ref, models):
    """recurrentgemma-2b with every token escalated to a 2-sample SVI
    second opinion, replayed against the pre-step carries."""
    eng = _against_reference(jax_ref, models("recurrentgemma-2b"), "force",
                             _short_trace())
    assert eng.metrics.summary()["escalations"] > 0


def test_escalation_replay_reproduces_routed_logits(model):
    """The replay (state, inputs, out_idx) reproduces the pass behind the
    routed logits: the final prefill chunk's, then a decode step's from
    ``_prev_states`` (the carries from before the step: a replay from the
    advanced state would run the recurrence twice)."""
    cfg, m = model["cfg"], model["model"]
    eng = _engine(model)
    eng.submit(Request(uid=0, prompt=np.arange(1, 6, dtype=np.int32),
                       max_new_tokens=6))
    ctx = Context(mode=Mode.PFP, device="cpu")

    def check(slot):
        sl = eng._slots[slot]
        sub, inputs, out_idx = eng._replay_for(slot, sl)
        logits, _ = lm.decode_step(m, cfg, inputs, sub, ctx)
        np.testing.assert_allclose(logits.mean[0, out_idx].numpy(),
                                   eng._lm_mean[slot].numpy(), **REPLAY_TOL)
        return sub

    while eng._slots[0] is None or eng._slots[0].phase != "decode":
        eng.step()
    check(0)
    eng.step()
    eng.step()
    assert eng._slots[0].replay is None
    sub = check(0)
    # The replay's carries are the pre-step ones, not the pool's current.
    now = lm.take_decode_slots(eng.pool.states, [0])
    first = next(iter(sub["stack"].values()) if "stack" in sub
                 else sub.values())
    now_first = next(iter(now["stack"].values()) if "stack" in now
                     else now.values())
    assert not torch.equal(first[0], now_first[0])


def test_paged_prefix_and_speculation_refuse(model):
    with pytest.raises(ValueError, match="attention-family"):
        _engine(model, page_size=4)
    with pytest.raises(ValueError, match="attention-family"):
        _engine(model, page_size=4, prefix_sharing=True)
    with pytest.raises(ValueError, match="attention-family"):
        _engine(model, page_size=4, speculate_k=2)
    with pytest.raises(ValueError, match="prefix_sharing requires the paged"):
        _engine(model, prefix_sharing=True)
    with pytest.raises(ValueError, match="speculative decoding requires"):
        _engine(model, speculate_k=2)
