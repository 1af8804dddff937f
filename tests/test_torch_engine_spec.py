"""The port's SVI escalation and uncertainty-speculative decoding.

Reduced granite-8b (d_model 64, 2 layers, vocab 97; sigma_init 1e-3), one
JAX init converted and carried across with ``load_numpy_params``; 3 slots
of 24 rows, prefill windows of 3, 6 prompt tokens a step; the reference's
routers of ``tests/test_speculative.py`` (``OPEN``: everything continues,
``FORCE``: every token takes a 2-sample SVI second opinion, ``GATED``:
thresholds inside the model's MI range) and its tolerance ``MI_ATOL``.

Against the reference, with both noises handed in: the engine's Eq. 11
noise through ``Engine._noise_override`` and the second opinion's weight
noise through ``Engine._svi_eps_override``. The reference keys a leaf's
SVI noise ``fold_in(fold_in(sample_key, counter), layer_tag)``
(``repro/nn/module.py`` ``Context.next_key``): the counter restarts at
each ``with_layer``, whose tags are 1000 + i for the head layers, the
group index for the stacked ones and 2000 + i for the tail; the
embedding and the LM head count on the outer context (counters 1 and 2,
tag 0). ``ReferenceLMEps`` rebuilds that schedule in the order the port
resolves its leaves. Compared: the second opinion (tokens equal, MI
within ``MI_ATOL``, each sample's logits at the model tolerance), the
contiguous escalating engine (tokens, finish reasons, escalation counts
and trace events equal, MI within ``MI_ATOL``) and the paged speculative
engine (tokens, finish reasons and pass counts equal). The reference's
paged escalation tests fail on this tree, so its paged engine is no
oracle for escalation.

Port against port, the reference's invariants at pages of 1, 4 and 24:
speculative == plain under always-accept, never-accept, MI-gated routing
and eos; batched escalation == sequential (bit for bit, MI included);
speculation with escalations == plain with escalations; prefix-shared ==
cold, preempting == reserving, and escalations after ``defrag()`` and
``compact()`` replaying against the remapped snapshot; the replay
reproduces the routed logits on both pools. These compare tokens,
finish reasons and MI traces bit for bit: the reference allows
``MI_ATOL`` between pass shapes, but the port's passes keep a row's bits,
and an escalation replayed against a stale snapshot can move MI by less
than ``MI_ATOL``. The ``gpu`` test holds speculative == plain bit for bit
on the card.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.bayes.convert import svi_to_pfp
from repro_torch.configs import reduced_config
from repro_torch.core.modes import Mode
from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
from repro_torch.models import lm
from repro_torch.nn.module import BayesParam, Context, load_numpy_params
from repro_torch.obs.trace import Tracer
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import (Engine, EngineConfig,
                                        RequestScheduler, RouterConfig,
                                        SchedulerConfig, UncertaintyRouter,
                                        make_svi_fallback,
                                        make_svi_fallback_batched,
                                        poisson_trace, run_load,
                                        svi_fallback_cache_clear)

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

    @functools.partial(jax.jit, static_argnums=3)
    def draw(key, counter, tag, shape):
        """``Context.next_key``'s normal draw for one leaf."""
        k = jax.random.fold_in(jax.random.fold_in(key, counter), tag)
        return jax.random.normal(k, shape, jnp.float32)

    return dict(jax=jax, jnp=jnp, obs=jobs, engine=jengine, lm=jlm,
                Context=JContext, Mode=JMode, cfg=cfg, params=params,
                draw=draw, tree=jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def port_model(jax_ref):
    cfg = dataclasses.replace(reduced_config(ARCH), sigma_init=SIGMA)
    return cfg, load_numpy_params(lm.init_params(cfg, device="cpu"),
                                  jax_ref["tree"])


def _leaf_schedule(cfg, per_block):
    """(layer_tag, counter) of every leaf of one reference LM forward, in
    the order the port resolves them."""
    lpg, groups, tail = lm._group_counts(cfg)
    sched = [(0, 1)]                                  # the embedding
    for i in range(cfg.first_dense_layers):
        sched += [(1000 + i, c) for c in range(1, per_block + 1)]
    for g in range(groups):
        sched += [(g, c) for c in range(1, lpg * per_block + 1)]
    for i in range(tail):
        sched += [(2000 + i, c) for c in range(1, per_block + 1)]
    return sched + [(0, 2)]                           # the LM head


class ReferenceLMEps:
    """``Context.eps`` handing the port the reference's SVI noise of one
    LM forward under ``key``: leaf n draws
    ``normal(fold_in(fold_in(key, counter), tag))`` with (tag, counter)
    the n-th entry of ``schedule``."""

    def __init__(self, jax_ref, key, schedule):
        self.draw, self.key, self.schedule = jax_ref["draw"], key, schedule
        self.calls = 0

    def __call__(self, mu):
        tag, counter = self.schedule[self.calls]
        self.calls += 1
        return torch.from_numpy(np.array(self.draw(
            self.key, counter, tag, tuple(mu.shape))))


@pytest.fixture(scope="module")
def schedule(port_model):
    cfg, model = port_model
    block = model.stack[0]["b0"]
    return _leaf_schedule(cfg, sum(isinstance(m, BayesParam)
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
        return [ReferenceLMEps(jax_ref, kj, schedule)
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


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("samples", [2, 8])
def test_second_opinion_matches_reference(jax_ref, port_model, schedule,
                                          samples):
    """A replay of 3 tokens at positions 5-7 over a cache holding the
    reference's PFP rows of positions 0-4: the port's second opinion with
    the reference's noise gives its token, and its MI within MI_ATOL."""
    jax, jnp, jlm = jax_ref["jax"], jax_ref["jnp"], jax_ref["lm"]
    cfg, model = port_model
    jcfg, params = jax_ref["cfg"], jax_ref["params"]
    prompt = np.random.default_rng(samples).integers(0, 97, 8).astype(
        np.int32)
    state = jlm.init_decode_state(jcfg, 1, MAX_LEN)
    _, state = jlm.decode_step(
        params, jcfg, {"tokens": jnp.asarray(prompt[None, :5]),
                       "positions": jnp.arange(5)[None],
                       "cache_len": jnp.asarray([5])},
        state, jax_ref["Context"](mode=jax_ref["Mode"].PFP))
    inputs = {"tokens": prompt[None, 5:], "positions": np.arange(5, 8)[None],
              "cache_len": np.asarray([8], np.int32)}
    key = jax.random.PRNGKey(10 + samples)
    want_tok, want_mi = jax_ref["engine"].make_svi_fallback(jcfg, samples)(
        params, {k: jnp.asarray(v) for k, v in inputs.items()}, state, key,
        jnp.asarray(2, jnp.int32))
    port_state = lm.load_numpy_decode_state(
        jax.tree_util.tree_map(np.asarray, state), "cpu")
    router = UncertaintyRouter(cfg, RouterConfig(escalate_samples=samples))
    eps = [ReferenceLMEps(jax_ref, k, schedule)
           for k in jax.random.split(key, samples)]
    tok, mi = router.second_opinion(model, inputs, port_state, eps)
    assert [e.calls for e in eps] == [len(schedule)] * samples
    assert int(tok) == int(want_tok)
    np.testing.assert_allclose(float(mi), float(want_mi), rtol=0,
                               atol=MI_ATOL)
    # Each sample's logits, the eps schedule's own check.
    k0 = jax.random.split(key, samples)[0]
    want, _ = jlm.decode_step(params, jcfg,
                              {k: jnp.asarray(v) for k, v in inputs.items()},
                              state, jax_ref["Context"](
                                  mode=jax_ref["Mode"].SVI, key=k0))
    got, _ = lm.decode_step(model, cfg, inputs, port_state, Context(
        mode=Mode.SVI, device="cpu",
        eps=ReferenceLMEps(jax_ref, k0, schedule)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    det, _ = lm.decode_step(model, cfg, inputs, port_state,
                            Context(mode=Mode.DETERMINISTIC, device="cpu"))
    assert not np.allclose(det.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _strip(events):
    return [{k: v for k, v in e.items()
             if k not in ("wall", "mi", "pfp_mi", "svi_mi")} for e in events]


@pytest.mark.parametrize("router", ["force", "gated"])
def test_escalating_engine_matches_reference(jax_ref, port_model, schedule,
                                             router):
    ref_tracer, tracer = jax_ref["obs"].Tracer(), Tracer()
    ref = _ref_engine(jax_ref, router=router, tracer=ref_tracer)
    want = _served(ref, _trace(jax_ref["engine"].poisson_trace))
    eng = _engine(port_model, router=router, page_size=None, tracer=tracer)
    eng._noise_override = _reference_noise(jax_ref)
    eng._svi_eps_override = _reference_svi_eps(jax_ref, schedule, 2)
    got = _served(eng, _trace())
    _assert_same_stream(got, want)
    assert _strip(tracer.events) == _strip(ref_tracer.events)
    for key in ("mi", "pfp_mi", "svi_mi"):
        pairs = [(e[key], w[key]) for e, w in zip(tracer.events,
                                                  ref_tracer.events)
                 if key in e]
        assert pairs
        np.testing.assert_allclose(*zip(*pairs), rtol=0, atol=MI_ATOL)
    s, rs = eng.metrics.summary(), ref.metrics.summary()
    assert s["escalations"] == rs["escalations"] > 0
    for k in ("svi_passes", "tokens_generated", "band_continue",
              "band_escalate", "band_abstain", "abstained", "completed"):
        assert s[k] == rs[k], k
    if router == "gated":
        assert 0 < s["band_continue"] and 0 < s["band_escalate"]


@pytest.mark.parametrize("drafts", ["natural", "never"])
def test_speculative_engine_matches_reference(jax_ref, port_model, drafts):
    ref = _ref_engine(jax_ref, page_size=4, speculate_k=4)
    eng = _engine(port_model, page_size=4, speculate_k=4)
    eng._noise_override = _reference_noise(jax_ref)
    if drafts == "never":
        ref._draft_override = lambda d: (np.asarray(d) + 1) % 97
        eng._draft_override = lambda d: (np.asarray(d) + 1) % 97
    want = _served(ref, _trace(jax_ref["engine"].poisson_trace))
    got = _served(eng, _trace())
    _assert_same_stream(got, want)
    s, rs = eng.metrics.summary(), ref.metrics.summary()
    for k in ("spec_rounds", "verify_passes", "draft_passes",
              "accepted_draft_tokens", "decode_passes"):
        assert s[k] == rs[k], k
    assert (s["accepted_draft_tokens"] == 0) == (drafts == "never")


# ---------------------------------------------------------------------------
# Port against port
# ---------------------------------------------------------------------------
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


@pytest.mark.parametrize("page_size", PAGES)
@pytest.mark.parametrize("mode", ["accept", "never", "gated", "eos"])
def test_speculative_equals_plain(port_model, plain, mode, page_size):
    """speculate_k 4 serves the plain engine's stream: natural drafts
    under OPEN (every draft accepted), drafts forced to mismatch (none
    accepted), MI-gated escalations deferred out of mid-block, eos served
    mid-block."""
    router = "gated" if mode == "gated" else "open"
    kw = dict(eos_id=EOS) if mode == "eos" else {}
    want = plain(page_size, router, **kw)
    eng = _engine(port_model, page_size=page_size, router=router,
                  speculate_k=4, **kw)
    if mode == "never":
        eng._draft_override = lambda d: (d + 1) % 97
    _assert_bit_for_bit(_served(eng, _trace()), want)
    m = eng.metrics.summary()
    assert m["decode_passes"] == 0         # every token came from a verify
    if mode == "accept":
        assert m["draft_acceptance_rate"] == 1.0
        assert m["pfp_passes_per_token"] < 1.0
    if mode == "never":
        assert m["accepted_draft_tokens"] == 0
    if mode == "gated":
        assert m["escalations"] > 0
        assert m["max_svi_passes_per_step"] <= 1
        _assert_bit_for_bit(plain(page_size, router,
                                  batch_escalations=False), want)
    if mode == "eos":
        assert any(v[2] == "eos" for v in want.values())


@pytest.mark.parametrize("page_size", PAGES)
def test_batched_escalation_equals_sequential(port_model, plain, page_size):
    """One call a step for every escalating slot, each run through the
    sequential program at its shape: the same stream bit for bit, MI
    included, with fewer SVI calls."""
    seq_eng = _engine(port_model, page_size=page_size, router="force",
                      batch_escalations=False)
    seq = _served(seq_eng, _trace())
    bat_eng = _engine(port_model, page_size=page_size, router="force")
    assert _served(bat_eng, _trace()) == seq
    ms, mb = seq_eng.metrics.summary(), bat_eng.metrics.summary()
    assert ms["escalations"] == mb["escalations"] > 0
    assert ms["svi_passes"] == ms["escalations"]
    assert mb["max_svi_passes_per_step"] <= 1
    assert mb["svi_passes"] < ms["svi_passes"]
    assert mb["mean_escalation_batch"] > 1.0


@pytest.mark.parametrize("page_size", PAGES)
def test_speculative_with_escalations_equals_plain(port_model, plain,
                                                   page_size):
    want = plain(page_size, "force", batch_escalations=False)
    eng = _engine(port_model, page_size=page_size, router="force",
                  speculate_k=4)
    _assert_bit_for_bit(_served(eng, _trace()), want)
    m = eng.metrics.summary()
    assert m["max_svi_passes_per_step"] <= 1 and m["escalations"] > 0


def test_speculative_accounting_low_uncertainty(port_model):
    """A low-uncertainty trace: fewer than one full-PFP pass per served
    token and no SVI pass."""
    eng = _engine(port_model, speculate_k=4)
    _served(eng, _trace(n=8))
    m = eng.metrics.summary()
    assert m["svi_passes"] == 0
    assert m["verify_passes"] == m["spec_rounds"]
    assert m["pfp_passes_per_token"] < 1.0
    assert m["accepted_tokens_per_verify"] > 0
    assert m["draft_acceptance_rate"] == 1.0
    assert m["decode_passes"] == 0


@pytest.mark.parametrize("batch", [True, False], ids=["batched", "seq"])
@pytest.mark.parametrize("page_size", PAGES)
def test_prefix_shared_escalations_equal_cold(port_model, page_size, batch):
    """Escalations right after a prefix-shared prefill replay the same
    window as a cold prefill's. One token after the 9-token system prompt
    makes the last prefill window reach below the shared prefix, which the
    replay rewrites too."""
    budget = {MAX_LEN: 5}.get(page_size)
    kw = dict(page_size=page_size, page_budget=budget, router="force",
              batch_escalations=batch)
    trace = functools.partial(_common_prefix_trace, tail_len=1)
    want = _served(_engine(port_model, **kw), trace())
    eng = _engine(port_model, prefix_sharing=True, **kw)
    _assert_bit_for_bit(_served(eng, trace()), want)
    s = eng.metrics.summary()
    assert s["escalations"] > 0 and s["prefix_hits"] > 0
    assert s["final_live_pages"] == s["final_prefix_held_pages"]


@pytest.mark.parametrize("prefix_sharing", [False, True])
def test_escalation_after_preemption_equals_reserving(port_model,
                                                      prefix_sharing):
    trace_kw = dict(n=8, prefix_len=8, tail_len=4, max_new=6)
    want = _served(_engine(port_model, page_size=2, router="force"),
                   _common_prefix_trace(**trace_kw))
    eng = _engine(port_model, page_size=2, router="force",
                  reserve_pages=False, page_budget=14,
                  prefix_sharing=prefix_sharing)
    _assert_bit_for_bit(_served(eng, _common_prefix_trace(**trace_kw)),
                        want)
    s = eng.metrics.summary()
    assert s["preemptions"] > 0 and s["escalations"] > 0


def _count_replays_after(eng, name):
    """Wrap ``eng.<name>`` (defrag or compact) and ``eng._replay_for``:
    the returned list gets the slot of every escalation that replays
    against ``_prev_states`` in the step right after that call moved the
    pool's pages or slots."""
    hits, moved = [], {}
    remap, replay_for = getattr(eng, name), eng._replay_for

    def wrapped():
        before = eng.pool.states
        remap()
        if eng._prev_states is not None and eng.pool.states is not before:
            moved["step"] = eng.now

    def replay(slot, sl):
        out = replay_for(slot, sl)
        if sl.replay is None and moved.get("step") == eng.now:
            hits.append(slot)
        return out

    setattr(eng, name, wrapped)
    eng._replay_for = replay
    return hits


def test_escalation_after_defrag(port_model):
    want = _served(_engine(port_model, page_size=2, router="force",
                           batch_escalations=False), _common_prefix_trace(n=6))
    eng = _engine(port_model, page_size=2, router="force",
                  batch_escalations=False, auto_defrag=True,
                  reserve_pages=False, page_budget=16)
    hits = _count_replays_after(eng, "defrag")
    _assert_bit_for_bit(_served(eng, _common_prefix_trace(n=6)), want)
    assert eng.metrics.summary()["defrags"] > 0 and hits


def test_escalation_after_compaction(port_model):
    trace = _trace(n=8)
    want = _served(_engine(port_model, page_size=None, router="force"),
                   copy.deepcopy(trace))
    eng = _engine(port_model, page_size=None, router="force",
                  auto_compact=True)
    hits = _count_replays_after(eng, "compact")
    _assert_bit_for_bit(_served(eng, trace), want)
    assert hits


@pytest.mark.parametrize("layout", [
    dict(page_size=None), dict(page_size=4),
    dict(page_size=4, speculate_k=4, router="gated")],
    ids=["contiguous", "paged", "paged-spec"])
def test_replay_reproduces_routed_logits(port_model, layout):
    """Before every routing: a PFP pass over each routed slot's replay
    (the stored chunk after prefill, the fed-token window after decode
    steps or, speculating, after a block deferred an escalation) gives
    its current logits bit for bit."""
    cfg, model = port_model
    eng = _engine(port_model, **layout)
    ctx = Context(mode=Mode.PFP, device="cpu")
    route, seen = eng._route_and_decode, []

    def checked(now):
        for slot, sl in enumerate(eng._slots):
            if sl is None or sl.phase != "decode" or sl.pending is not None:
                continue
            state, inputs, out_idx = eng._replay_for(slot, sl)
            logits, _ = lm.decode_step(model, cfg, inputs, state, ctx)
            assert torch.equal(logits.mean[0, out_idx], eng._lm_mean[slot])
            assert torch.equal(logits.var[0, out_idx], eng._lm_var[slot])
            seen.append(sl.replay is None)
        route(now)

    eng._route_and_decode = checked
    _served(eng, _trace())
    assert True in seen and False in seen


def test_svi_fallback_is_one_object_per_key(port_model):
    cfg, _ = port_model
    svi_fallback_cache_clear()
    a = _engine(port_model, router="force")
    b = _engine(port_model, router="force")
    assert a.router._fallback is b.router._fallback
    assert make_svi_fallback(cfg, 2) is a.router._fallback
    assert make_svi_fallback(cfg, 2) is not make_svi_fallback(cfg, 3)
    assert make_svi_fallback(cfg, 2, formulation="var") is not \
        a.router._fallback
    _served(a, _trace(n=3))
    assert a.router._fallback_batched is make_svi_fallback_batched(cfg, 2)
    svi_fallback_cache_clear()
    assert make_svi_fallback(cfg, 2) is not a.router._fallback


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_speculative_equals_plain_on_card():
    """The reduced model drawn on the card (no JAX): speculation, with and
    without escalations, serves the plain engine's stream bit for bit, MI
    included, through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda")
    cfg = dataclasses.replace(reduced_config(ARCH), sigma_init=SIGMA)
    model = svi_to_pfp(lm.init_params(
        cfg, generator=torch.Generator(device=cuda).manual_seed(0),
        device=cuda))

    def run(router, **kw):
        eng = Engine(cfg, model, EngineConfig(
            slots=SLOTS, max_len=MAX_LEN, num_uncertainty_samples=SAMPLES,
            impl="kernel", page_size=4, **kw),
            router=UncertaintyRouter(cfg, RouterConfig(**ROUTERS[router])),
            scheduler=RequestScheduler(SchedulerConfig(
                prefill_chunk=CHUNK, prefill_budget=BUDGET)))
        return _served(eng, _trace()), eng.metrics.summary()

    for router in ("open", "force"):
        want, _ = run(router)
        reset_launch_counts()
        got, m = run(router, speculate_k=4)
        assert got == want
        assert m["decode_passes"] == 0 and m["verify_passes"] > 0
        assert LAUNCHES["attention_paged"] > 0 and LAUNCHES["dense"] > 0
