"""The port's SVI escalation and uncertainty-speculative decoding against
the reference, and batched escalation against sequential.

The setting (``tests/torch_engine_spec_common.py``): reduced granite-8b
(d_model 64, 2 layers, vocab 97; sigma_init 1e-3), one JAX init converted
and carried across with ``load_numpy_params``; 3 slots of 24 rows, prefill
windows of 3, 6 prompt tokens a step; the reference's routers of
``tests/test_speculative.py`` and its tolerance ``MI_ATOL``.

Against the reference, with both noises handed in: the engine's Eq. 11
noise through ``Engine._noise_override`` and the second opinion's weight
noise through ``Engine._svi_eps_override``, the reference's per-leaf keys
rebuilt by ``tests/torch_reference_noise.py``. Compared: the second
opinion (tokens equal, MI within ``MI_ATOL``, each sample's logits at the
model tolerance), the contiguous escalating engine (tokens, finish
reasons, escalation counts and trace events equal, MI within ``MI_ATOL``)
and the paged speculative engine (tokens, finish reasons and pass counts
equal). The reference's paged escalation tests fail on this tree, so its
paged engine is no oracle for escalation. Port against port at pages of
1, 4 and 24: batched escalation == sequential, bit for bit, MI included.
Also: the SVI fallback program is one object per key. The ``gpu`` test holds speculative == plain bit
for bit on the card. The port-against-port invariants are in
``test_torch_engine_spec_speculative.py`` and
``test_torch_engine_spec_replay.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bayes.convert import svi_to_pfp
from repro_torch.configs import reduced_config
from repro_torch.core.modes import Mode
from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
from repro_torch.models import lm
from repro_torch.nn.module import Context
from repro_torch.obs.trace import Tracer
from repro_torch.serving.engine import (Engine, EngineConfig,
                                        RequestScheduler, RouterConfig,
                                        SchedulerConfig, UncertaintyRouter,
                                        make_svi_fallback,
                                        make_svi_fallback_batched,
                                        svi_fallback_cache_clear)
from torch_engine_spec_common import (  # noqa: F401  (fixtures)
    ARCH, BUDGET, CHUNK, MAX_LEN, MI_ATOL, LOGIT_TOL, PAGES, ROUTERS,
    SAMPLES, SIGMA, SLOTS, _assert_same_stream, _engine, _ref_engine,
    _reference_noise, _reference_svi_eps, _served, _trace, jax_ref, plain,
    port_model, schedule)
from torch_reference_noise import ReferenceLMEps

# torch's intra-op threads, for the whole process: each pytest-xdist
# worker imports every test file, so this holds for every test a worker
# runs. Six workers on 8 CPUs at torch's default of 8 threads each
# oversubscribed the cores: the port's test files took 2669 test-seconds
# in one run of the whole suite with `-n 6 --dist loadfile` on an 8-CPU
# machine, and 804 with one thread. Results compared within a process do
# not depend on it.
torch.set_num_threads(1)

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
    eps = [ReferenceLMEps(k, schedule)
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
        eps=ReferenceLMEps(k0, schedule)))
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
