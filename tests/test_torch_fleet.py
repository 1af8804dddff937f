"""The port's multi-replica fleet against the JAX package's, and against
its own single engine.

One reduced granite-8b (d_model 64, 4 heads of 16, 2 KV heads, vocab 97,
2 layers; sigma_init 1e-3) is drawn in the port from seed 0 and converted
by the port's ``svi_to_pfp``; the reference gets the same converted tree
(``numpy_params``), so no JAX init runs. Engines have 3 slots of 24 rows,
prefill windows of 3 and 6 prompt tokens a step, as the reference's own
tests/test_fleet.py.

Pure-Python parts: ``PrefixRouter``, ``FleetMetrics`` and
``pooled_handoff_gauges`` against the reference's on the same call
sequences (equal results). ``prefix_peek`` is read-only. ``DisaggPair``
refuses a contiguous pool, no prefix sharing and ``auto_defrag`` (the
reference's three ``ValueError``s); its decode engine prefills one token a
request, and every pool drains with ``page_ref == external_holds``.

Port against port, bit for bit (tokens, MI floats, finish reasons): a
2-replica fleet, replicated and disaggregated, at pages of 1 and 16,
equals a single engine; so does a disaggregated run that escalates every
token to a 2-sample SVI second opinion; two identical fleet runs give byte-identical
JSONL traces. A request's MI is the same in every slot: the fault the
fleet found (the sample means of ``predictive_metrics_from_samples``
reduced over the (N, B, K) layout on the CPU, so a row's sums depended on
its slot) has its own test.

Port against the reference: the port's replicated and disaggregated
2-replica fleets at pages of 16, with the reference's Eq. 11 noise handed
in through ``Engine._noise_override``, against the reference's replicated
fleet: tokens and finish reasons equal, MI within MI_TOL (rtol 1e-2 /
atol 1e-5, tests/test_torch_engine.py's), the replicated fleet's routing
counters equal. The reference's disaggregated fleet cannot be the
oracle: two identical runs of it in one process can serve different
tokens (ROADMAP.md queue C), while its replicated fleet repeats.

The ``gpu`` tests run both fleet modes under the kernel impl on the card
against a single engine, bit for bit, and skip where there is none.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.bayes.convert import svi_to_pfp
from repro_torch.bayes.metrics import predictive_metrics_from_samples
from repro_torch.configs import reduced_config
from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
from repro_torch.models import lm
from repro_torch.nn.module import numpy_params
from repro_torch.obs.trace import Tracer
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import (Engine, EngineConfig, EngineMetrics,
                                        PagedDecodeStatePool, PrefixIndex,
                                        RequestScheduler, RouterConfig,
                                        SchedulerConfig, UncertaintyRouter,
                                        run_load)
from repro_torch.serving.fleet import (DisaggPair, Fleet, FleetConfig,
                                       PrefixRouter, pooled_handoff_gauges)
from repro_torch.serving.fleet import handoff as handoff_mod
from repro_torch.serving.fleet import metrics as fleet_metrics_mod

ARCH = "granite-8b"
SIGMA = 1e-3
SLOTS, MAX_LEN, SAMPLES, SEED = 3, 24, 8, 0
CHUNK, BUDGET = 3, 6
MI_TOL = dict(rtol=1e-2, atol=1e-5)
OPEN = dict(mi_continue=1e9, mi_abstain=2e9, escalate_samples=0)
ESCALATE = dict(mi_continue=-1.0, mi_abstain=1e9, escalate_samples=2,
                svi_mi_abstain=1e9)


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(reduced_config(ARCH), sigma_init=SIGMA)
    return cfg, svi_to_pfp(lm.init_params(
        cfg, generator=torch.Generator().manual_seed(0), device="cpu"))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's fleet, engine and obs modules, imported only
    where a test needs them."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.serving import batcher as jbatcher
    from repro.serving import engine as jengine
    from repro.serving import fleet as jfleet
    from repro.serving.fleet import metrics as jfleet_metrics
    return dict(jax=jax, jnp=jnp, engine=jengine, fleet=jfleet,
                fleet_metrics=jfleet_metrics, batcher=jbatcher,
                cfg=dataclasses.replace(jreduced(ARCH), sigma_init=SIGMA))


@pytest.fixture(scope="module")
def baseline(model):
    """page_size -> a single engine's output on ``_trace()``, run once."""
    runs = {}

    def get(page_size):
        if page_size not in runs:
            runs[page_size] = _served(
                _single(model, page_size, _router(model[0])), _trace())
        return runs[page_size]
    return get


def _sched():
    return SchedulerConfig(prefill_chunk=CHUNK, prefill_budget=BUDGET)


def _router(cfg, **kw):
    return UncertaintyRouter(cfg, RouterConfig(**(kw or OPEN)))


def _ecfg(page_size, **kw):
    return EngineConfig(slots=SLOTS, max_len=MAX_LEN,
                        num_uncertainty_samples=SAMPLES, seed=SEED,
                        page_size=page_size, prefix_sharing=True, **kw)


def _trace(req=Request, n=6, prefix_len=9, tail_len=3, max_new=4):
    """Requests opening with one of two system prompts (even and odd
    uids), arrivals spaced so early finishers seed the prefix locality
    the router then routes on: the first of each kind goes to the least
    loaded replica, later ones follow their prefix, so both replicas
    serve."""
    systems = [np.arange(1, prefix_len + 1, dtype=np.int32),
               np.arange(20, 20 + prefix_len, dtype=np.int32)]
    return [req(uid=i,
                prompt=np.concatenate(
                    [systems[i % 2], np.full(tail_len, 50 + i, np.int32)]),
                max_new_tokens=max_new, arrival=float(2 * i))
            for i in range(n)]


def _served(eng, trace, max_steps=4000):
    run_load(eng, trace, max_steps=max_steps)
    return {r.uid: (list(r.generated), [float(m) for m in r.mi_trace],
                    r.finish_reason) for r in eng.finished}


def _single(model, page_size, router, **kw):
    cfg, m = model
    return Engine(cfg, m, _ecfg(page_size, **kw), router=router,
                  scheduler=RequestScheduler(_sched(), max_len=MAX_LEN),
                  device="cpu")


def _fleet(model, page_size, router, disaggregate, tracer=None, **kw):
    cfg, m = model
    return Fleet(cfg, m, _ecfg(page_size, **kw),
                 FleetConfig(replicas=2, disaggregate=disaggregate),
                 router=router, scheduler_config=_sched(), device="cpu",
                 tracer=tracer)


def _assert_drained(pool):
    pool.check_invariants()
    for p in range(1, pool.num_pages):
        assert pool.page_ref[p] == pool.external_holds[p], (
            f"page {p} leaked a reference beyond its index holds")


# ---------------------------------------------------------------------------
# Pure-Python parts against the reference
# ---------------------------------------------------------------------------
class _FakeReplica:
    def __init__(self, peek, load):
        self._peek, self.load = peek, load

    def prefix_peek(self, tokens):
        return self._peek


_ROUTE_CASES = (
    (1, [(3, 0), (6, 9)]),              # longest prefix wins over load
    (1, [(4, 5), (4, 0)]),              # ties: lowest index
    (1, [(0, 2), (0, 1), (0, 1)]),      # nothing cached: least loaded
    (5, [(4, 9), (0, 0)]),              # shorter than min_tokens: load
    (2, [(2, 3), (1, 0), (2, 1)]),
    (3, [(0, 0)]),
)


@pytest.mark.parametrize("min_tokens,replicas", _ROUTE_CASES)
def test_prefix_router_matches_reference(jax_ref, min_tokens, replicas):
    prompt = np.arange(8, dtype=np.int32)
    fakes = [_FakeReplica(p, load) for p, load in replicas]
    got = PrefixRouter(min_tokens).route(Request(uid=0, prompt=prompt),
                                         fakes)
    want = jax_ref["fleet"].PrefixRouter(min_tokens).route(
        jax_ref["batcher"].Request(uid=0, prompt=prompt), fakes)
    assert got == want
    with pytest.raises(ValueError, match="min_tokens"):
        PrefixRouter(0)


def _fleet_metrics_ops(mod, pooled):
    """One scripted sequence of routes and steps over fake replica
    summaries and pairs; returns the summary without its wall-clock
    entries."""
    reps = [{"tokens_generated": 7, "prefill_tokens": 30, "finished": 2,
             "completed": 2, "prefix_hits": 1, "prefix_misses": 1,
             "band_continue": 7, "throughput_tok_s": 1.5,
             "p50_latency_steps": 4.0, "p99_latency_steps": 6.0},
            {"tokens_generated": 5, "prefill_tokens": 12, "finished": 1,
             "completed": 1, "escalations": 2, "escalate_abstain": 1,
             "cow_copies": 3}]

    class Pair:
        def __init__(self, lat, overlap):
            self.handoff_latencies, self.overlap_steps = lat, overlap

    pairs = [Pair([0, 2, 1], 3), Pair([5], 1)]
    m = mod.FleetMetrics(2, lambda: reps, lambda: pooled(pairs))
    for i, (replica, matched, hit, ok) in enumerate(
            [(0, 0, False, True), (1, 9, True, True), (0, 4, True, False),
             (1, 12, True, True), (1, 0, False, True)]):
        m.on_route(replica, matched, hit, ok)
        m.on_step((i % 3, 2 - i % 2))
    out = m.summary()
    for key in ("elapsed_s", "throughput_tok_s"):
        out.pop(key)
    return out, m.route_hit_rate, m.registry.snapshot()


def test_fleet_metrics_match_reference(jax_ref):
    got = _fleet_metrics_ops(fleet_metrics_mod, pooled_handoff_gauges)
    want = _fleet_metrics_ops(jax_ref["fleet_metrics"],
                              jax_ref["fleet_metrics"].pooled_handoff_gauges)
    assert got == want
    assert fleet_metrics_mod._SUM_KEYS == jax_ref["fleet_metrics"]._SUM_KEYS
    assert handoff_mod.DisaggPair._SUM_KEYS == \
        jax_ref["fleet"].DisaggPair._SUM_KEYS
    assert handoff_mod.SHADOW_UID_BASE == jax_ref["fleet"].SHADOW_UID_BASE


def test_engine_summary_has_every_key_the_fleet_sums(jax_ref):
    """The fleet and the pair sum these engine counters; the port's
    EngineMetrics summary has every one, and the reference's keys."""
    keys = set(EngineMetrics().summary())
    assert set(fleet_metrics_mod._SUM_KEYS) <= keys
    assert set(DisaggPair._SUM_KEYS) <= keys
    assert set(jax_ref["engine"].EngineMetrics().summary()) <= keys


def test_prefix_peek_is_read_only(model):
    """Routing probes must not bump recency: after many peeks at the LRU
    lineage, a retention eviction still removes IT, not the fresher one."""
    cfg, _ = model
    pool = PagedDecodeStatePool(cfg, num_slots=3, max_len=MAX_LEN,
                                page_size=2, num_pages=16, device="cpu")
    index = PrefixIndex(2, retention_pages=2)
    old = np.asarray([1, 2], np.int32)
    for slot_uid, tokens in enumerate([old, np.asarray([3, 4], np.int32)]):
        s = pool.alloc(slot_uid)
        assert pool.ensure_capacity(s, 2)
        index.insert(tokens, pool.slot_pages[s], pool)
        pool.evict(s)
    for _ in range(5):
        assert index.peek(old) == 2          # probe the LRU lineage hard
    c = pool.alloc(2)
    assert pool.ensure_capacity(c, 2)
    index.insert(np.asarray([5, 6], np.int32), pool.slot_pages[c], pool)
    pool.evict(c)
    assert index.peek(old) == 0              # ...it was still the victim
    assert index.peek(np.asarray([3, 4], np.int32)) == 2
    index.clear(pool)
    pool.check_invariants()


# ---------------------------------------------------------------------------
# DisaggPair
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config,match", [
    (EngineConfig(slots=2, max_len=MAX_LEN, prefix_sharing=True), "paged"),
    (EngineConfig(slots=2, max_len=MAX_LEN, page_size=4), "prefix"),
    (_ecfg(4, auto_defrag=True), "auto_defrag"),
])
def test_disagg_pair_refusals(model, config, match):
    cfg, m = model
    with pytest.raises(ValueError, match=match):
        DisaggPair(cfg, m, config, device="cpu")


def test_disagg_pair_decode_prefills_one_token_per_request(model):
    """The handoff contract: the prefill engine fills the whole prompt;
    the decode engine maps those pages through the shared index and
    prefills exactly ONE token per request, independent of prompt
    length — and the shared pool drains clean."""
    cfg, m = model
    pair = DisaggPair(cfg, m, _ecfg(4), router=_router(cfg),
                      scheduler_config=_sched(), device="cpu")
    trace = _trace()
    got = _served(pair, trace)
    assert set(got) == {r.uid for r in trace}
    s = pair.summary()
    n = len(trace)
    assert s["handoffs"] == n
    assert s["decode_engine_prefill_tokens"] == n
    assert s["prefill_engine_prefill_tokens"] > n
    assert s["finished"] == n and s["final_occupancy"] == 0
    assert s["submitted"] == n and s["rejected"] == 0
    assert pair.pool.live == 0
    _assert_drained(pair.pool)
    pair.prefix.check_invariants(pair.pool)
    # one remap listener for the shared index
    assert len(pair.pool._remap_listeners) == 1


# ---------------------------------------------------------------------------
# Port against port, bit for bit
# ---------------------------------------------------------------------------
def test_mi_of_a_row_does_not_depend_on_its_slot():
    """The same logit samples in every slot of a batch give the same
    bits: the sample means run over a (B, N, K) copy (before the fix a
    request's MI on the CPU changed with its slot, and a fleet that placed
    it in another slot than the single engine did differed in the last
    bit)."""
    gen = torch.Generator().manual_seed(0)
    for n, b, k in ((8, 3, 97), (8, 7, 97), (32, 4, 1000), (5, 9, 10)):
        row = torch.randn((n, k), generator=gen)
        want = None
        for slot in range(b):
            samples = torch.randn((n, b, k), generator=gen)
            samples[:, slot] = row
            m = predictive_metrics_from_samples(samples)
            got = [m[key][slot] for key in ("mi", "total", "aleatoric",
                                            "mean_probs", "pred")]
            if want is None:
                want = got
            assert all(torch.equal(g, w) for g, w in zip(got, want)), \
                (n, b, k, slot)


@pytest.mark.parametrize("page_size", [1, 16])
@pytest.mark.parametrize("disaggregate", [False, True])
def test_fleet_two_replicas_bitforbit_single_engine(model, baseline,
                                                    page_size, disaggregate):
    want = baseline(page_size)
    fleet = _fleet(model, page_size, _router(model[0]), disaggregate)
    got = _served(fleet, _trace())
    # EXACT equality — tokens and MI floats
    assert got == want
    s = fleet.metrics.summary()
    assert s["final_occupancy"] == 0
    assert s["route_prefix_hits"] > 0
    assert s["route_prefix_hits"] + s["route_fallbacks"] == len(want)
    assert min(s["per_replica_tokens"]) > 0       # both replicas served
    assert s["throughput_tok_s"] == pytest.approx(
        sum(s["per_replica_throughput_tok_s"]))
    if disaggregate:
        assert s["handoffs"] == len(want)
    for rep in fleet.replicas:
        _assert_drained(rep.pool)
        rep.prefix.check_invariants(rep.pool)


def test_disaggregated_fleet_escalating_bitforbit_single_engine(model):
    """Every token escalates to a 2-sample SVI second opinion. In a pair
    the decode engine replays against its own snapshot of the SHARED pool,
    which the prefill engine writes between its steps: the replay still
    gives a single engine's bits."""
    cfg, _ = model
    router = _router(cfg, **ESCALATE)
    trace = functools.partial(_trace, n=4, max_new=3)
    single = _single(model, 4, router)
    want = _served(single, trace())
    fleet = _fleet(model, 4, router, True)
    assert _served(fleet, trace()) == want
    s = fleet.metrics.summary()
    assert s["escalations"] == single.metrics.summary()["escalations"] > 0


def test_fleet_traces_are_byte_identical(model):
    cfg, _ = model
    lines = []
    for _ in range(2):
        tracer = Tracer()
        _served(_fleet(model, 16, _router(cfg), True, tracer=tracer),
                _trace())
        lines.append(tracer.to_jsonl())
    assert lines[0] == lines[1]
    events = [json.loads(line) for line in lines[0].splitlines()]
    # one tracer: the frontend, each pair (its handoffs) and its engines
    assert {e["lane"] for e in events} == {
        "fleet", "r0", "r1", "r0.prefill", "r0.decode", "r1.prefill",
        "r1.decode"}
    # a request's routing precedes its admission
    first = {}
    for e in events:
        if e["event"] in ("route_replica", "submit") and \
                e["uid"] < handoff_mod.SHADOW_UID_BASE:
            first.setdefault(e["uid"], e["event"])
    assert set(first.values()) == {"route_replica"}


# ---------------------------------------------------------------------------
# Port against the reference
# ---------------------------------------------------------------------------
def _reference_noise(jax_ref):
    """The reference engine's Eq. 11 noise of (uid, token index)."""
    jax, jnp = jax_ref["jax"], jax_ref["jnp"]
    key = jax.random.PRNGKey(SEED)

    @functools.lru_cache(maxsize=None)
    def noise(uid, tok_idx):
        k = jax.random.fold_in(jax.random.fold_in(key, uid & 0x7FFFFFFF),
                               tok_idx)
        k_samp, _ = jax.random.split(k)
        return np.asarray(jax.random.normal(k_samp, (SAMPLES, 1, 97),
                                            jnp.float32))
    return noise


def test_fleet_matches_reference(jax_ref, model):
    """The port's replicated and disaggregated fleets (pages of 16, the
    reference's noise) against the reference's replicated fleet: tokens
    and finish reasons equal, MI within MI_TOL; the replicated fleet
    routes as the reference's does. The reference's disaggregated fleet
    is no oracle on this tree: two identical runs in one process can
    serve different tokens (ROADMAP.md queue C)."""
    cfg, m = model
    E, F = jax_ref["engine"], jax_ref["fleet"]
    params = jax_ref["jax"].tree_util.tree_map(jax_ref["jnp"].asarray,
                                               numpy_params(m))
    jfleet = F.Fleet(
        jax_ref["cfg"], params,
        E.EngineConfig(slots=SLOTS, max_len=MAX_LEN,
                       num_uncertainty_samples=SAMPLES, seed=SEED,
                       page_size=16, prefix_sharing=True),
        F.FleetConfig(replicas=2),
        router=E.UncertaintyRouter(jax_ref["cfg"], E.RouterConfig(**OPEN)),
        scheduler_config=E.SchedulerConfig(prefill_chunk=CHUNK,
                                           prefill_budget=BUDGET))
    want = _served(jfleet, _trace(jax_ref["batcher"].Request))
    js = jfleet.metrics.summary()
    noise = _reference_noise(jax_ref)
    for disaggregate in (False, True):
        fleet = _fleet(model, 16, _router(cfg), disaggregate)
        for rep in fleet.replicas:
            for eng in getattr(rep, "engines", (rep,)):
                eng._noise_override = noise
        got = _served(fleet, _trace())
        assert set(got) == set(want)
        for uid, (toks, mi, reason) in want.items():
            assert got[uid][0] == toks and got[uid][2] == reason, uid
            np.testing.assert_allclose(got[uid][1], mi, **MI_TOL)
        s = fleet.metrics.summary()
        assert s["tokens_generated"] == js["tokens_generated"]
        if not disaggregate:
            for key in ("route_prefix_hits", "route_fallbacks",
                        "route_tokens_matched", "prefill_tokens",
                        "prefill_tokens_saved", "cow_copies", "steps",
                        "per_replica_tokens"):
                assert s[key] == js[key], key


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda")
    cfg = dataclasses.replace(reduced_config(ARCH), sigma_init=SIGMA)
    return cfg, svi_to_pfp(lm.init_params(
        cfg, generator=torch.Generator(device=device).manual_seed(0),
        device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("disaggregate", [False, True])
def test_fleet_on_card_bitforbit_single_engine(card_model, disaggregate):
    cfg, m = card_model
    router = UncertaintyRouter(cfg, RouterConfig(**OPEN), impl="kernel")
    config = _ecfg(16, impl="kernel")
    single = Engine(cfg, m, config, router=router,
                    scheduler=RequestScheduler(_sched(), max_len=MAX_LEN))
    want = _served(single, _trace())
    reset_launch_counts()
    fleet = Fleet(cfg, m, config,
                  FleetConfig(replicas=2, disaggregate=disaggregate),
                  router=router, scheduler_config=_sched())
    assert _served(fleet, _trace()) == want
    assert LAUNCHES["attention_paged"] > 0 and LAUNCHES["dense"] > 0
    for rep in fleet.replicas:
        _assert_drained(rep.pool)
