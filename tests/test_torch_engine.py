"""The port's continuous-batching serving engine against the JAX package's.

Pure-Python parts (scheduler, radix prefix index, metric registry,
tracer, uncertainty telemetry, load generator): the same operation
sequences go through ``repro.serving.engine`` / ``repro.obs`` and the
port's copies; every result must be equal.

Engine: one JAX init of the reduced granite-8b (d_model 64, 4 heads of
16, 2 KV heads, d_ff 128, vocab 97, 2 layers; sigma_init 1e-3, as
tests/test_serving_engine.py has it), converted, is carried across with
``load_numpy_params``. The same requests go through the reference's
``Engine`` (``impl=None``, ``escalate_samples=0``) and the port's
(``device="cpu"``), contiguous and paged. The port draws each token's
Eq. 11 noise from a generator keyed by (seed, uid, token index); here
its test hook hands it the reference's own noise instead
(``fold_in(fold_in(key(seed), uid), tok_idx)``, split, ``normal``).
Tokens, finish reasons and the trace's event sequence must be equal, MI
within ``_parity``'s variance tolerance (rtol 1e-2 / atol 1e-5): MI is
about 1e-4 here, the difference of two entropies near log(97) = 4.57,
so fp32 rounding alone moves it by about 1e-6. The reference's
own paged-engine bit tests fail on this tree (ROADMAP.md queue C), so it
is a tolerance oracle only.

Port against port, bit for bit: paged == contiguous, prefix-shared ==
cold (pages of 1, 4 and max_len), preempting == reserving, auto-defrag
and compaction transparent; a 40-request load drains with no slot or
page left. The ``gpu`` tests run the engine on the card, kernel against
eager, and skip where there is none.
"""
import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.bayes.convert import svi_to_pfp
from repro_torch.configs import reduced_config
from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
from repro_torch.models import lm
from repro_torch.nn.module import load_numpy_params
from repro_torch.obs.trace import Tracer
from repro_torch.serving.batcher import Request
from repro_torch.serving.engine import (Decision, DecodeStatePool, Engine,
                                        EngineConfig, PagedDecodeStatePool,
                                        PrefixIndex, RequestScheduler,
                                        RouterConfig, SchedulerConfig,
                                        UncertaintyRouter, engine as engine_mod,
                                        percentile, poisson_trace, run_load)

ARCH = "granite-8b"
SIGMA = 1e-3
SLOTS, MAX_LEN, SAMPLES, SEED = 3, 24, 8, 0
CHUNK, BUDGET = 3, 6
MI_TOL = dict(rtol=1e-2, atol=1e-5)      # _parity's variance tolerance
OPEN = dict(mi_continue=1e9, mi_abstain=2e9, escalate_samples=0)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's modules and the reduced model, imported only
    where a test needs them."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro import obs as jobs
    from repro.bayes.convert import svi_to_pfp
    from repro.configs import reduced_config as jax_reduced_config
    from repro.models import lm as jlm
    from repro.serving import batcher as jbatcher
    from repro.serving import engine as jengine
    from repro.serving.engine import state as jstate
    cfg = dataclasses.replace(jax_reduced_config(ARCH), sigma_init=SIGMA)
    params = svi_to_pfp(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    return dict(jax=jax, jnp=jnp, obs=jobs, engine=jengine, state=jstate,
                batcher=jbatcher, cfg=cfg, params=params,
                tree=jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture(scope="module")
def port_model(jax_ref):
    cfg = dataclasses.replace(reduced_config(ARCH), sigma_init=SIGMA)
    return cfg, load_numpy_params(lm.init_params(cfg, device="cpu"),
                                  jax_ref["tree"])


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


def _engine(model, *, router=None, sched=None, tracer=None, slots=SLOTS,
            pool=None, prefix=None, **kw):
    cfg, m = model
    return Engine(cfg, m, EngineConfig(slots=slots, max_len=MAX_LEN,
                                       num_uncertainty_samples=SAMPLES,
                                       seed=SEED, **kw),
                  router=UncertaintyRouter(cfg, RouterConfig(**(router or
                                                                 OPEN))),
                  scheduler=RequestScheduler(sched or SchedulerConfig(
                      prefill_chunk=CHUNK, prefill_budget=BUDGET)),
                  pool=pool, prefix=prefix, tracer=tracer, device="cpu")


def _ref_engine(jax_ref, *, router=None, tracer=None, **kw):
    E = jax_ref["engine"]
    return E.Engine(
        jax_ref["cfg"], jax_ref["params"],
        E.EngineConfig(slots=SLOTS, max_len=MAX_LEN,
                       num_uncertainty_samples=SAMPLES, seed=SEED, **kw),
        router=E.UncertaintyRouter(jax_ref["cfg"],
                                   E.RouterConfig(**(router or OPEN))),
        scheduler=E.RequestScheduler(E.SchedulerConfig(
            prefill_chunk=CHUNK, prefill_budget=BUDGET)),
        tracer=tracer)


def _mixed_trace(n=6):
    """Requests of several prompt lengths, some queued behind full slots."""
    rng = np.random.default_rng(3)
    return [Request(uid=100 + i,
                prompt=rng.integers(0, 97, int(rng.integers(2, 12))).astype(
                    np.int32),
                max_new_tokens=int(rng.integers(1, 6)),
                priority=int(rng.integers(0, 2)), arrival=float(i // 2))
            for i in range(n)]


def _common_prefix_trace(n=6, prefix_len=9, tail_len=3, max_new=4):
    """Requests opening with one system prompt, arrivals spaced so early
    finishers become prefix donors for later arrivals."""
    system = np.arange(1, prefix_len + 1, dtype=np.int32)
    return [Request(uid=i,
                    prompt=np.concatenate(
                        [system, np.full(tail_len, 50 + i, np.int32)]),
                    max_new_tokens=max_new, arrival=float(2 * i))
            for i in range(n)]


def _served(eng, trace, max_steps=2000):
    run_load(eng, trace, max_steps=max_steps)
    eng.pool.check_invariants()
    if eng.prefix is not None:
        eng.prefix.check_invariants(eng.pool)
    return {r.uid: (list(r.generated), [float(m) for m in r.mi_trace],
                    r.finish_reason) for r in eng.finished}


# ---------------------------------------------------------------------------
# Pure-Python parts against the reference
# ---------------------------------------------------------------------------
def _scheduler_ops(mod, req_cls):
    """One scripted sequence of submits, pops, requeues and plans; returns
    everything observable."""
    s = mod.RequestScheduler(mod.SchedulerConfig(max_queue=5, aging_steps=2,
                                                 prefill_chunk=4,
                                                 prefill_budget=10),
                             max_len=16)
    rng = np.random.default_rng(7)
    reqs = [req_cls(uid=i, prompt=np.zeros(int(rng.integers(0, 9)), np.int32),
                    max_new_tokens=int(rng.integers(1, 9)),
                    priority=int(rng.integers(0, 4)),
                    deadline=(float(rng.integers(2, 9)) if i % 3 == 0
                              else None))
            for i in range(14)]
    log = []
    for now, req in enumerate(reqs):
        log.append(("submit", req.uid, s.submit(req, float(now))))
        if now % 2:
            got, expired = s.pop_ready(float(now), free_pages=6,
                                       page_size=2,
                                       reserve_pages=bool(now % 4 == 1))
            log.append(("pop", None if got is None else got.uid,
                        [e.uid for e in expired]))
            if got is not None and now % 3 == 0:
                displaced = s.requeue(got, float(now))
                log.append(("requeue", got.uid, None if displaced is None
                            else displaced.uid, got.preempted,
                            got.first_enqueue))
    while len(s):
        got, expired = s.pop_ready(30.0)
        log.append(("drain", got.uid, [e.uid for e in expired]))
    log.append(("plan", s.plan_prefill([(0, 9), (1, 3), (2, 6)])))
    log.append(("rounds", s.plan_prefill_rounds([(2, 9), (0, 1), (1, 13)])))
    log.append(("counts", s.rejected, s.expired, s.submitted,
                s.requeue_overflow))
    log.append(("pages", [mod.pages_for(r, 3, reserve=b) for r in reqs[:5]
                          for b in (True, False)]))
    return log


def test_scheduler_matches_reference(jax_ref):
    from repro_torch.serving.engine import scheduler
    got = _scheduler_ops(scheduler, Request)
    want = _scheduler_ops(jax_ref["engine"].scheduler,
                          jax_ref["batcher"].Request)
    assert got == want
    assert any(op[0] == "requeue" for op in got)
    assert any(op[0] == "pop" and op[2] for op in got)       # expiries


def test_pop_ready_page_need_override():
    s = RequestScheduler(SchedulerConfig())
    s.submit(Request(uid=0, prompt=np.zeros(8, np.int32), max_new_tokens=8),
             now=0)
    assert s.pop_ready(0, free_pages=3, page_size=4)[0] is None
    req, _ = s.pop_ready(0, free_pages=3, page_size=4,
                         page_need=lambda r: 3)
    assert req.uid == 0


def _churn_log(pool, index, seed):
    rng = np.random.default_rng(seed)
    ps = index.page_size
    bases = [rng.integers(0, 5, 20).astype(np.int32) for _ in range(3)]
    pool.add_remap_listener(index.remap_pages)
    log, uid, written = [], 0, {}
    for _ in range(60):
        op = int(rng.integers(0, 5))
        live = pool.live_slot_indices()
        if op <= 1 and pool.free_slots:
            base = bases[int(rng.integers(0, 3))]
            n = int(rng.integers(2, 20))
            tokens = np.concatenate([base[:n - 2],
                                     rng.integers(0, 5, 2).astype(np.int32)])
            pages, matched = index.match(tokens, limit=len(tokens) - 1)
            slot = pool.alloc(uid)
            uid += 1
            pool.share(slot, pages)
            ok = (pool.ensure_capacity(slot, len(tokens))
                  and pool.ensure_writable(slot, matched, len(tokens)))
            pool.positions[slot] = len(tokens) if ok else matched
            log.append(("admit", list(pages), matched, ok))
            if not ok:
                pool.evict(slot)
            else:
                written[slot] = tokens
        elif op == 2 and live:
            slot = live[int(rng.integers(0, len(live)))]
            tokens = written[slot][:int(pool.positions[slot])]
            log.append(("insert", index.insert(tokens, pool.slot_pages[slot],
                                               pool)))
            pool.evict(slot)
        elif op == 3:
            log.append(("reclaim", index.reclaim(pool, int(
                rng.integers(1, 3)))))
        else:
            perm = pool.defrag()
            log.append(("defrag", None if perm is None else perm.tolist()))
        log.append(("state", index.pages_held, pool.free_pages,
                    list(pool.page_ref), list(pool.external_holds)))
        pool.check_invariants()
        index.check_invariants(pool)
    peek = [index.peek(b, limit=len(b) - 1) for b in bases]
    index.clear(pool)
    pool.check_invariants()
    return log, peek, pool.held_pages


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_index_churn_matches_reference(jax_ref, seed):
    cfg = reduced_config(ARCH)
    pool = PagedDecodeStatePool(cfg, 3, 24, 4, num_pages=12, device="cpu")
    got = _churn_log(pool, PrefixIndex(4, 6), seed)
    jpool = jax_ref["state"].PagedDecodeStatePool(jax_ref["cfg"], 3, 24, 4,
                                                  num_pages=12)
    want = _churn_log(jpool, jax_ref["engine"].PrefixIndex(4, 6), seed)
    assert got == want
    ops = {entry[0] for entry in got[0]}
    assert {"admit", "insert", "reclaim", "defrag"} <= ops
    assert any(e[0] == "admit" and e[2] > 0 for e in got[0])   # hits
    assert got[2] == 0                                         # cleared


def test_poisson_trace_matches_reference(jax_ref):
    kw = dict(vocab_size=97, seed=11, prompt_len=(3, 30),
              max_new_tokens=(1, 9), priorities=(0, 1, 2), deadline=5.0)
    got = poisson_trace(25, 0.7, **kw)
    want = jax_ref["engine"].poisson_trace(25, 0.7, **kw)
    assert len(got) == len(want) == 25
    for g, w in zip(got, want):
        assert (g.uid, g.max_new_tokens, g.priority, g.deadline,
                g.arrival) == (w.uid, w.max_new_tokens, w.priority,
                               w.deadline, w.arrival)
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert g.prompt.dtype == w.prompt.dtype


def _registry_ops(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("requests", "served", labelnames=("kind",))
    g = reg.gauge("occupancy", "slots")
    h = reg.histogram("mi", (0.01, 0.1, 1.0), "nats")
    for i in range(9):
        c.labels(kind=("a", "b")[i % 2]).inc(i)
        g.set(i % 4)
        h.observe(0.003 * 7 ** (i % 5))
    reg.counter("requests")          # idempotent
    tel = mod.UncertaintyTelemetry(reg)
    tel.set_ood_threshold(0.5)
    for i in range(12):
        mi = 0.07 * i
        tel.on_decision(mi, ("continue", "escalate", "abstain")[i % 3])
        tel.on_escalation_outcome(mi, i % 4, mi / 2, i % 3,
                                  ("continue", "abstain")[i % 2])
    with pytest.raises(ValueError):
        reg.gauge("requests")
    return (reg.snapshot(), reg.to_prometheus({"engine": "e0"}),
            tel.summary(), tel.ece(), mod.percentile([3, 1, 2, 9], 50),
            mod.percentile([], 99))


def test_registry_and_telemetry_match_reference(jax_ref):
    got = _registry_ops(obs)
    want = _registry_ops(jax_ref["obs"])
    assert got == want
    assert got[2]["ood_alarms"] == 4 and got[3] > 0


def test_tracer_exports_match_reference(jax_ref, tmp_path):
    def emit(mod):
        t = mod.Tracer()
        lane = t.bind("r0")
        for step in range(4):
            lane.emit(step, "admit", uid=step, slot=step % 2)
            lane.emit(step, "route", uid=step, token=7, mi=0.25,
                      decision="continue")
            t.emit("fleet", step, "route_replica", uid=step, replica="r0")
            if step % 2:
                lane.emit(step + 1, "finish", uid=step, reason="length",
                          tokens=3)
        with pytest.raises(ValueError):
            t.emit("r0", 0, "nonsense")
        return t.to_jsonl(), t.to_chrome()
    assert emit(obs) == emit(jax_ref["obs"])
    t = Tracer(wall=True)
    t.bind("engine").emit(0, "submit", uid=1)
    assert "wall" in t.events[0] and "wall" not in t.to_jsonl(
        strip_wall=True)
    t.write_jsonl(str(tmp_path / "t.jsonl"))
    t.write_chrome(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").stat().st_size > 0


def test_metrics_percentile_and_stopwatch():
    assert percentile([5, 1, 4, 2, 3], 50) == 3.0
    assert percentile([5, 1, 4, 2, 3], 99) == 5.0
    clock = obs.Stopwatch()
    assert clock.elapsed() == 0.0 and not clock.started
    clock.start()
    with clock.frozen():
        a = clock.elapsed()
        assert clock.elapsed() == a


# ---------------------------------------------------------------------------
# The engine against the reference
# ---------------------------------------------------------------------------
def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("wall", "mi")}
            for e in events]


@pytest.mark.parametrize("layout", [
    dict(),                                        # contiguous
    dict(page_size=4),                             # paged, reserved
    dict(page_size=4, prefix_sharing=True),        # paged, shared prefix
])
def test_engine_matches_reference(jax_ref, port_model, layout):
    trace = _mixed_trace() + [
        dataclasses.replace(r, uid=r.uid + 50, arrival=r.arrival + 3)
        for r in _common_prefix_trace(n=4)]
    ref_tracer, tracer = jax_ref["obs"].Tracer(), Tracer()
    ref = _ref_engine(jax_ref, tracer=ref_tracer, **layout)
    want = _served(ref, [jax_ref["batcher"].Request(**{
        f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
        for r in copy.deepcopy(trace)])
    eng = _engine(port_model, tracer=tracer, **layout)
    eng._noise_override = _reference_noise(jax_ref)
    got = _served(eng, copy.deepcopy(trace))
    assert sorted(got) == sorted(want)
    for uid in want:
        assert got[uid][0] == want[uid][0], uid
        assert got[uid][2] == want[uid][2], uid
        np.testing.assert_allclose(got[uid][1], want[uid][1], **MI_TOL)
    assert _strip(tracer.events) == _strip(ref_tracer.events)
    mis = [(e["mi"], w["mi"]) for e, w in zip(tracer.events,
                                              ref_tracer.events)
           if e["event"] == "route"]
    assert mis
    np.testing.assert_allclose(*zip(*mis), **MI_TOL)
    s, rs = eng.metrics.summary(), ref.metrics.summary()
    assert set(s) == set(rs)
    for key, val in rs.items():
        if isinstance(val, int):
            assert s[key] == val, key
    if layout.get("prefix_sharing"):
        assert s["prefix_hits"] > 0 and s["cow_copies"] > 0


def test_engine_grey_zone_abstains_as_reference(jax_ref, port_model):
    """escalate_samples 0: every token between the thresholds abstains, on
    its first routed token, in both packages."""
    grey = dict(mi_continue=-1.0, mi_abstain=1e9, escalate_samples=0)
    ref = _ref_engine(jax_ref, router=grey, page_size=4)
    want = _served(ref, [jax_ref["batcher"].Request(
        uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
        arrival=r.arrival) for r in _mixed_trace()])
    eng = _engine(port_model, router=grey, page_size=4)
    eng._noise_override = _reference_noise(jax_ref)
    got = _served(eng, _mixed_trace())
    assert {u: (v[0], v[2]) for u, v in got.items()} == \
        {u: (v[0], v[2]) for u, v in want.items()}
    assert all(v[2] == "abstain" and not v[0] for v in got.values())
    assert eng.metrics.summary()["band_abstain"] == len(got)
    assert eng.metrics.summary()["abstained"] == len(got)


# ---------------------------------------------------------------------------
# Port against port, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cold(port_model):
    """The contiguous engine's results on the prefix trace and the mixed
    trace: the baseline every layout must give bit for bit."""
    return {"prefix": _served(_engine(port_model), _common_prefix_trace()),
            "mixed": _served(_engine(port_model), _mixed_trace())}


@pytest.mark.parametrize("page_size", [1, 4, MAX_LEN])
def test_paged_equals_contiguous(port_model, cold, page_size):
    got = _served(_engine(port_model, page_size=page_size), _mixed_trace())
    assert got == cold["mixed"]


@pytest.mark.parametrize("page_size", [1, 4, MAX_LEN])
def test_prefix_shared_equals_cold(port_model, cold, page_size):
    # page_size == max_len puts every slot on ONE page; two spare pages
    # let sharing retain a cached page AND copy-on-write it.
    budget = {MAX_LEN: 5}.get(page_size)
    want = _served(_engine(port_model, page_size=page_size,
                           page_budget=budget), _common_prefix_trace())
    assert want == cold["prefix"]
    eng = _engine(port_model, page_size=page_size, page_budget=budget,
                  prefix_sharing=True)
    got = _served(eng, _common_prefix_trace())
    assert got == want
    s = eng.metrics.summary()
    assert s["prefix_hits"] > 0 and s["prefill_tokens_saved"] > 0
    if page_size > 1:
        # the 9-token system prompt never page-aligns at these sizes
        assert s["cow_copies"] > 0
    assert s["final_live_pages"] == s["final_prefix_held_pages"]
    assert eng.prefix_peek(_common_prefix_trace()[0].prompt) > 0


@pytest.mark.parametrize("prefix_sharing", [False, True])
def test_preempting_equals_reserving(port_model, cold, prefix_sharing):
    trace_kw = dict(n=8, prefix_len=8, tail_len=4, max_new=6)
    want = _served(_engine(port_model, page_size=2),
                   _common_prefix_trace(**trace_kw))
    eng = _engine(port_model, page_size=2, reserve_pages=False,
                  page_budget=14, prefix_sharing=prefix_sharing)
    got = _served(eng, _common_prefix_trace(**trace_kw))
    assert got == want
    s = eng.metrics.summary()
    assert s["preemptions"] > 0
    assert s["final_occupancy"] == 0 and eng.pool.live == 0
    assert s["final_live_pages"] == s["final_prefix_held_pages"]


def test_auto_defrag_is_transparent(port_model, cold):
    eng = _engine(port_model, page_size=2, auto_defrag=True,
                  reserve_pages=False, page_budget=16)
    got = _served(eng, _common_prefix_trace())
    assert got == cold["prefix"]
    assert eng.metrics.summary()["defrags"] > 0


def test_compaction_is_transparent(port_model, cold):
    eng = _engine(port_model, auto_compact=True)
    moved, compact = [], eng.pool.compact

    def counted():
        remap = compact()
        moved.append(bool(remap))
        return remap

    eng.pool.compact = counted
    assert _served(eng, _mixed_trace()) == cold["mixed"]
    assert any(moved)


@pytest.mark.parametrize("greedy", [True, False])
def test_noise_is_keyed_per_request_and_token(port_model, cold, greedy):
    """Without the hook: the same requests in another admission order (and
    through fewer slots) give the same tokens and MI, bit for bit; sampled
    tokens too."""
    trace = _mixed_trace()
    want = _served(_engine(port_model, greedy=greedy), copy.deepcopy(trace))
    shuffled = [dataclasses.replace(r, arrival=float(5 - i // 2))
                for i, r in enumerate(copy.deepcopy(trace))]
    got = _served(_engine(port_model, slots=2, greedy=greedy), shuffled)
    assert got == want
    tokens = {u: v[0] for u, v in got.items()}
    assert (tokens == {u: v[0] for u, v in cold["mixed"].items()}) == greedy
    assert engine_mod.noise_seed(0, 1, 2) != engine_mod.noise_seed(0, 2, 1)
    assert engine_mod.noise_seed(0, 1, 2) == engine_mod.noise_seed(0, 1, 2)
    assert 0 <= engine_mod.noise_seed(2 ** 70, -1, 2 ** 65) < 2 ** 63


def test_loadgen_drain_leaks_nothing(port_model):
    trace = poisson_trace(40, 0.8, vocab_size=97, seed=5,
                          prompt_len=(2, 10), max_new_tokens=(1, 6),
                          priorities=(0, 1))
    for kw in (dict(), dict(page_size=4, reserve_pages=False,
                            page_budget=14, prefix_sharing=True)):
        eng = _engine(port_model, **kw)
        s = run_load(eng, copy.deepcopy(trace), max_steps=5000)
        assert s["finished"] == s["admitted"] == 40
        assert s["completed"] == 40 and s["rejected"] == 0
        assert eng.pool.live == 0 and eng.idle
        assert s["final_occupancy"] == 0
        eng.pool.check_invariants()
        if eng.paged:
            eng.prefix.check_invariants(eng.pool)
            assert s["final_live_pages"] == s["final_prefix_held_pages"]
            assert eng.pool.live_pages == eng.prefix.pages_held
        assert s["tokens_generated"] == sum(r.max_new_tokens for r in trace)
        assert len(eng.metrics.records) == 40


def test_engine_summary_and_exports(port_model):
    eng = _engine(port_model, page_size=4)
    eng.submit(Request(uid=1, prompt=np.arange(5, dtype=np.int32),
                       max_new_tokens=3, prefill_only=True))
    eng.submit(Request(uid=2, prompt=np.arange(7, dtype=np.int32),
                       max_new_tokens=3, deadline=-1.0))
    s = eng.run_until_idle(100)
    reasons = sorted(r.finish_reason for r in eng.finished)
    assert reasons == ["expired", "prefill"]
    assert s["expired"] == 1 and s["tokens_generated"] == 0
    assert "repro_tokens_generated" in eng.metrics.registry.to_prometheus()
    eng.reset_metrics()
    assert eng.metrics.summary()["steps"] == 0
    assert eng.now > 0 and eng.load == 0


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------
def test_refusals(port_model, monkeypatch):
    cfg, model = port_model
    # Speculation needs the paged pool, as in the reference.
    with pytest.raises(ValueError, match="paged"):
        _engine(port_model, speculate_k=2)
    with pytest.raises(ValueError):
        EngineConfig(speculate_k=-1)
    with pytest.raises(ValueError, match="prefix_sharing"):
        _engine(port_model, prefix_sharing=True)
    audio = reduced_config("musicgen-medium")
    with pytest.raises(ValueError, match="token-prompt"):
        Engine(audio, model, EngineConfig(), device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        _engine(port_model, sched=SchedulerConfig(prefill_chunk=MAX_LEN + 1))
    pool = DecodeStatePool(cfg, SLOTS, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        _engine(port_model, page_size=4, pool=pool)
    with pytest.raises(ValueError, match="geometry"):
        Engine(cfg, model, EngineConfig(slots=SLOTS + 1, max_len=MAX_LEN),
               pool=pool, device="cpu")
    with pytest.raises(ValueError, match="requires"):
        _engine(port_model, prefix=PrefixIndex(4, 8))
    with pytest.raises(ValueError, match="defrag"):
        _engine(port_model).defrag()
    with pytest.raises(ValueError, match="compaction"):
        _engine(port_model, page_size=4).compact()
    # Defaults: the reference's router, escalating the grey zone with 8
    # SVI samples.
    eng = Engine(cfg, model, EngineConfig(), device="cpu")
    assert eng.router.config.escalate_samples == 8
    assert eng.router.route(0.1) is Decision.CONTINUE
    assert eng.router.route(1.0) is Decision.ESCALATE
    assert eng.router.route(2.0) is Decision.ABSTAIN
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, model, EngineConfig())


def test_shared_pool_and_index_injection(port_model):
    """A prefill-only engine and a decode engine over one page pool and
    one prefix index: the second maps the first's pages."""
    cfg, model = port_model
    pool = PagedDecodeStatePool(cfg, SLOTS, MAX_LEN, 4, device="cpu")
    index = PrefixIndex(4, pool.total_pages)
    pool.add_remap_listener(index.remap_pages)
    kw = dict(page_size=4, prefix_sharing=True, pool=pool, prefix=index)
    pre, dec = _engine(port_model, **kw), _engine(port_model, **kw)
    prompt = np.arange(1, 12, dtype=np.int32)
    pre.submit(Request(uid=1, prompt=prompt, max_new_tokens=2,
                       prefill_only=True))
    pre.run_until_idle(50)
    assert index.pages_held > 0
    dec.submit(Request(uid=2, prompt=prompt, max_new_tokens=2))
    s = dec.run_until_idle(50)
    assert s["prefix_hits"] == 1 and s["tokens_generated"] == 2
    want = _served(_engine(port_model),
                   [Request(uid=2, prompt=prompt, max_new_tokens=2)])
    assert dec.finished[0].generated == want[2][0]
    assert dec.finished[0].mi_trace == want[2][1]
    pool.check_invariants()
    index.check_invariants(pool)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def card_model(cuda):
    """The reduced granite-8b drawn on the card from a seed, converted
    (no JAX: these tests also run where it is absent)."""
    cfg = dataclasses.replace(reduced_config(ARCH), sigma_init=SIGMA)
    variational = lm.init_params(
        cfg, generator=torch.Generator(device=cuda).manual_seed(0),
        device=cuda)
    return cfg, svi_to_pfp(variational)


@pytest.mark.gpu
@pytest.mark.parametrize("page_size", [None, 4])
def test_engine_on_card_kernel_matches_eager(card_model, page_size):
    runs = {}
    for impl in ("kernel", "eager"):
        cfg, m = card_model
        eng = Engine(cfg, m, EngineConfig(
            slots=SLOTS, max_len=MAX_LEN, num_uncertainty_samples=SAMPLES,
            impl=impl, page_size=page_size),
            router=UncertaintyRouter(cfg, RouterConfig(**OPEN)),
            scheduler=RequestScheduler(SchedulerConfig(
                prefill_chunk=CHUNK, prefill_budget=BUDGET)))
        runs[impl] = _served(eng, _mixed_trace())
    for uid, (toks, mi, reason) in runs["eager"].items():
        assert runs["kernel"][uid][0] == toks
        assert runs["kernel"][uid][2] == reason
        np.testing.assert_allclose(runs["kernel"][uid][1], mi, **MI_TOL)


@pytest.mark.gpu
def test_engine_on_card_layouts_bit_for_bit(card_model):
    cfg, m = card_model

    def run(**kw):
        eng = Engine(cfg, m, EngineConfig(
            slots=SLOTS, max_len=MAX_LEN, num_uncertainty_samples=SAMPLES,
            impl="kernel", **kw),
            router=UncertaintyRouter(cfg, RouterConfig(**OPEN)),
            scheduler=RequestScheduler(SchedulerConfig(
                prefill_chunk=CHUNK, prefill_budget=BUDGET)))
        return _served(eng, _common_prefix_trace())

    reset_launch_counts()
    want = run()
    assert LAUNCHES["attention_cache"] > 0 and LAUNCHES["dense"] > 0
    reset_launch_counts()
    assert run(page_size=4) == want
    assert LAUNCHES["attention_paged"] > 0
    assert run(page_size=4, prefix_sharing=True) == want
    assert run(page_size=2, reserve_pages=False, page_budget=14) == want
