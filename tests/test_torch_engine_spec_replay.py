"""Escalation replays in the port, port against port, on the CPU.

The setting of ``tests/torch_engine_spec_common.py`` (reduced granite-8b
carried from one JAX init; 3 slots of 24 rows): prefix-shared == cold at
pages of 1, 4 and 24, batched and sequential; preempting == reserving;
escalations after ``defrag()`` and ``compact()`` replaying against the
remapped snapshot; the replay reproducing the routed logits on both pools.
Tokens, finish reasons and MI traces are compared bit for bit: an
escalation replayed against a stale snapshot can move MI by less than
``MI_ATOL``.
"""
import copy
import functools

import pytest
import torch

from repro_torch.core.modes import Mode
from repro_torch.models import lm
from repro_torch.nn.module import Context
from torch_engine_spec_common import (  # noqa: F401  (fixtures)
    MAX_LEN, PAGES, _assert_bit_for_bit, _common_prefix_trace, _engine,
    _served, _trace, jax_ref, port_model)


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
