"""The port's decode-state slot helpers, state pools and batcher against the
JAX package's.

The same numpy state trees and the same operation sequences go through
``repro.models.lm``'s slot helpers, ``repro.serving.engine.state``'s pools
and ``repro.serving.batcher`` and through the port's; host state (slot
owners, free lists, positions, page tables, refcounts, holds) must be
identical and device state equal bit for bit (the helpers only move
data). A fixed-seed churn of the paged pool checks its invariants after
every operation and that no page a slot may write is mapped by another
slot.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.models import lm
from repro_torch.nn.attention import KVCache, PagedKVCache
from repro_torch.serving import batcher
from repro_torch.serving.batcher import Batcher, Request
from repro_torch.serving.engine import DecodeStatePool, PagedDecodeStatePool

ARCH = "granite-8b"


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's modules, imported only where a test needs them."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import reduced_config as jax_reduced_config
    from repro.models import lm as jlm
    from repro.nn.attention import KVCache as JKVCache
    from repro.nn.attention import PagedKVCache as JPagedKVCache
    from repro.serving import batcher as jbatcher
    from repro.serving.engine import state as jstate
    return dict(jax=jax, lm=jlm, KVCache=JKVCache, PagedKVCache=JPagedKVCache,
                batcher=jbatcher, state=jstate,
                cfg=jax_reduced_config(ARCH))


def _tree(shape, seed, paged=False):
    """A random numpy decode-state tree in the reference layout."""
    rng = np.random.default_rng(seed)
    leaves = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    return {"stack": {"b0": (PagedKVCache if paged else KVCache)(*leaves)}}


def _as_reference(jax_ref, tree):
    cache = tree["stack"]["b0"]
    cls = (jax_ref["PagedKVCache"] if isinstance(cache, PagedKVCache)
           else jax_ref["KVCache"])
    return {"stack": {"b0": cls(*(jax_ref["jax"].numpy.asarray(a)
                                  for a in cache))}}


def _as_port(tree):
    return lm.load_numpy_decode_state(tree, device="cpu")


def _assert_same(port_tree, ref_tree):
    got, want = port_tree["stack"]["b0"], ref_tree["stack"]["b0"]
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_slot_helpers_match_reference(jax_ref):
    jlm = jax_ref["lm"]
    states = _tree((2, 4, 2, 8, 16), 0)
    port, ref = _as_port(states), _as_reference(jax_ref, states)
    _assert_same(lm.take_decode_slots(port, [2, 0]),
                 jlm.take_decode_slots(ref, [2, 0]))
    sub = _tree((2, 1, 2, 8, 16), 1)
    _assert_same(lm.write_decode_slot(port, 1, _as_port(sub)),
                 jlm.write_decode_slot(ref, 1, _as_reference(jax_ref, sub)))
    _assert_same(lm.reset_decode_slot(port, 3), jlm.reset_decode_slot(ref, 3))
    other = _tree((2, 4, 2, 8, 16), 2)
    keep = np.asarray([True, False, True, False])
    _assert_same(lm.select_decode_slots(port, _as_port(other), keep),
                 jlm.select_decode_slots(ref, _as_reference(jax_ref, other),
                                         keep))
    pages = _tree((2, 7, 2, 4, 16), 3, paged=True)
    _assert_same(lm.copy_decode_pages(_as_port(pages), [1, 3], [5, 6]),
                 jlm.copy_decode_pages(_as_reference(jax_ref, pages), [1, 3],
                                       [5, 6]))
    # Out of place, as in the reference: the input state is unchanged.
    _assert_same(port, ref)


def _fill(pool, jpool, jax_ref, seed):
    """Give both pools the same random device state."""
    shape = tuple(pool.states["stack"]["b0"].k_mu.shape)
    tree = _tree(shape, seed,
                 paged=isinstance(pool.states["stack"]["b0"], PagedKVCache))
    pool.states = _as_port(tree)
    jpool.states = _as_reference(jax_ref, tree)


def test_decode_state_pool_matches_reference(jax_ref):
    cfg = reduced_config(ARCH)
    pool = DecodeStatePool(cfg, 4, 8, device="cpu")
    jpool = jax_ref["state"].DecodeStatePool(jax_ref["cfg"], 4, 8)
    _fill(pool, jpool, jax_ref, 0)
    sub = _tree((2, 1, 2, 8, 16), 5)
    for p in (pool, jpool):
        for uid in (10, 11, 12):
            p.alloc(uid)
        p.positions[:3] = [5, 6, 7]
        p.evict(1)
        assert p.alloc(13) == 1
        p.evict(0)
        p.evict(1)
    pool.write_slot(2, _as_port(sub))
    jpool.write_slot(2, _as_reference(jax_ref, sub))
    assert pool.compact() == jpool.compact() == {2: 0}
    for name in ("owner", "_free"):
        assert getattr(pool, name) == getattr(jpool, name)
    np.testing.assert_array_equal(pool.positions, jpool.positions)
    _assert_same(pool.states, jpool.states)
    _assert_same(pool.take_slot(0), jpool.take_slot(0))
    assert (pool.live, pool.free_slots, pool.fragmentation()) == \
        (jpool.live, jpool.free_slots, jpool.fragmentation())
    pool.check_invariants()


def _paged_ops(p, remaps):
    """A sequence of paged-pool operations: allocation, sharing, holds,
    copy-on-write, eviction and defrag."""
    p.add_remap_listener(remaps.append)
    a = p.alloc(1)
    assert p.ensure_capacity(a, 10)
    b = p.alloc(2)
    p.share(b, p.slot_pages[a][:2])
    held = p.slot_pages[a][2]
    p.hold(held)
    assert p.ensure_capacity(b, 13)
    assert not p.writable(b, 4, 13)
    assert p.ensure_writable(b, 4, 13)
    c = p.alloc(3)
    assert p.ensure_capacity(c, 5)
    assert not p.ensure_capacity(c, 16)   # more than the free pages
    p.positions[[a, b, c]] = [10, 13, 5]
    p.evict(a)
    p.release_hold(held)
    return p.defrag()


def test_paged_pool_matches_reference(jax_ref):
    cfg = reduced_config(ARCH)
    pool = PagedDecodeStatePool(cfg, 3, 16, 4, num_pages=9, device="cpu")
    jpool = jax_ref["state"].PagedDecodeStatePool(jax_ref["cfg"], 3, 16, 4,
                                                  num_pages=9)
    _fill(pool, jpool, jax_ref, 1)
    remaps, jremaps = [], []
    perm = _paged_ops(pool, remaps)
    jperm = _paged_ops(jpool, jremaps)
    np.testing.assert_array_equal(perm, jperm)
    assert remaps == jremaps and len(remaps) == 1
    np.testing.assert_array_equal(pool.page_table, jpool.page_table)
    np.testing.assert_array_equal(pool.positions, jpool.positions)
    for name in ("page_ref", "external_holds", "slot_pages", "owner",
                 "cow_copies", "_free"):
        assert getattr(pool, name) == getattr(jpool, name), name
    assert sorted(pool._free_pages) == sorted(jpool._free_pages)
    assert pool.page_gauges() == jpool.page_gauges()
    assert (pool.shared_pages, pool.held_pages) == \
        (jpool.shared_pages, jpool.held_pages)
    _assert_same(pool.states, jpool.states)
    np.testing.assert_array_equal(pool.device_table().numpy(),
                                  np.asarray(jpool.device_table()))
    pool.check_invariants()


def test_paged_pool_churn_never_aliases_writable_pages():
    """Fixed-seed churn: after every operation the invariants hold, and
    the pages a slot made writable are mapped by no other slot."""
    cfg = reduced_config(ARCH)
    pool = PagedDecodeStatePool(cfg, 4, 16, 2, num_pages=20, device="cpu")
    rng = np.random.default_rng(11)
    uid = 0
    for _ in range(150):
        live = pool.live_slot_indices()
        op = rng.integers(0, 5)
        if op == 0 and pool.free_slots:
            uid += 1
            slot = pool.alloc(uid)
            donors = [s for s in live if pool.slot_pages[s]]
            if donors and rng.random() < 0.5:
                donor = donors[rng.integers(len(donors))]
                n = rng.integers(1, len(pool.slot_pages[donor]) + 1)
                pool.share(slot, pool.slot_pages[donor][:n])
        elif op == 1 and live:
            slot = live[rng.integers(len(live))]
            upto = int(rng.integers(1, 17))
            if pool.ensure_capacity(slot, upto):
                start = int(rng.integers(0, upto))
                if pool.ensure_writable(slot, start, upto):
                    lo, hi = start // 2, pool.pages_needed(upto)
                    mine = set(pool.slot_pages[slot][lo:hi])
                    for other in pool.live_slot_indices():
                        if other != slot:
                            assert not mine & set(pool.slot_pages[other])
                    assert all(pool.page_ref[q] == 1 for q in mine)
                    pool.positions[slot] = max(pool.positions[slot], upto)
        elif op == 2 and live:
            pool.evict(live[rng.integers(len(live))])
        elif op == 3:
            pool.defrag()
        elif op == 4 and live:
            slot = live[rng.integers(len(live))]
            if pool.slot_pages[slot]:
                page = pool.slot_pages[slot][0]
                pool.hold(page)
                if rng.random() < 0.7:
                    pool.release_hold(page)
        pool.check_invariants()
    assert pool.cow_copies > 0
    for slot in pool.live_slot_indices():
        pool.evict(slot)
    for page in range(1, pool.num_pages):
        while pool.external_holds[page]:
            pool.release_hold(page)
    pool.check_invariants()
    assert pool.live_pages == 0 and pool.live == 0


def test_pools_refuse_a_mesh_and_cache_the_device_table():
    cfg = reduced_config(ARCH)
    with pytest.raises(NotImplementedError, match="mesh"):
        DecodeStatePool(cfg, 2, 8, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        PagedDecodeStatePool(cfg, 2, 8, 4, mesh=object(), device="cpu")
    pool = PagedDecodeStatePool(cfg, 2, 8, 4, device="cpu")
    slot = pool.alloc(7)
    pool.ensure_capacity(slot, 8)
    table = pool.device_table()
    assert table.dtype == torch.int32 and table is pool.device_table()
    assert table.tolist() == [[1, 2], [0, 0]]
    pool.evict(slot)
    assert table.tolist() == [[1, 2], [0, 0]]      # a copy, not a view
    assert pool.device_table().tolist() == [[0, 0], [0, 0]]
    assert pool.device_table(np.asarray([1])).tolist() == [[0, 0]]


def _serve(batcher_mod, script):
    """Run a scripted token stream through a Batcher of 3 slots; returns
    the admissions and evictions in order."""
    b = batcher_mod.Batcher(3, 32)
    for uid in range(7):
        b.submit(batcher_mod.Request(uid=uid, prompt=np.zeros(4, np.int32),
                                     max_new_tokens=2 + uid % 3))
    log = []
    step = 0
    while not b.idle:
        log += [("admit", slot, r.uid) for slot, r in b.fill_slots()]
        for slot, req in b.active():
            token, mi, abstain = script[step % len(script)]
            step += 1
            done = b.record(slot, token, mi, abstain, eos=5)
            if done is not None:
                log.append(("evict", slot, done.uid, done.finish_reason,
                            done.generated, done.mi_trace))
    return log


def test_batcher_matches_reference(jax_ref):
    script = [(1, 0.1, False), (5, 0.2, False), (2, 0.9, True),
              (3, 0.0, False), (4, 0.3, False)]
    assert _serve(batcher, script) == _serve(jax_ref["batcher"], script)
    b = Batcher(1, 8)
    b.submit(Request(uid=1, prompt=np.zeros(2, np.int32)))
    assert b.evict(0, "x") is None
    b.fill_slots()
    assert b.evict(0, "abstain").finish_reason == "abstain" and b.idle
