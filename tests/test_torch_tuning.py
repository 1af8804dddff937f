"""The port's schedule cache, candidate search and autotuner.

The cache keeps the reference's version-2 file format (a file the port
writes loads in ``repro.tuning.cache``), and a corrupt, stale or
malformed file gives a ``ScheduleCacheWarning`` and an empty cache. The
recorder sees the fusion pass consult ``norm_dense_act``; ``autotune`` on
the CPU (rank mode: the first legal tile, nothing timed) writes one entry
per fused query of a reduced granite-8b forward and decode step. The test
marked ``gpu`` tunes on the card, where every candidate is checked
against the unfused kernel chain and timed.
"""
import json
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import dispatch
from repro_torch.core.modes import Mode
from repro_torch.kernels.pfp_fused import TILES
from repro_torch.models import lm
from repro_torch.nn.module import Context
from repro_torch.tuning import autotune as autotune_mod
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import measure, search
from repro_torch.tuning.schedules import Schedule, parse_shape_key

OP = "norm_dense_act"


@pytest.fixture
def clean_fusion():
    """Fusion off and an empty global cache before and after."""
    dispatch.set_fusion(False)
    tcache.reset_global_cache()
    try:
        yield
    finally:
        dispatch.set_fusion(False)
        tcache.reset_global_cache()


def _sched(bm=64, bn=64):
    return Schedule.make(OP, block_m=bm, block_n=bn)


def test_schedule_validates_and_round_trips():
    s = _sched(32, 64)
    assert s.describe() == "norm_dense_act[bm=32/bn=64]"
    assert Schedule.from_json(json.loads(json.dumps(s.to_json()))) == s
    assert s.block("block_m") == 32 and s.block("block_k", 7) == 7
    assert parse_shape_key("2048x4096x14336") == (2048, 4096, 14336)
    for bad in (dict(block_k=16), dict(block_m=0), dict(block_m=True),
                dict(block_m=1.5)):
        with pytest.raises(ValueError):
            Schedule.make(OP, **bad)
    with pytest.raises(ValueError, match="unknown tunable op"):
        Schedule.make("dense", block_m=64)


def test_candidates_are_the_legal_instantiated_tiles():
    gate = search.candidates(OP, (2048, 4096, 14336), limit=4)
    assert [(s.block("block_m"), s.block("block_n")) for s in gate] == [
        (128, 128), (64, 128), (64, 64), (16, 64)]
    decode = search.candidates(OP, (4, 4096, 14336))
    assert [(s.block("block_m"), s.block("block_n")) for s in decode] == [
        (16, 64), (8, 128), (4, 64)]
    narrow = search.candidates(OP, (4, 8, 16))
    assert [(s.block("block_m"), s.block("block_n")) for s in narrow] == [
        (16, 64), (4, 64)]
    every = search.candidates(OP, (4096, 8, 4096), limit=99)
    assert sorted((s.block("block_m"), s.block("block_n"))
                  for s in every) == sorted(TILES)
    # Where the unfused chain's dense splits K the unit does not fuse.
    assert search.candidates(OP, (4, 130, 70)) == []


def test_cache_save_load_round_trip(tmp_path):
    path = str(tmp_path / "db.json")
    cache = tcache.ScheduleCache(path)
    meta = {"mode": "time", "measured_s": 0.03, "tuned_at": 1.0}
    cache.put(OP, (2048, 4096, 14336), "float32", "NVIDIA H100", _sched(),
              meta=meta)
    cache.put(OP, (4, 4096, 14336), "float32", "cpu", _sched(16, 128))
    cache.save()
    again = tcache.ScheduleCache().load(path)
    assert again.entries() == cache.entries() and len(again) == 2
    assert again.get_meta(OP, (2048, 4096, 14336), "float32",
                          "NVIDIA H100") == meta
    assert again.get(OP, (4, 4096, 14336), "float32", "cpu") == \
        _sched(16, 128)
    assert again.get(OP, (4, 4096, 14336), "float32", "NVIDIA H100") is None
    with pytest.raises(ValueError, match="stored under"):
        cache.put("dense", (1, 2, 3), "float32", "cpu", _sched())


def test_cache_file_is_the_reference_format(tmp_path):
    pytest.importorskip("jax")
    from repro.tuning.cache import ScheduleCache as JCache
    path = str(tmp_path / "db.json")
    cache = tcache.ScheduleCache(path)
    cache.put(OP, (32, 64, 128), "float32", "cpu", _sched(32, 64),
              meta={"measured_s": None, "tuned_at": 2.0})
    cache.save()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ref = JCache().load(path)
    (key, sched), = ref.entries().items()
    assert key == f"{OP}|32x64x128|float32|cpu"
    assert sched.as_dict() == {"block_m": 32, "block_n": 64}


def test_an_entry_slower_than_the_unfused_chain_is_a_miss(clean_fusion):
    """The tuner stores ``fuse: false`` where the unfused chain beat every
    candidate; the dispatch-layer lookup then misses, so the chain runs."""
    cache = tcache.global_cache()
    cache.put(OP, (4, 8, 16), "float32", "cpu", _sched(16, 64),
              meta={"measured_s": 2e-3, "unfused_s": 1e-3, "fuse": False})
    cache.put(OP, (8, 8, 16), "float32", "cpu", _sched(16, 64),
              meta={"measured_s": 1e-3, "unfused_s": 2e-3, "fuse": True})
    assert tcache.lookup(OP, (4, 8, 16), "float32", "cpu") is None
    assert tcache.lookup(OP, (8, 8, 16), "float32", "cpu") == _sched(16, 64)
    assert tcache.consult_counters() == {"consults": 2, "hits": 1,
                                         "misses": 1}
    rec = {"schedule": "s", "seconds": 2e-3}
    slow = measure.TuneResult(OP, (4, 8, 16), "float32", "time",
                              _sched(16, 64), [rec], [], unfused_s=1e-3)
    fast = measure.TuneResult(OP, (4, 8, 16), "float32", "time",
                              _sched(16, 64), [rec], [], unfused_s=3e-3)
    untimed = measure.TuneResult(OP, (4, 8, 16), "float32", "rank",
                                 _sched(16, 64), [rec], [])
    assert (slow.fuse, fast.fuse, untimed.fuse) == (False, True, True)


@pytest.mark.parametrize("content", [
    b"\xff\xfe not json", b"{\"entries\": ", b"[1, 2]",
    b"{\"version\": 1, \"entries\": {}}", b"{\"version\": 2}"])
def test_a_corrupt_or_stale_file_warns_and_leaves_the_cache_empty(
        tmp_path, content):
    path = tmp_path / "db.json"
    path.write_bytes(content)
    with pytest.warns(tcache.ScheduleCacheWarning):
        cache = tcache.ScheduleCache().load(str(path))
    assert len(cache) == 0


def test_malformed_entries_are_skipped_with_a_warning(tmp_path):
    path = tmp_path / "db.json"
    good = {"schedule": _sched().to_json(), "meta": None}
    path.write_text(json.dumps({"version": 2, "entries": {
        f"{OP}|1x8x16|float32|cpu": good,
        "bad|1|float32|cpu": {"schedule": {"op": "dense", "blocks": {}}},
        "worse": 7}}))
    with pytest.warns(tcache.ScheduleCacheWarning, match="skipped 2"):
        cache = tcache.ScheduleCache().load(str(path))
    assert len(cache) == 1


def test_lookup_counts_and_the_environment_variable(tmp_path, monkeypatch,
                                                    clean_fusion):
    assert tcache.lookup(OP, (4, 8, 16), "float32", "cpu") is None
    path = str(tmp_path / "db.json")
    disk = tcache.ScheduleCache(path)
    disk.put(OP, (4, 8, 16), "float32", "cpu", _sched(16, 64))
    disk.save()
    monkeypatch.setenv(tcache.DEFAULT_CACHE_ENV, path)
    tcache.load_global_cache()
    assert tcache.lookup(OP, (4, 8, 16), "float32", "cpu") == _sched(16, 64)
    assert tcache.consult_counters(reset=True) == {
        "consults": 2, "hits": 1, "misses": 1}
    assert tcache.consult_counters() == {"consults": 0, "hits": 0,
                                         "misses": 0}
    assert tcache.consult_digest() == "norm_dense_act[bm=16/bn=64]"
    tcache.reset_global_cache()
    assert len(tcache.global_cache()) == 0
    assert tcache.default_backend("cpu") == "cpu"


def _lm():
    cfg = reduced_config("granite-8b")
    return cfg, autotune_mod.build_lm("granite-8b", layers=None, reduced=True,
                                      device="cpu")[1]


def test_record_shapes_sees_the_fused_unit(clean_fusion):
    cfg, model = _lm()
    ctx = Context(mode=Mode.PFP, device="cpu")
    tokens = {"tokens": np.zeros((2, 16), np.int64)}
    with tcache.record_shapes() as rec:
        lm.forward(model, cfg, tokens, ctx)
    assert rec == [] and not dispatch.get_fusion()   # nothing consults
    with dispatch.fusion(True), tcache.record_shapes() as rec:
        assert dispatch.get_fusion()
        lm.forward(model, cfg, tokens, ctx)
    assert rec == [(OP, (32, cfg.d_model, cfg.d_ff), "float32", "cpu")] * 2


def test_autotune_on_the_cpu_writes_one_entry_per_fused_query(
        tmp_path, clean_fusion):
    path = str(tmp_path / "db.json")
    chosen = autotune_mod.main([
        "--config", "granite-8b", "--reduced", "--device",
        "cpu", "--fuse", "--batch", "2", "--seq", "16", "--decode-slots",
        "3", "--save", path])
    cfg = reduced_config("granite-8b")
    keys = [(32, cfg.d_model, cfg.d_ff), (3, cfg.d_model, cfg.d_ff)]
    assert sorted(q[1] for q in chosen) == sorted(keys)
    saved = tcache.ScheduleCache().load(path)
    assert len(saved) == 2
    for key in keys:
        meta = saved.get_meta(OP, key, "float32", "cpu")
        assert meta["mode"] == "rank" and meta["measured_s"] is None
        assert meta["unfused_s"] is None and meta["fuse"] is True
        assert saved.get(OP, key, "float32", "cpu") == \
            search.candidates(OP, key)[0]
    # Warm: a second run hits and tunes nothing again.
    stamp = saved.get_meta(OP, keys[0], "float32", "cpu")["tuned_at"]
    with dispatch.fusion(True):
        again = autotune_mod.autotune(
            lambda p, b, c: lm.forward(p, cfg, b, c), _lm()[1],
            {"tokens": np.zeros((2, 16), np.int64)},
            Context(mode=Mode.PFP, device="cpu"), cache=saved)
    assert list(again.values()) == [saved.get(OP, keys[0], "float32", "cpu")]
    assert saved.get_meta(OP, keys[0], "float32", "cpu")["tuned_at"] == stamp


def test_tune_op_rank_and_time_modes():
    result = measure.tune_op(OP, (4, 8, 16))
    assert result.mode == "rank" and result.best == _sched(16, 64)
    assert result.unfused_s is None and result.fuse
    assert measure.default_mode("cpu") == "rank"
    assert measure.default_mode("cuda") == "time"
    with pytest.raises(ValueError, match="unknown tunable op"):
        measure.tune_op("dense", (4, 8, 16))


@pytest.mark.gpu
def test_tune_op_on_card_checks_and_times_every_candidate():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result = measure.tune_op(OP, (64, 256, 1000), device="cuda", limit=8)
    assert result.mode == "time" and not result.dropped
    assert result.unfused_s > 0
    assert result.fuse == (result.records[0]["seconds"] < result.unfused_s)
    assert len(result.records) == len(search.candidates(OP, (64, 256, 1000)))
    assert all(r["bitwise"] and r["seconds"] > 0 for r in result.records)
    secs = [r["seconds"] for r in result.records]
    assert secs == sorted(secs)
