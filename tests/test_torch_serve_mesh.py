"""Sharded serving on a world-1 gloo group, on the CPU.

A (1, 1) mesh over one rank runs every sharded-serving code path with
DTensors: the model placed by the serving rules, the pools' states by the
decode-state rules, each pass's inputs by ``batch_shardings``, the kernel
impl's routes for the cache, paged and fused ops (their plain versions on
the CPU), the eager impl's per-rank cache attention, the owner-rank slot
writes and page inserts, and the logits read whole. On one rank each must
give the unmeshed result, bit for bit:

* the ``Engine`` on reduced granite-8b, both pools and both impls, with
  prefix sharing and copy-on-write, defrag, compaction, speculation (K 2)
  and escalation (SVI second opinions);
* ``Fleet`` and ``DisaggPair`` on the mesh against their unmeshed runs;
* reduced yi-6b, gemma-7b and internlm2-20b on the paged pool;
* ``main([... "--device", "cpu", "--devices", "1", "--mesh", "1,1"])``
  exits 0 in-process, with the stream of the unmeshed command.

The pools' leaves are DTensors with ``state_pspec``'s placements; a
``MeshSpec`` is refused; the MoE, hybrid and SSM families raise on a mesh.
Against the reference: its ``Engine(mesh=make_mesh((1, 1), ...))`` on the
CPU and the port's meshed engine on the same weights and the reference's
Eq. 11 noise (``_noise_override``) serve the same tokens and finish
reasons, MI at the engine parity tests' tolerance (rtol 1e-2 / atol
1e-5).

The file's one fixture makes the group (asserting there was none before)
and destroys it in ``finally``; no test starts a process or a thread.
Multi-rank meshes run in ``chip_smoke.py`` (8 gloo processes).
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.bayes.convert import svi_to_pfp
from repro_torch.configs import reduced_config
from repro_torch.launch import serve
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import MeshSpec, make_mesh
from repro_torch.models import lm
from repro_torch.nn.module import load_numpy_params
from repro_torch.serving.batcher import Request
from repro_torch.serving.decode import uncertainty_decode
from repro_torch.serving.engine import (DecodeStatePool, Engine,
                                        EngineConfig, PagedDecodeStatePool,
                                        RequestScheduler, RouterConfig,
                                        SchedulerConfig, UncertaintyRouter,
                                        run_load)
from repro_torch.serving.fleet import DisaggPair, Fleet, FleetConfig

ARCH = "granite-8b"
SIGMA = 1e-3
SLOTS, MAX_LEN, SAMPLES, SEED = 3, 24, 8, 0
CHUNK, BUDGET = 3, 6
MI_TOL = dict(rtol=1e-2, atol=1e-5)      # the engine parity tests'
OPEN = dict(mi_continue=1e9, mi_abstain=2e9, escalate_samples=0)


@pytest.fixture(scope="module")
def mesh():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _model(arch=ARCH, seed=0):
    cfg = dataclasses.replace(reduced_config(arch), sigma_init=SIGMA)
    return cfg, svi_to_pfp(lm.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu"))


@pytest.fixture(scope="module")
def models(mesh):
    """(cfg, plain model, the same weights placed on the mesh)."""
    cfg, plain = _model()
    return cfg, plain, shlib.placed_copy(plain, mesh, serve=True)


def _trace(n=4, prefix_len=9, tail_len=3, max_new=4):
    """Requests opening with one system prompt (9 tokens: mid-page at
    pages of 2 and 4, so copy-on-write runs), arrivals spaced so early
    finishers become prefix donors."""
    system = np.arange(1, prefix_len + 1, dtype=np.int32)
    return [Request(uid=i, prompt=np.concatenate(
        [system, np.full(tail_len, 50 + i, np.int32)]),
        max_new_tokens=max_new, arrival=float(2 * i)) for i in range(n)]


def _engine(cfg, model, *, mesh=None, impl=None, router=None, **kw):
    return Engine(cfg, model, EngineConfig(
        slots=SLOTS, max_len=MAX_LEN, num_uncertainty_samples=SAMPLES,
        seed=SEED, impl=impl, **kw),
        router=UncertaintyRouter(cfg, RouterConfig(**(router or OPEN)),
                                 impl=impl),
        scheduler=RequestScheduler(SchedulerConfig(prefill_chunk=CHUNK,
                                                   prefill_budget=BUDGET)),
        mesh=mesh, device="cpu")


def _served(eng, trace):
    run_load(eng, trace, max_steps=2000)
    for pool in {id(p): p for p in _pools(eng)}.values():
        pool.check_invariants()
    return {r.uid: (list(r.generated), [float(m) for m in r.mi_trace],
                    r.finish_reason) for r in eng.finished}


def _pools(target):
    if hasattr(target, "replicas"):
        return [r.pool for r in target.replicas]
    return [target.pool]


ESCALATE = dict(mi_continue=0.0, mi_abstain=2e9, escalate_samples=2)
ENGINE_CASES = {
    "kernel-contiguous": ("kernel", dict(), "decode_passes"),
    "kernel-compact": ("kernel", dict(auto_compact=True), "compactions"),
    "kernel-paged-prefix": ("kernel", dict(page_size=4, prefix_sharing=True),
                            "cow_copies"),
    "kernel-defrag": ("kernel", dict(page_size=2, auto_defrag=True,
                                     reserve_pages=False, page_budget=16),
                      "defrags"),
    "kernel-speculate": ("kernel", dict(page_size=4, speculate_k=2),
                         "accepted_draft_tokens"),
    "kernel-escalate": ("kernel", dict(router=ESCALATE), "escalations"),
    "kernel-escalate-paged": ("kernel", dict(page_size=4, router=ESCALATE),
                              "escalations"),
    "eager-contiguous": ("eager", dict(), "decode_passes"),
    "eager-paged-prefix": ("eager", dict(page_size=4, prefix_sharing=True),
                           "cow_copies"),
    "eager-speculate": ("eager", dict(page_size=4, speculate_k=2),
                        "accepted_draft_tokens"),
}


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_meshed_engine_equals_unmeshed_bit_for_bit(models, mesh, case):
    cfg, plain, placed = models
    impl, kw, exercised = ENGINE_CASES[case]
    want = _served(_engine(cfg, plain, impl=impl, **kw), _trace())
    eng = _engine(cfg, placed, mesh=mesh, impl=impl, **kw)
    moved = []
    if not eng.paged:
        compact = eng.pool.compact

        def counted():
            remap = compact()
            moved.append(bool(remap))
            return remap

        eng.pool.compact = counted
    got = _served(eng, _trace())
    assert got == want
    summary = dict(eng.metrics.summary(), compactions=sum(moved))
    assert summary[exercised] > 0
    assert eng.pool.live == 0


@pytest.mark.parametrize("disaggregate", [False, True])
def test_fleet_and_pair_on_the_mesh_equal_their_unmeshed_runs(
        models, mesh, disaggregate):
    cfg, plain, placed = models
    config = EngineConfig(slots=SLOTS, max_len=MAX_LEN,
                          num_uncertainty_samples=SAMPLES, seed=SEED,
                          page_size=4, prefix_sharing=True)
    router = UncertaintyRouter(cfg, RouterConfig(**OPEN))
    sched = SchedulerConfig(prefill_chunk=CHUNK, prefill_budget=BUDGET)

    def fleet(model, m):
        return Fleet(cfg, model, config,
                     FleetConfig(replicas=2, disaggregate=disaggregate),
                     router=router, scheduler_config=sched, mesh=m,
                     device="cpu")

    want = _served(fleet(plain, None), _trace(n=6))
    got_fleet = fleet(plain, mesh)
    assert _served(got_fleet, _trace(n=6)) == want
    # one placed copy serves every replica; the caller's model is as it was
    engines = [e for r in got_fleet.replicas
               for e in ((r.prefill_engine, r.decode_engine) if disaggregate
                         else (r,))]
    assert len({id(e.model) for e in engines}) == 1
    assert all(isinstance(p, DTensor) for p in engines[0].model.parameters())
    assert not any(isinstance(p, DTensor) for p in plain.parameters())
    if disaggregate:
        assert got_fleet.metrics.summary()["handoffs"] > 0
        pair = DisaggPair(cfg, placed, config, router=router,
                          scheduler_config=sched, mesh=mesh, device="cpu")
        assert pair.prefill_engine.pool is pair.decode_engine.pool
        assert isinstance(pair.pool.states["stack"]["b0"].k_mu, DTensor)
        unmeshed = DisaggPair(cfg, plain, config, router=router,
                              scheduler_config=sched, device="cpu")
        assert _served(pair, _trace()) == _served(unmeshed, _trace())


@pytest.mark.parametrize("paged", [False, True])
def test_pool_leaves_are_dtensors_with_state_pspec_placements(mesh, paged):
    cfg = reduced_config(ARCH)
    pool = (PagedDecodeStatePool(cfg, SLOTS, MAX_LEN, 4, mesh=mesh,
                                 device="cpu") if paged else
            DecodeStatePool(cfg, SLOTS, MAX_LEN, mesh=mesh, device="cpu"))
    leaves = []

    def check(path, leaf):
        assert isinstance(leaf, DTensor), path
        want = shlib.placements(shlib.state_pspec(path, tuple(leaf.shape),
                                                  mesh), mesh)
        assert list(leaf.placements) == want, path
        leaves.append(path)
        return leaf

    shlib.map_with_path(check, pool.states)
    assert len(leaves) == 3 and pool.mesh is mesh
    if paged:
        table = pool.device_table()
        assert not isinstance(table, DTensor)
        assert table is pool.device_table()


def test_engine_and_pools_refuse_a_meshspec():
    cfg, model = _model()
    spec = MeshSpec((1, 1), ("data", "model"))
    with pytest.raises(TypeError, match="MeshSpec"):
        Engine(cfg, model, EngineConfig(), mesh=spec, device="cpu")
    with pytest.raises(TypeError, match="MeshSpec"):
        PagedDecodeStatePool(cfg, 2, 8, 4, mesh=spec, device="cpu")


@pytest.mark.parametrize("arch,waits", [
    ("deepseek-moe-16b", "expert parallelism"),
    ("recurrentgemma-2b", "einsum route"),
    ("mamba2-370m", "einsum route"),
])
def test_other_families_raise_on_a_mesh(mesh, arch, waits, capsys):
    cfg = reduced_config(arch)
    with pytest.raises(NotImplementedError, match=waits):
        Engine(cfg, lm.init_params(cfg, device="cpu"), EngineConfig(),
               mesh=mesh, device="cpu")
    assert serve.main(["--device", "cpu", "--arch", arch, "--devices", "1",
                       "--mesh", "1,1"]) == 2
    assert "ROADMAP.md" in capsys.readouterr().err


@pytest.mark.parametrize("arch", ["yi-6b", "gemma-7b", "internlm2-20b"])
def test_dense_configs_serve_on_the_mesh(mesh, arch):
    cfg, plain = _model(arch)
    want = _served(_engine(cfg, plain, page_size=4, prefix_sharing=True),
                   _trace())
    eng = _engine(cfg, plain, mesh=mesh, page_size=4, prefix_sharing=True)
    assert _served(eng, _trace()) == want
    assert all(isinstance(p, DTensor) for p in eng.model.parameters())
    assert not any(isinstance(p, DTensor) for p in plain.parameters())


@pytest.mark.parametrize("flags", [
    [],
    ["--page-size", "4", "--prefix-sharing", "--common-prefix", "6",
     "--replicas", "2", "--disaggregate"],
])
def test_serve_cli_on_a_one_rank_mesh(mesh, tmp_path, flags, capsys):
    argv = ["--device", "cpu", "--requests", "4", "--tokens", "4", *flags]
    assert serve.main(argv + ["--stream-out", str(tmp_path / "a.json")]) == 0
    assert serve.main(argv + ["--devices", "1", "--mesh", "1,1",
                              "--stream-out", str(tmp_path / "b.json")]) == 0
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 1}" in out
    assert "decode state on the mesh" in out
    assert json.loads((tmp_path / "a.json").read_text()) == json.loads(
        (tmp_path / "b.json").read_text())


def test_uncertainty_decode_on_vocab_split_logits(mesh):
    from torch.distributed.tensor import Shard

    rng = np.random.default_rng(0)
    mean = torch.from_numpy(rng.normal(size=(3, 2, 97)).astype(np.float32))
    var = torch.from_numpy(rng.random((3, 2, 97)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(SAMPLES, 3, 97)).astype(
        np.float32))
    split = [shlib.distribute(t, mesh, [Shard(2), Shard(2)])
             for t in (mean, var)]
    want = uncertainty_decode(mean, var, eps=eps,
                              num_uncertainty_samples=SAMPLES)
    got = uncertainty_decode(*split, eps=eps, num_uncertainty_samples=SAMPLES)
    for name in ("token", "mutual_info", "total_unc", "abstain"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


# ---------------------------------------------------------------------------
# Against the reference's meshed engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.bayes.convert import svi_to_pfp as jax_svi_to_pfp
    from repro.configs import reduced_config as jax_reduced_config
    from repro.launch.mesh import make_mesh as jax_make_mesh
    from repro.models import lm as jlm
    from repro.serving import batcher as jbatcher
    from repro.serving import engine as jengine
    cfg = dataclasses.replace(jax_reduced_config(ARCH), sigma_init=SIGMA)
    params = jax_svi_to_pfp(jlm.init_params(cfg, jax.random.PRNGKey(0)))
    return dict(jax=jax, jnp=jnp, engine=jengine, batcher=jbatcher, cfg=cfg,
                params=params, mesh=jax_make_mesh((1, 1), ("data", "model")),
                tree=jax.tree_util.tree_map(np.asarray, params))


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


@pytest.mark.parametrize("layout", [dict(), dict(page_size=4,
                                                 prefix_sharing=True)])
def test_meshed_engine_matches_the_references_meshed_engine(jax_ref, mesh,
                                                            layout):
    E, jmesh = jax_ref["engine"], jax_ref["mesh"]
    ref = E.Engine(
        jax_ref["cfg"], jax_ref["params"],
        E.EngineConfig(slots=SLOTS, max_len=MAX_LEN,
                       num_uncertainty_samples=SAMPLES, seed=SEED, **layout),
        router=E.UncertaintyRouter(jax_ref["cfg"], E.RouterConfig(**OPEN)),
        scheduler=E.RequestScheduler(E.SchedulerConfig(
            prefill_chunk=CHUNK, prefill_budget=BUDGET)),
        mesh=jmesh)
    with jmesh:
        want = _served(ref, [jax_ref["batcher"].Request(**{
            f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
            for r in _trace()])
    cfg = dataclasses.replace(reduced_config(ARCH), sigma_init=SIGMA)
    model = load_numpy_params(lm.init_params(cfg, device="cpu"),
                              jax_ref["tree"])
    eng = _engine(cfg, model, mesh=mesh, **layout)
    eng._noise_override = _reference_noise(jax_ref)
    got = _served(eng, _trace())
    assert sorted(got) == sorted(want)
    for uid in want:
        assert got[uid][0] == want[uid][0], uid
        assert got[uid][2] == want[uid][2], uid
        np.testing.assert_allclose(got[uid][1], want[uid][1], **MI_TOL)
