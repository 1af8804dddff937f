"""The fused norm -> dense -> activation unit and the fusion pass of the
port, against the JAX package and against the port's own unfused chain.

Op level: on the CPU ``repro_torch.kernels.ops.pfp_norm_dense_act`` runs
its kernel's plain version; it is held against
``repro.kernels.ops.pfp_norm_dense_act(..., impl="kernel")``, the Pallas
kernel in interpret mode, on ragged shapes at the dense tolerance of
tests/test_kernels.py (rtol 1e-5 / atol 1e-4); the epilogue needs no more.

Model level: one JAX init of the reduced granite-8b (as in
tests/test_torch_lm.py: sigma_init 0.02, calibration 0.4) is carried
across with ``load_numpy_params``. With fusion on and both packages'
schedule caches warmed for the fused unit (the reference as in
tests/test_impl_dispatch.py), the port's logits are held against the
reference's at its ``_NDA_TOL`` (rtol 1e-3 / atol 5e-4), greedy tokens
exact. Port against port the pass changes no bit: on a cache miss, under
``eager``, and on the CPU on a hit, because the plain version is the
chain.

Every test that touches the fusion flag or a schedule cache resets both
packages' in a ``finally``: under ``--dist loadfile`` a leaked
``set_fusion(True)`` would change the reference's own tests on the same
worker. The tests marked ``gpu`` hold the CUDA kernel against its plain
version and the unfused kernel chain on the card and skip where there is
none: ``python -m pytest -m gpu tests/test_torch_fused.py``.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.bayes.convert import svi_to_pfp
from repro_torch.configs import reduced_config
from repro_torch.core import dispatch
from repro_torch.core.gaussian import SRM, VAR, GaussianTensor
from repro_torch.core.modes import Mode
from repro_torch.kernels import ops
from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
from repro_torch.kernels.pfp_dense import dense_plan, split_k
from repro_torch.kernels.pfp_fused import (PLANS, TILES, default_tile,
                                           fusable, tile_of)
from repro_torch.models import lm
from repro_torch.nn.layers import dense_init
from repro_torch.nn.mlp import MLPBlock, mlp_apply
from repro_torch.nn.module import Context, load_numpy_params, resolve_weight
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import search
from repro_torch.tuning.measure import unfused_chain
from repro_torch.tuning.schedules import Schedule

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
DENSE_TOL = dict(rtol=1e-5, atol=1e-4)    # tests/test_kernels.py
NDA_TOL = dict(rtol=1e-3, atol=5e-4)      # tests/test_impl_dispatch.py
ARCH, SIGMA, CAL = "granite-8b", 0.02, 0.4
NORMS, REPS = ("rmsnorm", "layernorm"), ("var", "srm")
ACTS = ("relu", "gelu", "silu", "tanh", "sigmoid")
# granite-8b's gate projection cut to a few hundred rows and columns (M
# and N ragged against every tile), and a 4-slot decode step of it.
REDUCED_GATE, DECODE_STEP = (250, 4096, 1800), (4, 4096, 1800)
# Every activation with both norms; each norm with both input reps.
OP_CASES = [(norm, REPS[(i + j) % 2], act, shape)
            for i, (act, shape) in enumerate(zip(ACTS, [
                (5, 37, 19), (3, 130, 70), (1, 64, 129), (7, 100, 33),
                (4, 129, 64)]))
            for j, norm in enumerate(NORMS)]


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's modules, imported only where a test needs them."""
    pytest.importorskip("jax")
    import jax
    from repro.bayes.convert import svi_to_pfp as jax_svi_to_pfp
    from repro.configs import reduced_config as jax_reduced_config
    from repro.core import dispatch as jdispatch
    from repro.core.modes import Mode as JMode
    from repro.kernels import ops as jops
    from repro.models import lm as jlm
    from repro.nn.module import Context as JContext
    from repro.tuning import cache as jcache
    from repro.tuning.schedules import Schedule as JSchedule
    return dict(jax=jax, svi_to_pfp=jax_svi_to_pfp,
                reduced_config=jax_reduced_config, dispatch=jdispatch,
                Mode=JMode, ops=jops, lm=jlm, Context=JContext, cache=jcache,
                Schedule=JSchedule)


@pytest.fixture
def clean_fusion():
    """Fusion off and empty schedule caches before and after, in both
    packages (the reference's only if it was imported)."""
    import sys

    def reset():
        dispatch.set_fusion(False)
        tcache.reset_global_cache()
        if "repro.core.dispatch" in sys.modules:
            sys.modules["repro.core.dispatch"].set_fusion(False)
        if "repro.tuning.cache" in sys.modules:
            sys.modules["repro.tuning.cache"].reset_global_cache()

    reset()
    try:
        yield
    finally:
        reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _operands(m, k, n, seed, rep="var"):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(m, k)).astype(np.float32)
    var = np.log1p(np.exp(rng.normal(size=(m, k)))).astype(np.float32)
    second = var if rep == "var" else var + mu * mu
    gain = (1.0 + 0.1 * rng.normal(size=k)).astype(np.float32)
    bias = (0.1 * rng.normal(size=k)).astype(np.float32)
    mu_w = (0.1 * rng.normal(size=(k, n))).astype(np.float32)
    srm_w = (mu_w * mu_w + 0.01 * np.log1p(np.exp(rng.normal(size=(k, n))))
             ).astype(np.float32)
    return mu, second, gain, bias, mu_w, srm_w


def _t(arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


# ---------------------------------------------------------------------------
# Op level
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("norm,rep,act,shape", OP_CASES)
def test_op_matches_reference_pallas_kernel(jax_ref, norm, rep, act, shape):
    mu, second, gain, bias, mu_w, srm_w = _operands(*shape, seed=sum(shape),
                                                    rep=rep)
    b = bias if norm == "layernorm" else None
    want = jax_ref["ops"].pfp_norm_dense_act(
        mu, second, gain, b, mu_w, srm_w, norm=norm, rep=rep, act=act,
        impl="kernel")
    got = ops.pfp_norm_dense_act(*_t([mu, second, gain]),
                                 None if b is None else _t([b])[0],
                                 *_t([mu_w, srm_w]), norm=norm, rep=rep,
                                 act=act)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **DENSE_TOL)


@pytest.mark.parametrize("norm,rep,act,shape", OP_CASES[:4])
def test_op_is_the_unfused_chain_bitwise_on_cpu(norm, rep, act, shape):
    args = _t(_operands(*shape, seed=3, rep=rep))
    lead = [a.reshape(2, -1, a.shape[-1]) if i < 2 and shape[0] % 2 == 0
            else a for i, a in enumerate(args)]
    got = ops.pfp_norm_dense_act(*lead, norm=norm, rep=rep, act=act)
    want = unfused_chain(*lead, norm=norm, rep=rep, act=act)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g, w)


def test_op_rejects_what_the_kernel_is_not_built_for():
    args = _t(_operands(4, 8, 16, seed=1))
    for kw in (dict(act="softplus"), dict(norm="groupnorm"),
               dict(rep="std"),
               dict(schedule=Schedule.make("norm_dense_act", block_m=8,
                                           block_n=8))):
        with pytest.raises(ValueError, match="no fused norm_dense_act"):
            ops.pfp_norm_dense_act(*args, **kw)


def _x_macro(source, name):
    """The (bn, tn, tm, stages) entries of an X-macro list in a source."""
    text = (CSRC / source).read_text()
    body = re.search(rf"#define {name}\(X\)(.*?)\n\n", text, re.S).group(1)
    return [tuple(int(v) for v in x) for x in
            re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", body)]


def test_every_fused_tile_is_a_dense_plan_of_split_1():
    """The fused unit runs on the dense kernel's own plans: PLANS is
    csrc/pfp_fused.cu's PFP_FUSED_TILES, each one of pfp_dense.cu's
    PFP_DENSE_TILES, and together exactly the plans (all of split 1) the
    unfused chain's dense runs at N > 128, at whose tiles the fused unit
    runs by default."""
    fused = _x_macro("pfp_fused.cu", "PFP_FUSED_TILES")
    assert fused == list(PLANS)
    assert set(fused) <= set(_x_macro("pfp_dense.cu", "PFP_DENSE_TILES"))
    assert TILES == tuple(tile_of(p) for p in PLANS)
    assert len(set(TILES)) == len(TILES)
    chain = set()
    for m in (1, 2, 4, 5, 8, 9, 16, 17, 64, 128, 250, 512, 1024, 2048):
        for n in (129, 1024, 1800, 2048, 4096, 14336):
            plan = dense_plan(m, n, 4096)
            assert plan.split == 1
            chain.add(tuple(plan[1:]))
            assert default_tile(m, n, 4096) == tile_of(plan[1:])
    assert chain == set(PLANS)


def test_fusion_pass_runs_the_chain_where_the_dense_splits_k(clean_fusion):
    """At 64 <= N <= 128 and K > 64 the chain's dense splits K over a
    cluster, so the fused unit is not its bits: the pass consults no cache
    there, even one that holds the shape, and the chain runs."""
    k, n = 130, 70
    assert not fusable(k, n) and fusable(64, 128) and fusable(k, 129)
    assert search.candidates("norm_dense_act", (6, k, n)) == []
    x = _gauss((2, 3, k), 16)
    gain = torch.linspace(0.5, 1.5, k)
    layer = svi_to_pfp(dense_init(k, n, sigma_init=0.05, device="cpu"))
    wg = resolve_weight(layer.w, Context(mode=Mode.PFP, device="cpu"))
    want = dispatch.pfp_activation(
        dispatch.pfp_dense(dispatch.pfp_rmsnorm(x, gain), wg), "silu")
    tcache.global_cache().put("norm_dense_act", (6, k, n), "float32", "cpu",
                              Schedule.make("norm_dense_act", block_m=64,
                                            block_n=64))
    tcache.consult_counters(reset=True)
    with dispatch.fusion(True):
        got = dispatch.pfp_activation(
            dispatch.pfp_dense(dispatch.pfp_rmsnorm(x, gain), wg), "silu")
    assert tcache.consult_counters()["consults"] == 0
    assert torch.equal(got.mean, want.mean)
    assert torch.equal(got.second, want.second)


# ---------------------------------------------------------------------------
# Pendings
# ---------------------------------------------------------------------------
def _gauss(shape, seed, rep=VAR):
    rng = np.random.default_rng(seed)
    mu = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    var = torch.from_numpy(
        np.log1p(np.exp(rng.normal(size=shape))).astype(np.float32))
    return GaussianTensor(mu, var if rep == VAR else var + mu * mu, rep)


def _pending_norm():
    x = _gauss((2, 3, 8), 11)
    gain = torch.linspace(0.5, 1.5, 8)
    with dispatch.fusion(True):
        pending = dispatch.pfp_rmsnorm(x, gain)
    return pending, dispatch.pfp_rmsnorm(x, gain)


USES = {
    "mean": lambda p: p.mean, "second": lambda p: p.second,
    "rep": lambda p: p.rep, "var": lambda p: p.var, "srm": lambda p: p.srm,
    "shape": lambda p: p.shape, "dtype": lambda p: p.dtype,
    "reshape": lambda p: p.reshape(6, 8).mean,
    "add": lambda p: (p + p).mean, "radd": lambda p: (1.0 + p).mean,
    "to_srm": lambda p: p.to_srm().second, "eq": lambda p: p == p._force(),
    "repr": lambda p: repr(p),
}


@pytest.mark.parametrize("use", sorted(USES))
def test_pending_forces_its_value_on_every_read(clean_fusion, use):
    """The pending overrides the frozen dataclass's fields as properties
    and never runs its __init__: every read goes through the forced value,
    never an empty field."""
    pending, plain = _pending_norm()
    assert isinstance(pending, dispatch._PendingNorm)
    assert pending._value is None
    got = USES[use](pending)
    assert pending._value is not None
    want = USES[use](plain) if use not in ("eq", "repr") else None
    if isinstance(got, torch.Tensor):
        assert torch.equal(got, want)
    elif use == "eq":
        assert got is True
    elif use == "repr":
        assert got.startswith("_PendingNorm(mean=tensor(")
    else:
        assert got == want


def test_pending_equality_and_hash_use_the_value(clean_fusion):
    pending, _ = _pending_norm()
    forced = pending._force()
    assert pending == forced and forced == pending
    assert hash(pending) == hash(forced)
    other, _ = _pending_norm()
    assert other == other and other._value is not None


def test_pending_norm_consumed_otherwise_runs_unfused(clean_fusion):
    """A pending norm read by a residual, an attention projection (a dense
    whose value is read) or a dense with a bias gives the unfused values."""
    x = _gauss((2, 3, 8), 12)
    gain = torch.linspace(0.5, 1.5, 8)
    layer = svi_to_pfp(dense_init(8, 16, sigma_init=0.05, device="cpu"))
    wg = resolve_weight(layer.w, Context(mode=Mode.PFP, device="cpu"))
    bias = torch.full((16,), 0.1)
    ref_norm = dispatch.pfp_rmsnorm(x, gain)
    ref_dense = dispatch.pfp_dense(ref_norm, wg)
    with dispatch.fusion(True):
        pend = dispatch.pfp_rmsnorm(x, gain)
        res = dispatch.pfp_residual(x, pend)
        proj = dispatch.pfp_dense(pend, wg)
        biased = dispatch.pfp_dense(pend, wg, bias)
        glu = dispatch.pfp_glu_product(proj, proj)
    assert isinstance(proj, dispatch._PendingNormDense)
    assert not isinstance(biased, dispatch._PendingFusion)
    want_res = dispatch.pfp_residual(x, ref_norm)
    assert torch.equal(res.mean, want_res.mean)
    assert torch.equal(res.var, want_res.var)
    assert torch.equal(proj.mean, ref_dense.mean)
    assert torch.equal(proj.var, ref_dense.var)
    assert torch.equal(biased.mean, ref_dense.mean + bias)
    want_glu = dispatch.pfp_glu_product(ref_dense, ref_dense)
    assert torch.equal(glu.second, want_glu.second)


@pytest.mark.parametrize("hit", [False, True])
def test_gated_mlp_runs_its_norm_once(clean_fusion, monkeypatch, hit):
    """The gate and up projections share one pending norm: the norm op runs
    once, whether the gate fuses (hit) or both run unfused (miss)."""
    calls = []
    real = dispatch._REGISTRY["rmsnorm"]["kernel"]

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setitem(dispatch._REGISTRY["rmsnorm"], "kernel", counting)
    block = svi_to_pfp(MLPBlock(8, 16, sigma_init=0.05,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu"))
    x = _gauss((2, 3, 8), 13)
    gain = torch.linspace(0.5, 1.5, 8)
    ctx = Context(mode=Mode.PFP, device="cpu")
    want = mlp_apply(block, dispatch.pfp_rmsnorm(x, gain), ctx)
    calls.clear()
    if hit:
        tcache.global_cache().put(
            "norm_dense_act", (6, 8, 16), "float32", "cpu",
            search.candidates("norm_dense_act", (6, 8, 16))[0])
    with dispatch.fusion(True):
        got = mlp_apply(block, dispatch.pfp_rmsnorm(x, gain), ctx)
        assert torch.equal(got.mean, want.mean)
        assert torch.equal(got.var, want.var)
    assert len(calls) == 1
    assert tcache.consult_counters()["hits" if hit else "misses"] == 1


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lm_trees(jax_ref):
    jax = jax_ref["jax"]
    cfg = dataclasses.replace(jax_ref["reduced_config"](ARCH),
                              sigma_init=SIGMA)
    params = jax_ref["lm"].init_params(cfg, jax.random.PRNGKey(0))
    pfp = jax_ref["svi_to_pfp"](params, calibration_factor=CAL)
    return cfg, pfp, jax.tree_util.tree_map(np.asarray, pfp)


def _tokens(b=2, t=16):
    return {"tokens": np.random.default_rng(0).integers(
        0, 97, (b, t)).astype(np.int32)}


def _port_lm(tree):
    return load_numpy_params(lm.init_params(reduced_config(ARCH),
                                            device="cpu"), tree)


def _warm_port_cache(forward):
    """Run ``forward`` with fusion on under the recorder and cache the
    first candidate of every fused query it consulted."""
    with dispatch.fusion(True), tcache.record_shapes() as rec:
        forward()
    queries = {q for q in rec if q[0] == "norm_dense_act"}
    for op, key, dtype, backend in queries:
        tcache.global_cache().put(op, key, dtype, backend,
                                  search.candidates(op, key)[0])
    return queries


def test_lm_fused_matches_reference_fused(jax_ref, lm_trees, clean_fusion):
    jd, jc = jax_ref["dispatch"], jax_ref["cache"]
    cfg, pfp, tree = lm_trees
    inputs = _tokens()
    jctx = jax_ref["Context"](mode=jax_ref["Mode"].PFP, impl="kernel")
    jinputs = {k: jax_ref["jax"].numpy.asarray(v) for k, v in inputs.items()}
    with jd.fusion(True), jc.record_shapes() as jq:
        jax_ref["lm"].forward(pfp, cfg, jinputs, jctx)
    for op, key, dtype, backend in dict.fromkeys(jq):
        if op == "norm_dense_act":
            jc.global_cache().put(op, key, dtype, backend,
                                  jax_ref["Schedule"].make(
                                      op, block_m=8, block_n=128))
    with jd.fusion(True):
        want, _, _ = jax_ref["lm"].forward(pfp, cfg, jinputs, jctx)
    assert jc.consult_counters()["hits"] >= 1   # once per traced layer scan

    model = _port_lm(tree)
    ctx = Context(mode=Mode.PFP, impl="kernel", device="cpu")
    queries = _warm_port_cache(lambda: lm.forward(model, model.cfg, inputs,
                                                  ctx))
    assert [q[1] for q in queries] == [(32, 64, 128)]
    tcache.consult_counters(reset=True)
    with dispatch.fusion(True):
        got, _, _ = lm.forward(model, model.cfg, inputs, ctx)
    counts = tcache.consult_counters()
    assert counts["misses"] == 0 and counts["hits"] == cfg.num_layers
    np.testing.assert_array_equal(got.mean.argmax(-1).numpy(),
                                  np.asarray(want.mean).argmax(-1))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               **NDA_TOL)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var),
                               **NDA_TOL)


@pytest.mark.parametrize("case", ["miss", "eager", "hit"])
def test_lm_fusion_changes_no_bit_in_the_port(lm_trees, clean_fusion, case):
    """A cache miss runs the unfused chain; under ``eager`` the pass is off;
    on the CPU a hit runs the plain version, which is the chain."""
    model = _port_lm(lm_trees[2])
    impl = "eager" if case == "eager" else "kernel"
    ctx = Context(mode=Mode.PFP, impl=impl, device="cpu")
    run = lambda: lm.forward(model, model.cfg, _tokens(), ctx)[0]  # noqa
    base = run()
    if case == "hit":
        _warm_port_cache(run)
    tcache.consult_counters(reset=True)
    with dispatch.fusion(True):
        fused = run()
    counts = tcache.consult_counters()
    assert counts == ({"consults": 0, "hits": 0, "misses": 0}
                      if case == "eager" else
                      {"consults": 2, "hits": 2 * (case == "hit"),
                       "misses": 2 * (case == "miss")})
    assert torch.equal(fused.mean, base.mean)
    assert torch.equal(fused.var, base.var)


def test_lm_prefill_and_decode_fused_equal_unfused(lm_trees, clean_fusion):
    model = _port_lm(lm_trees[2])
    cfg = model.cfg
    ctx = Context(mode=Mode.PFP, device="cpu")
    prompt = {"tokens": _tokens(2, 8)["tokens"]}
    step = {"tokens": np.asarray([[3], [5]]), "positions":
            np.asarray([[8], [8]])}

    def run():
        last, states = lm.prefill(model, cfg, prompt, ctx, 12)
        logits, _ = lm.decode_step(model, cfg, step, states, ctx)
        return last, logits

    base = run()
    queries = _warm_port_cache(run)
    assert sorted(q[1] for q in queries) == [(2, 64, 128), (16, 64, 128)]
    tcache.consult_counters(reset=True)
    with dispatch.fusion(True):
        fused = run()
    assert tcache.consult_counters()["misses"] == 0
    for a, b in zip(base, fused):
        assert torch.equal(a.mean, b.mean) and torch.equal(a.var, b.var)


def test_norm_dense_act_op_impls(clean_fusion):
    """The registry op: its eager impl is the unfused chain, and its kernel
    impl (the plain version on the CPU) agrees with it."""
    x = _gauss((2, 5, 8), 14)
    w = _gauss((8, 16), 15)
    w = GaussianTensor(0.1 * w.mean, 0.01 * w.srm, SRM)
    gain, bias = torch.linspace(0.5, 1.5, 8), torch.full((8,), 0.2)
    for norm in NORMS:
        b = bias if norm == "layernorm" else None
        eager = dispatch.pfp_norm_dense_act(x, gain, b, w, norm=norm,
                                            impl="eager")
        kern = dispatch.pfp_norm_dense_act(x, gain, b, w, norm=norm,
                                           impl="kernel")
        assert eager.rep == kern.rep == SRM
        for part in ("mean", "second"):
            torch.testing.assert_close(getattr(kern, part),
                                       getattr(eager, part), rtol=1e-5,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("tile", TILES)
def test_kernel_matches_plain_and_unfused_chain_on_card(cuda, tile):
    sched = Schedule.make("norm_dense_act", block_m=tile[0],
                          block_n=tile[1])
    for i, (norm, rep, act, shape) in enumerate(OP_CASES):
        args = _t(_operands(*shape, seed=i, rep=rep), cuda)
        got = ops.pfp_norm_dense_act(*args, norm=norm, rep=rep, act=act,
                                     schedule=sched)
        torch.cuda.synchronize()
        want = ops.pfp_norm_dense_act(*(a.cpu() for a in args), norm=norm,
                                      rep=rep, act=act)
        chain = unfused_chain(*args, norm=norm, rep=rep, act=act)
        # The chain's dense splits K over a cluster for 64 <= N <= 128
        # (split_k > 1): its sums then run in another order than the fused
        # kernel's single pass, and the chain is held to the plain version.
        bitwise = split_k(shape[1], shape[2]) == 1
        for g, w, c in zip(got, want, chain):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       **DENSE_TOL)
            if bitwise:
                assert torch.equal(g, c), (norm, rep, act, shape, tile)
            else:
                np.testing.assert_allclose(c.cpu().numpy(), w.numpy(),
                                           **DENSE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", TILES)
def test_every_tile_is_the_chain_bitwise_at_a_gate_and_a_step(cuda, tile):
    """Every tile, both norms and both reps, at a reduced gate projection
    and at M 4: the unfused kernel chain's bits exactly."""
    sched = Schedule.make("norm_dense_act", block_m=tile[0],
                          block_n=tile[1])
    for shape in (REDUCED_GATE, DECODE_STEP):
        for i, (norm, rep) in enumerate((a, b) for a in NORMS for b in REPS):
            mu, second, gain, bias, mu_w, srm_w = _t(
                _operands(*shape, seed=50 + i, rep=rep), cuda)
            bias = bias if norm == "layernorm" else None
            kw = dict(norm=norm, rep=rep, act="silu")
            got = ops.pfp_norm_dense_act(mu, second, gain, bias, mu_w,
                                         srm_w, schedule=sched, **kw)
            chain = unfused_chain(mu, second, gain, bias, mu_w, srm_w, **kw)
            for g, c in zip(got, chain):
                assert torch.equal(g, c), (shape, norm, rep, tile)


@pytest.mark.gpu
def test_cuda_tensor_at_an_uninstantiated_config_raises(cuda):
    from repro_torch.kernels.pfp_fused import pfp_norm_dense_act_cuda
    args = _t(_operands(4, 8, 16, seed=1), cuda)
    for kw in (dict(act="softplus"), dict(tile=(8, 8)), dict(rep="std")):
        with pytest.raises(ValueError, match="no fused norm_dense_act"):
            pfp_norm_dense_act_cuda(*args, **kw)


@pytest.mark.gpu
def test_lm_fused_forward_on_card(cuda, clean_fusion):
    model = svi_to_pfp(lm.init_params(
        dataclasses.replace(reduced_config(ARCH), sigma_init=SIGMA),
        device=cuda), calibration_factor=CAL)
    ctx = Context(mode=Mode.PFP, impl="kernel", device=cuda)
    run = lambda: lm.forward(model, model.cfg, _tokens(), ctx)[0]  # noqa
    reset_launch_counts()
    base = run()
    assert LAUNCHES["norm_dense_act"] == 0
    _warm_port_cache(run)
    reset_launch_counts()
    with dispatch.fusion(True):
        fused = run()
    assert LAUNCHES["norm_dense_act"] == model.cfg.num_layers
    assert LAUNCHES["activation"] == 0
    assert torch.equal(fused.mean, base.mean)
    assert torch.equal(fused.var, base.var)
