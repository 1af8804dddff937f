"""The port's mixture-of-experts family against the JAX package.

Op level: on the CPU ``ops.pfp_dense_batched`` (Eq. 12, Eq. 13) and
``ops.pfp_dense_batched_var`` (Eq. 7) run their plain versions, held
against ``repro.kernels.ops``'s Pallas kernels in interpret mode under the
default and two other block schedules. Tolerance as tests/test_moe.py:
mean atol 1e-5, var atol 1e-4, rtol 0.

Layer and model level: the same numpy weights and inputs go through
``repro.nn.moe.moe_apply`` / ``repro.models.lm`` (``impl="xla"``,
``compute_dtype=None``) and the port, under both port impls and both
formulations. Routing is compared first: the expert ids of every MoE call
(the reference's recorded at its ``jax.lax.top_k``), then the keep mask
(replayed from the reference's ids with its capacity rule). A mismatch is
reported as such, with the token and its top-k margin; the smallest margin
is printed. Outputs at the model tolerance (mean rtol 1e-3 / atol 1e-4,
var rtol 1e-2 / atol 1e-5); the aux dict (loss, moe_dropped,
moe_assignments) at rtol 1e-6.

The tests marked ``gpu`` hold the batched CUDA kernel against its plain
version and, bit for bit, against the single dense kernel per expert, and
the paged pool against the contiguous one bit for bit; they skip where
there is no card. JAX is imported only by the fixtures that need it.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.gaussian import SRM, GaussianTensor
from repro_torch.core.modes import Mode
from repro_torch.kernels import ops, ref
from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
from repro_torch.kernels.pfp_dense import (MODE_FIRST_LAYER, MODE_SRM,
                                           MODE_VAR, pfp_dense_cuda)
from repro_torch.kernels.pfp_moe import pfp_dense_batched_cuda
from repro_torch.models import lm
from repro_torch.nn import moe
from repro_torch.nn.module import Context, load_numpy_params
from repro_torch.serving.batcher import Batcher, Request
from repro_torch.serving.engine import DecodeStatePool, PagedDecodeStatePool

ARCHS = ("deepseek-moe-16b", "llama4-scout-17b-a16e")
SIGMA, CAL = 0.02, 0.4
OP_MEAN_TOL = dict(rtol=0.0, atol=1e-5)
OP_VAR_TOL = dict(rtol=0.0, atol=1e-4)
DENSE_TOL = dict(rtol=1e-5, atol=1e-4)       # the kernel vs its plain version
MEAN_TOL = dict(rtol=1e-3, atol=1e-4)
VAR_TOL = dict(rtol=1e-2, atol=1e-5)
AUX_TOL = dict(rtol=1e-6, atol=0.0)
NEAR_TIE = 1e-4   # a routing mismatch at a larger top-k margin is a fault
BATCHED_SHAPES = [(4, 24, 40, 48), (3, 7, 130, 5)]
FORMS = ("srm", "first_layer", "var")


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's modules, imported only where a test needs them."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.bayes.convert import svi_to_pfp
    from repro.configs import get_config as jax_get_config
    from repro.configs import reduced_config as jax_reduced_config
    from repro.core.gaussian import SRM as JSRM
    from repro.core.gaussian import GaussianTensor as JGaussian
    from repro.kernels import ops as jops
    from repro.models import lm as jlm
    from repro.nn import moe as jmoe
    from repro.nn.module import Context as JContext
    from repro.tuning.schedules import DEFAULT_SCHEDULES
    from repro.tuning.search import candidates
    return dict(jax=jax, jnp=jnp, ops=jops, lm=jlm, moe=jmoe,
                Context=JContext, Gaussian=JGaussian, SRM=JSRM,
                svi_to_pfp=svi_to_pfp, get_config=jax_get_config,
                reduced_config=jax_reduced_config,
                default_schedules=DEFAULT_SCHEDULES, candidates=candidates)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol):
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


# ---------------------------------------------------------------------------
# Routing: recorded on both sides, compared before any output
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _jax_routes(jax_ref):
    """Record the reference's expert ids at every ``jax.lax.top_k`` (only
    ``nn/moe.py`` calls it), under jit and scan too."""
    jax, np_ = jax_ref["jax"], np
    log, orig = [], jax.lax.top_k

    def top_k(operand, k):
        vals, idx = orig(operand, k)
        jax.debug.callback(lambda i: log.append(np_.array(i)), idx,
                           ordered=True)
        return vals, idx

    jax.lax.top_k = top_k
    try:
        yield log
    finally:
        jax.lax.top_k = orig


def _replay_keep(idx, num_experts, capacity_factor):
    """The reference's keep mask from its expert ids: token-major counts
    against ``max(top_k, round(S * top_k * cf / E))``."""
    s, k = idx.shape
    capacity = max(k, round(s * k * capacity_factor / num_experts))
    seen = np.zeros(num_experts, np.int64)
    keep = np.zeros(s * k, bool)
    for i, e in enumerate(idx.reshape(-1)):
        keep[i] = seen[e] < capacity
        seen[e] += 1
    return keep


def _check_routing(port_routes, ref_ids, num_experts, capacity_factor):
    """Expert ids, then keep masks, call by call. Returns the smallest
    top-k margin among the port's tokens."""
    assert len(port_routes) == len(ref_ids) > 0
    smallest = np.inf
    for call, (r, want) in enumerate(zip(port_routes, ref_ids)):
        k = r.expert_idx.shape[-1]
        margin = moe.top_k_margin(r.probs, k).cpu().numpy()
        smallest = min(smallest, float(margin.min()))
        got = r.expert_idx.cpu().numpy()
        bad = np.nonzero((got != want).any(-1))[0]
        if bad.size:
            t = int(bad[0])
            kind = "a fault" if margin[t] > NEAR_TIE else "a near tie"
            pytest.fail(f"routing mismatch in MoE call {call} at token {t}: "
                        f"port {got[t].tolist()}, reference "
                        f"{want[t].tolist()}, top-{k} margin "
                        f"{margin[t]:.3e} ({kind})")
        np.testing.assert_array_equal(
            r.keep.cpu().numpy(),
            _replay_keep(want, num_experts, capacity_factor),
            err_msg=f"keep mask of MoE call {call}")
    print(f"routing equal in {len(port_routes)} MoE calls; smallest top-k "
          f"margin {smallest:.3e}")
    return smallest


def _check_aux(got, want):
    for key in ("loss", "moe_dropped", "moe_assignments"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   err_msg=key, **AUX_TOL)


def test_top_k_breaks_ties_to_the_lower_index(jax_ref):
    probs = np.asarray([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                        [0.1, 0.4, 0.1, 0.4]], np.float32)
    vals, idx = moe.top_k_lower_index(torch.from_numpy(probs), 3)
    want_vals, want_idx = jax_ref["jax"].lax.top_k(probs, 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    margin = moe.top_k_margin(torch.from_numpy(probs), 1).numpy()
    np.testing.assert_allclose(margin, [0.0, 0.0, 0.0])


# ---------------------------------------------------------------------------
# Rows 12 and 13: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
def _batched_operands(e, c, k, n, seed):
    """(mu_x, srm_x, mu_w, srm_w), as tests/test_moe.py draws them."""
    rng = np.random.default_rng(seed)
    mu_x = rng.normal(size=(e, c, k)).astype(np.float32)
    mu_w = (0.1 * rng.normal(size=(e, k, n))).astype(np.float32)
    return mu_x, mu_x ** 2 + 0.3, mu_w, mu_w ** 2 + 0.01


def _form_args(form, mu_x, srm_x, mu_w, srm_w):
    """The four operands of ``form``: Eq. 12 (mu_x, srm_x, mu_w, srm_w),
    Eq. 13 (x, x, mu_w, var_w), Eq. 7 (mu_x, var_x, mu_w, var_w)."""
    if form == "srm":
        return mu_x, srm_x, mu_w, srm_w
    if form == "first_layer":
        return mu_x, mu_x, mu_w, srm_w - mu_w ** 2
    return mu_x, srm_x - mu_x ** 2, mu_w, srm_w - mu_w ** 2


def _port_batched(form, *args):
    if form == "var":
        return ops.pfp_dense_batched_var(*args)
    return ops.pfp_dense_batched(*args, first_layer=form == "first_layer")


def _schedules(jax_ref, shape):
    """The default block schedule and two others of the tuner's space."""
    default = jax_ref["default_schedules"]["dense_batched"].describe()
    others = [s for s in jax_ref["candidates"]("dense_batched", shape)
              if s.describe() != default]
    return [None] + others[::max(1, len(others) // 2)][:2]


@pytest.mark.parametrize("shape", BATCHED_SHAPES)
@pytest.mark.parametrize("form", FORMS)
def test_batched_dense_matches_pallas_kernel(jax_ref, form, shape):
    args = _form_args(form, *_batched_operands(*shape, seed=sum(shape)))
    got = _port_batched(form, *_t(*args))
    assert tuple(got[0].shape) == (shape[0], shape[1], shape[3])
    jnp, jops = jax_ref["jnp"], jax_ref["ops"]
    scheds = _schedules(jax_ref, shape)
    assert len(scheds) == 3
    for sched in scheds:
        jargs = [jnp.asarray(a) for a in args]
        if form == "var":
            want = jops.pfp_dense_batched_var(*jargs, impl="kernel",
                                              schedule=sched)
        else:
            want = jops.pfp_dense_batched(*jargs, impl="kernel",
                                          schedule=sched,
                                          first_layer=form == "first_layer")
        _close(got[:1], want[:1], OP_MEAN_TOL)
        _close(got[1:], want[1:], OP_VAR_TOL)


def test_dense_batched_op_routes_by_formulation():
    """The registry's kernel impl: Eq. 13 for a plain x, Eq. 7 under
    'var', Eq. 12 otherwise; the eager impl agrees; CPU launches none."""
    from repro_torch.core import dispatch
    mu_x, srm_x, mu_w, srm_w = _t(*_batched_operands(3, 5, 9, 4, seed=1))
    w = GaussianTensor(mu_w, srm_w, SRM)
    x = GaussianTensor(mu_x, srm_x, SRM)
    reset_launch_counts()
    cases = {
        "srm": (x, ref.pfp_dense_batched_ref(mu_x, srm_x, mu_w, srm_w)),
        "var": (x, ref.pfp_dense_batched_var_ref(mu_x, x.var, mu_w, w.var)),
    }
    for formulation, (xin, want) in cases.items():
        for impl in ("eager", "kernel"):
            out = dispatch.pfp_dense_batched(xin, w, formulation=formulation,
                                             impl=impl)
            _close((out.mean, out.var), want, DENSE_TOL)
    want = ref.pfp_dense_batched_first_layer_ref(mu_x, mu_w, w.var)
    for impl in ("eager", "kernel"):
        out = dispatch.pfp_dense_batched(mu_x, w, impl=impl)
        _close((out.mean, out.var), want, DENSE_TOL)
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES
    with pytest.raises(ValueError, match="formulation"):
        dispatch.pfp_dense_batched(x, w, formulation="joint")


# ---------------------------------------------------------------------------
# The MoE layer against repro.nn.moe.moe_apply
# ---------------------------------------------------------------------------
D, FF, N_E, TOP_K = 16, 32, 4, 2


def _layer(jax_ref, gated, shared, seed=4):
    """Reference params (and their numpy tree) and a Gaussian input
    (2, 12, D) made with numpy."""
    jax = jax_ref["jax"]
    params = jax_ref["moe"].moe_init(
        jax.random.PRNGKey(seed), d_model=D, d_ff=FF, num_experts=N_E,
        num_shared=1 if shared else 0, gated=gated, sigma_init=1e-2)
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(2, 12, D)).astype(np.float32)
    srm = mu ** 2 + 0.1
    return params, jax.tree_util.tree_map(np.asarray, params), mu, srm


def _port_layer(tree, gated, shared):
    block = moe.MoE(D, FF, N_E, num_shared=1 if shared else 0, gated=gated,
                    device="cpu")
    return load_numpy_params(block, tree)


def _run_layer(jax_ref, params, tree, mu, srm, gated, shared, *, impl,
               formulation, **kw):
    """Both packages on the same weights and input; routing checked.
    Returns ((port out, port aux), (reference out, reference aux))."""
    jnp = jax_ref["jnp"]
    jx = jax_ref["Gaussian"](jnp.asarray(mu), jnp.asarray(srm), jax_ref["SRM"])
    jctx = jax_ref["Context"](mode="pfp", impl="xla", formulation=formulation)
    with _jax_routes(jax_ref) as ref_ids:
        want = jax_ref["moe"].moe_apply(params, jx, jctx, num_experts=N_E,
                                        top_k=TOP_K, **kw)
        jax_ref["jax"].effects_barrier()
    block = _port_layer(tree, gated, shared)
    ctx = Context(mode=Mode.PFP, impl=impl, formulation=formulation,
                  device="cpu")
    with moe.record_routing() as routes:
        got = moe.moe_apply(block, GaussianTensor(*_t(mu, srm), SRM), ctx,
                            num_experts=N_E, top_k=TOP_K, **kw)
    _check_routing(routes, ref_ids, N_E, kw.get("capacity_factor", 1.25))
    return got, want


@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("gated", [True, False])
def test_moe_apply_matches_reference(jax_ref, gated, shared, impl,
                                     formulation):
    params, tree, mu, srm = _layer(jax_ref, gated, shared)
    (out, aux), (want, want_aux) = _run_layer(
        jax_ref, params, tree, mu, srm, gated, shared, impl=impl,
        formulation=formulation, aux_loss=True)
    assert tuple(out.mean.shape) == (2, 12, D) and out.rep == "var"
    _close((out.mean,), (want.mean,), MEAN_TOL)
    _close((out.var,), (want.var,), VAR_TOL)
    _check_aux(aux, want_aux)
    assert float(aux["loss"]) > 0


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_moe_drops_match_reference(jax_ref, impl):
    """A capacity factor low enough that assignments drop: the same
    nonzero count in both packages; the inference path's loss is 0."""
    params, tree, mu, srm = _layer(jax_ref, True, True, seed=5)
    (out, aux), (want, want_aux) = _run_layer(
        jax_ref, params, tree, mu, srm, True, True, impl=impl,
        formulation="srm", capacity_factor=0.5, aux_loss=False)
    _close((out.mean,), (want.mean,), MEAN_TOL)
    _close((out.var,), (want.var,), VAR_TOL)
    _check_aux(aux, want_aux)
    assert float(aux["moe_dropped"]) > 0 and float(aux["loss"]) == 0.0
    assert float(aux["moe_assignments"]) == 2 * 12 * TOP_K


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_moe_token_chunks_match_reference(jax_ref, monkeypatch, impl):
    """More tokens than ``_TOKEN_CHUNK``: the chunk size, a module constant
    on both sides, is monkeypatched to 8, so 24 tokens route in three
    chunks (capacity per chunk, loss averaged, drops summed)."""
    import repro.nn.moe as jmoe_module
    monkeypatch.setattr(jmoe_module, "_TOKEN_CHUNK", 8)
    monkeypatch.setattr(moe, "_TOKEN_CHUNK", 8)
    params, tree, mu, srm = _layer(jax_ref, True, True, seed=6)
    (out, aux), (want, want_aux) = _run_layer(
        jax_ref, params, tree, mu, srm, True, True, impl=impl,
        formulation="srm", capacity_factor=1.0, aux_loss=True)
    _close((out.mean,), (want.mean,), MEAN_TOL)
    _close((out.var,), (want.var,), VAR_TOL)
    _check_aux(aux, want_aux)
    assert float(aux["moe_assignments"]) == 24 * TOP_K


def test_moe_deterministic_mode_matches_reference(jax_ref):
    params, tree, mu, _ = _layer(jax_ref, True, True, seed=7)
    jctx = jax_ref["Context"](mode="deterministic", impl="xla")
    with _jax_routes(jax_ref) as ref_ids:
        want, want_aux = jax_ref["moe"].moe_apply(
            params, jax_ref["jnp"].asarray(mu), jctx, num_experts=N_E,
            top_k=TOP_K)
        jax_ref["jax"].effects_barrier()
    block = _port_layer(tree, True, True)
    with moe.record_routing() as routes:
        got, aux = moe.moe_apply(
            block, torch.from_numpy(mu),
            Context(mode=Mode.DETERMINISTIC, device="cpu"),
            num_experts=N_E, top_k=TOP_K)
    _check_routing(routes, ref_ids, N_E, 1.25)
    _close((got,), (want,), MEAN_TOL)
    _check_aux(aux, want_aux)


# ---------------------------------------------------------------------------
# Configs and the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS + ("granite-8b",))
def test_configs_match_reference(jax_ref, arch):
    got = dataclasses.asdict(reduced_config(arch))
    want = dataclasses.asdict(jax_ref["reduced_config"](arch))
    assert got == {k: want[k] for k in got}
    full, jfull = get_config(arch), jax_ref["get_config"](arch)
    assert dataclasses.asdict(full) == {
        k: dataclasses.asdict(jfull)[k] for k in dataclasses.asdict(full)}
    assert full.param_count() == jfull.param_count()
    assert full.active_param_count() == jfull.active_param_count()
    assert full.pattern == jfull.pattern
    assert [full.layer_kind(i) for i in range(4)] == \
        [jfull.layer_kind(i) for i in range(4)]


def test_deepseek_width_as_published():
    cfg = get_config("deepseek-moe-16b")
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.num_experts,
            cfg.top_k, cfg.num_shared_experts, cfg.d_ff, cfg.vocab_size,
            cfg.first_dense_layers) == (2048, 16, 128, 64, 6, 2, 1408,
                                        102400, 1)
    cut = dataclasses.replace(cfg, num_layers=3)
    assert round(cut.param_count() / 1e6, 1) == 1620.6


@pytest.fixture(scope="module")
def trees(jax_ref):
    """Per arch: the reduced config, the reference's converted PFP params
    and their numpy tree."""
    jax = jax_ref["jax"]
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(jax_ref["reduced_config"](arch),
                                  sigma_init=SIGMA)
        # Jitted: one compile each instead of hundreds of eager ops.
        pfp = jax.jit(lambda key: jax_ref["svi_to_pfp"](
            jax_ref["lm"].init_params(cfg, key),
            calibration_factor=CAL))(jax.random.PRNGKey(0))
        out[arch] = (cfg, pfp, jax.tree_util.tree_map(np.asarray, pfp))
    return out


def _port(tree, arch):
    return load_numpy_params(lm.init_params(reduced_config(arch),
                                            device="cpu"), tree)


def _ctx(impl, formulation="srm"):
    return Context(mode=Mode.PFP, impl=impl, formulation=formulation,
                   device="cpu")


def _tokens(b=2, t=16, seed=0):
    return np.random.default_rng(seed).integers(0, 97, (b, t)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_forward(jax_ref, trees):
    """The reference's forward logits, aux and routed expert ids, per
    (arch, formulation)."""
    cache = {}

    def get(arch, formulation):
        if (arch, formulation) not in cache:
            cfg, pfp, _ = trees[arch]
            ctx = jax_ref["Context"](mode="pfp", impl="xla",
                                     formulation=formulation)
            fwd = jax_ref["jax"].jit(lambda tokens: jax_ref["lm"].forward(
                pfp, cfg, {"tokens": tokens}, ctx)[:2])
            with _jax_routes(jax_ref) as ids:
                out, aux = fwd(jax_ref["jnp"].asarray(_tokens()))
                jax_ref["jax"].effects_barrier()
            cache[(arch, formulation)] = (
                (np.asarray(out.mean), np.asarray(out.var)),
                {k: float(v) for k, v in aux.items()}, ids)
        return cache[(arch, formulation)]

    return get


@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_reference(trees, jax_forward, arch, impl,
                                      formulation):
    """Reduced deepseek-moe-16b (head0 + one MoE group, top-2 of 8, two
    shared experts) and llama4-scout-17b-a16e (two MoE groups, top-1 of 8,
    one shared): logits and the summed aux dict."""
    model = _port(trees[arch][2], arch)
    cfg = model.cfg
    want, want_aux, ref_ids = jax_forward(arch, formulation)
    reset_launch_counts()
    with moe.record_routing() as routes:
        out, aux, _ = lm.forward(model, cfg, {"tokens": _tokens()},
                                 _ctx(impl, formulation))
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES
    _check_routing(routes, ref_ids, cfg.num_experts, cfg.capacity_factor)
    assert tuple(out.mean.shape) == (2, 16, 97) and out.var.min() > 0
    _close((out.mean,), want[:1], MEAN_TOL)
    _close((out.var,), want[1:], VAR_TOL)
    _check_aux(aux, want_aux)
    groups = 1 if arch == "deepseek-moe-16b" else 2
    assert float(aux["moe_assignments"]) == groups * 2 * 16 * cfg.top_k


def test_lm_tree_has_the_reference_paths(trees):
    model = _port(trees["deepseek-moe-16b"][2], "deepseek-moe-16b")
    names = {n for n, _ in model.named_parameters()}
    assert "head0.mlp.w_up.w.mu" in names
    assert "stack.0.b0.moe.experts.w_gate.srm" in names
    assert "stack.0.b0.moe.router.w.mu" in names
    assert "stack.0.b0.moe.shared.w_down.w.srm" in names
    assert tuple(model.stack[0]["b0"].moe.experts.w_up.shape) == (8, 64, 128)


# ---------------------------------------------------------------------------
# Decode: prefill + decode steps, contiguous and paged
# ---------------------------------------------------------------------------
DECODE_ARCH = "deepseek-moe-16b"
PROMPT, MAX_LEN, STEPS, PS = 12, 32, 3, 8


def _greedy(mean):
    return np.argmax(np.asarray(mean)[:, -1], -1)[:, None].astype(np.int32)


def _page_table():
    p = MAX_LEN // PS
    return np.asarray([np.arange(1, 1 + p), np.arange(1 + p, 1 + 2 * p)],
                      np.int32), 1 + 2 * p


def _decode_run(step, prefill, tokens_fed=None):
    """Prefill a (2, PROMPT) prompt, then STEPS decode steps feeding
    ``tokens_fed`` (greedy when None). Returns (logits per pass, fed)."""
    last = prefill(_tokens(2, PROMPT, seed=3))
    outs, fed = [last], []
    tok = _greedy(last.mean)
    for i in range(STEPS):
        tok = tok if tokens_fed is None else tokens_fed[i]
        fed.append(tok)
        logits = step(tok, np.full((2, 1), PROMPT + i, np.int32))
        outs.append(logits)
        tok = _greedy(logits.mean)
    return outs, fed


def _contiguous(step_fn, prefill_fn):
    """Runner closures over a contiguous cache."""
    box = {}

    def prefill(tokens):
        last, box["states"] = prefill_fn(tokens)
        return last

    def step(tok, pos):
        logits, box["states"] = step_fn(
            {"tokens": tok, "positions": pos}, box["states"])
        return logits

    return step, prefill


def _paged(step_fn, init_fn):
    """Runner closures over a paged pool: the prompt as one chunk through
    the decode step, then single tokens."""
    table, num_pages = _page_table()
    box = {"states": init_fn(num_pages)}

    def prefill(tokens):
        pos = np.broadcast_to(np.arange(PROMPT, dtype=np.int32), (2, PROMPT))
        logits, box["states"] = step_fn(
            {"tokens": tokens, "positions": pos, "page_table": table,
             "cache_len": np.full(2, PROMPT, np.int32)}, box["states"])
        return logits

    def step(tok, pos):
        logits, box["states"] = step_fn(
            {"tokens": tok, "positions": pos, "page_table": table,
             "cache_len": (pos[:, 0] + 1).astype(np.int32)}, box["states"])
        return logits

    return step, prefill


@pytest.fixture(scope="module")
def jax_decode(jax_ref, trees):
    """The reference's contiguous and paged decode runs (xla impl,
    compute_dtype None: the port stays in fp32): logits per pass, fed
    tokens and routed expert ids."""
    jax, jlm, jnp = jax_ref["jax"], jax_ref["lm"], jax_ref["jnp"]
    cfg, pfp, _ = trees[DECODE_ARCH]
    ctx = jax_ref["Context"](mode="pfp", impl="xla", compute_dtype=None)
    decode = jax.jit(lambda inputs, states: jlm.decode_step(
        pfp, cfg, inputs, states, ctx))
    prefill = jax.jit(lambda tok: jlm.prefill(pfp, cfg, {"tokens": tok}, ctx,
                                              MAX_LEN))

    def step_fn(inputs, states):
        return decode({k: jnp.asarray(v) for k, v in inputs.items()}, states)

    out = {}
    with _jax_routes(jax_ref) as ids:
        out["contiguous"] = _decode_run(*_contiguous(
            step_fn, lambda tok: prefill(jnp.asarray(tok))))
        jax_ref["jax"].effects_barrier()
    out["contiguous_ids"] = list(ids)
    fed = out["contiguous"][1]
    with _jax_routes(jax_ref) as ids:
        out["paged"] = _decode_run(*_paged(
            step_fn, lambda n: jlm.init_paged_decode_state(cfg, n, PS)), fed)
        jax_ref["jax"].effects_barrier()
    out["paged_ids"] = list(ids)
    return out


def _port_runners(model, impl, paged):
    ctx = _ctx(impl)

    def step_fn(inputs, states):
        return lm.decode_step(model, model.cfg, inputs, states, ctx)

    if paged:
        return _paged(step_fn, lambda n: lm.init_paged_decode_state(
            model.cfg, n, PS, device=ctx.device))
    return _contiguous(step_fn, lambda tok: lm.prefill(
        model, model.cfg, {"tokens": tok}, ctx, MAX_LEN))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_decode_matches_reference(trees, jax_decode, impl, paged):
    model = _port(trees[DECODE_ARCH][2], DECODE_ARCH)
    name = "paged" if paged else "contiguous"
    want, fed = jax_decode[name]
    with moe.record_routing() as routes:
        got, _ = _decode_run(*_port_runners(model, impl, paged),
                             jax_decode["contiguous"][1])
    _check_routing(routes, jax_decode[f"{name}_ids"], model.cfg.num_experts,
                   model.cfg.capacity_factor)
    for g, w in zip(got, want):
        _close((g.mean,), (np.asarray(w.mean),), MEAN_TOL)
        _close((g.var,), (np.asarray(w.var),), VAR_TOL)


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_paged_equals_contiguous_in_the_port(trees, impl):
    """Port against port, both pools prefilling the prompt in one call of
    the same shape (2, PROMPT): the same routing and tokens, and logits
    within 1e-6 (the plain attention versions' BLAS calls on the CPU are
    not promised to be bitwise across buffers; on the card the pools agree
    bit for bit, which the gpu test below and chip_smoke.py check)."""
    model = _port(trees[DECODE_ARCH][2], DECODE_ARCH)
    runs = {}
    for paged in (False, True):
        with moe.record_routing() as routes:
            runs[paged] = _decode_run(*_port_runners(model, impl, paged),
                                      runs[False][1] if paged else None)
        runs[paged] += ([(r.expert_idx, r.keep) for r in routes],)
    (cont, fed, cont_routes), (paged, _, paged_routes) = runs[False], \
        runs[True]
    for (ia, ka), (ib, kb) in zip(cont_routes, paged_routes):
        assert torch.equal(ia, ib) and torch.equal(ka, kb)
    same = dict(rtol=1e-6, atol=1e-6)
    _close((paged[0].mean[:, -1:], paged[0].var[:, -1:]),
           (cont[0].mean, cont[0].var), same)
    for p, c in zip(paged[1:], cont[1:]):
        _close((p.mean, p.var), (c.mean, c.var), same)
    assert [_greedy(p.mean).tolist() for p in paged[:-1]] == \
        [t.tolist() for t in fed]


# ---------------------------------------------------------------------------
# The state pools with an MoE config
# ---------------------------------------------------------------------------
def test_decode_state_has_head_and_stack_leaves(jax_ref, trees):
    cfg = reduced_config(DECODE_ARCH)
    jcfg = trees[DECODE_ARCH][0]
    got = lm.init_decode_state(cfg, 3, 8, device="cpu")
    want = jax_ref["lm"].init_decode_state(jcfg, 3, 8)
    assert sorted(got) == sorted(want) == ["head0", "stack"]
    assert tuple(got["head0"].k_mu.shape) == want["head0"].k_mu.shape
    assert tuple(got["stack"]["b0"].k_mu.shape) == \
        want["stack"]["b0"].k_mu.shape
    paged = lm.init_paged_decode_state(cfg, 5, 4, device="cpu")
    jpaged = jax_ref["lm"].init_paged_decode_state(jcfg, 5, 4)
    assert tuple(paged["head0"].k_mu.shape) == jpaged["head0"].k_mu.shape
    assert tuple(paged["stack"]["b0"].k_mu.shape) == \
        jpaged["stack"]["b0"].k_mu.shape
    # Slot helpers along each leaf's own batch axis, as the reference.
    rng = np.random.default_rng(0)
    tree = {name: type(c)(*(rng.normal(size=tuple(a.shape)).astype(
        np.float32) for a in c)) for name, c in
        [("head0", got["head0"])]}
    tree["stack"] = {"b0": type(got["stack"]["b0"])(
        *(rng.normal(size=tuple(a.shape)).astype(np.float32)
          for a in got["stack"]["b0"]))}
    port = lm.load_numpy_decode_state(tree, device="cpu")
    jnp = jax_ref["jnp"]
    jtree = {"head0": type(want["head0"])(*(jnp.asarray(a) for a in
                                            tree["head0"])),
             "stack": {"b0": type(want["stack"]["b0"])(
                 *(jnp.asarray(a) for a in tree["stack"]["b0"]))}}
    for got_t, want_t in (
            (lm.take_decode_slots(port, [2, 0]),
             jax_ref["lm"].take_decode_slots(jtree, [2, 0])),
            (lm.reset_decode_slot(port, 1),
             jax_ref["lm"].reset_decode_slot(jtree, 1))):
        for g, w in zip(got_t["head0"], want_t["head0"]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(got_t["stack"]["b0"], want_t["stack"]["b0"]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _serve(model, pool, paged, requests, device="cpu"):
    """Drain ``requests`` through the pool's slots with impl="kernel":
    prefill each prompt in one call of shape (1, PROMPT), then lockstep
    greedy decode. Returns (finished requests by uid, last-step logits,
    [dropped, assignments])."""
    import copy
    from repro_torch.serving.decode import uncertainty_decode
    cfg = model.cfg
    ctx = Context(mode=Mode.PFP, impl="kernel", device=device)
    batcher = Batcher(pool.num_slots, MAX_LEN)
    for req in requests:
        batcher.submit(copy.deepcopy(req))
    last_token = np.zeros(pool.num_slots, np.int64)
    finished, last = [], None
    drops = [0.0, 0.0]

    def record(slot, token):
        last_token[slot] = token
        done = batcher.record(slot, token, 0.0, False)
        if done is not None:
            pool.evict(slot)
            finished.append(done)

    while not batcher.idle:
        for slot, req in batcher.fill_slots():
            assert pool.alloc(req.uid) == slot
            n = len(req.prompt)
            if paged:
                assert pool.ensure_capacity(slot, n)
                logits, aux, pool.states = lm.decode_step_with_aux(
                    model, cfg, {"tokens": req.prompt[None],
                                 "positions": np.arange(n)[None],
                                 "cache_len": np.asarray([n]),
                                 "page_table": pool.device_table(
                                     np.asarray([slot]))}, pool.states, ctx)
                drops[0] += float(aux["moe_dropped"])
                drops[1] += float(aux["moe_assignments"])
                logits = GaussianTensor(logits.mean[:, -1:],
                                        logits.second[:, -1:], logits.rep)
            else:
                logits, sub = lm.prefill(model, cfg,
                                         {"tokens": req.prompt[None]}, ctx,
                                         MAX_LEN)
                pool.write_slot(slot, sub)
            pool.positions[slot] = n
            record(slot, int(uncertainty_decode(
                logits.mean, logits.var,
                torch.Generator(device=device)).token[0]))
        live = [slot for slot, _ in batcher.active()]
        if not live:
            continue
        active = np.zeros(pool.num_slots, bool)
        active[live] = True
        pos = np.asarray(pool.positions, np.int64)
        inputs = {"tokens": np.where(active, last_token, 0)[:, None],
                  "positions": np.where(active, pos, 0)[:, None],
                  "cache_len": np.where(active, pos + 1, 0)}
        if paged:
            for slot in live:
                assert pool.ensure_capacity(slot, int(pos[slot]) + 1)
            inputs["page_table"] = pool.device_table()
        logits, aux, pool.states = lm.decode_step_with_aux(
            model, cfg, inputs, pool.states, ctx)
        assert float(aux["loss"]) == 0.0
        drops[0] += float(aux["moe_dropped"])
        drops[1] += float(aux["moe_assignments"])
        last = (logits.mean.clone(), logits.var.clone())
        tokens = uncertainty_decode(logits.mean, logits.var,
                                    torch.Generator(device=device)).token
        for slot in live:
            pool.positions[slot] += 1
            record(slot, int(tokens[slot]))
        pool.check_invariants()
    return sorted(finished, key=lambda r: r.uid), last, drops


def _requests(n=5):
    rng = np.random.default_rng(11)
    return [Request(uid=i, prompt=rng.integers(0, 97, PROMPT).astype(
        np.int32), max_new_tokens=int(rng.integers(2, 5))) for i in range(n)]


def test_pools_serve_an_moe_model_and_drain(trees):
    """Five requests through two slots on each pool: the same tokens, no
    slot or page live after the drain, the drops counted per step."""
    model = _port(trees[DECODE_ARCH][2], DECODE_ARCH)
    cont = _serve(model, DecodeStatePool(model.cfg, 2, MAX_LEN,
                                         device="cpu"), False, _requests())
    pool = PagedDecodeStatePool(model.cfg, 2, MAX_LEN, PS, device="cpu")
    paged = _serve(model, pool, True, _requests())
    assert len(cont[0]) == len(paged[0]) == 5
    for a, b in zip(cont[0], paged[0]):
        assert a.generated == b.generated and len(a.generated) > 0
    assert pool.live == 0 and pool.live_pages == 0
    assert paged[2][1] > 0 and cont[2][1] > 0


# ---------------------------------------------------------------------------
# The CUDA kernel (on the card only)
# ---------------------------------------------------------------------------
GPU_SHAPES = [(4, 24, 40, 48), (3, 7, 130, 5), (2, 1, 1, 1),
              (5, 70, 33, 129), (64, 6, 96, 80)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", GPU_SHAPES)
@pytest.mark.parametrize("form", FORMS)
def test_batched_kernel_matches_plain_on_card(cuda, form, shape):
    args = [a.to(cuda) for a in _t(*_form_args(
        form, *_batched_operands(*shape, seed=sum(shape))))]
    counter = {"srm": "dense_batched", "var": "dense_batched_var",
               "first_layer": "dense_batched_first_layer"}[form]
    before = LAUNCHES[counter]
    got = _port_batched(form, *args)
    torch.cuda.synchronize()
    assert LAUNCHES[counter] == before + 1
    if form == "var":
        want = ref.pfp_dense_batched_var_ref(*args)
    elif form == "first_layer":
        want = ref.pfp_dense_batched_first_layer_ref(args[0], *args[2:])
    else:
        want = ref.pfp_dense_batched_ref(*args)
    _close(got, [w.cpu() for w in want], DENSE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("form", FORMS)
def test_batched_kernel_is_the_dense_kernel_per_expert_on_card(cuda, form):
    """Each expert's slice bit for bit as the single dense kernel gives it,
    and a row's result independent of the other rows (a 3-row slice of the
    buffer gives the same 3 rows)."""
    mode = {"srm": MODE_SRM, "first_layer": MODE_FIRST_LAYER,
            "var": MODE_VAR}[form]
    args = [a.to(cuda) for a in _t(*_form_args(
        form, *_batched_operands(6, 240, 130, 70, seed=9)))]
    mu, var = pfp_dense_batched_cuda(*args, mode=mode)
    for e in range(args[0].shape[0]):
        one = pfp_dense_cuda(*(a[e] for a in args), mode=mode)
        assert torch.equal(one[0], mu[e]) and torch.equal(one[1], var[e])
    rows = [a[:, 100:103] if a.shape == args[0].shape else a for a in args]
    few = pfp_dense_batched_cuda(*rows, mode=mode)
    assert torch.equal(few[0], mu[:, 100:103])
    assert torch.equal(few[1], var[:, 100:103])


@pytest.mark.gpu
def test_batched_kernel_rejects_bad_operands_on_card(cuda):
    x = torch.zeros((2, 3, 4), device=cuda)
    w = torch.zeros((2, 5, 6), device=cuda)
    with pytest.raises(ValueError, match="shapes"):
        pfp_dense_batched_cuda(x, x, w, w, mode=MODE_SRM)
    with pytest.raises(ValueError, match="3-D"):
        pfp_dense_batched_cuda(x[0], x[0], w[0], w[0], mode=MODE_SRM)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pfp_dense_batched_cuda(x.cpu(), x.cpu(), w.cpu(), w.cpu(),
                               mode=MODE_SRM)


@pytest.mark.gpu
def test_paged_equals_contiguous_bitwise_on_card(cuda):
    """The reduced deepseek-moe-16b with random weights on the card, impl
    kernel: both pools prefill each prompt in one call of the same shape,
    and give the same tokens and bit-identical last-step logits."""
    model = lm.init_params(
        dataclasses.replace(reduced_config(DECODE_ARCH), sigma_init=SIGMA),
        generator=torch.Generator().manual_seed(0), device=cuda)
    cont = _serve(model, DecodeStatePool(model.cfg, 2, MAX_LEN, device=cuda),
                  False, _requests(), cuda)
    pool = PagedDecodeStatePool(model.cfg, 2, MAX_LEN, PS, device=cuda)
    paged = _serve(model, pool, True, _requests(), cuda)
    for a, b in zip(cont[0], paged[0]):
        assert a.generated == b.generated
    assert all(torch.equal(a, b) for a, b in zip(cont[1], paged[1]))
    assert pool.live == 0 and pool.live_pages == 0
