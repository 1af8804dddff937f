"""The audio decoder (musicgen-medium) in the port against the JAX reference.

One JAX init of the reduced musicgen-medium (d_model 64, 4 heads of 16 over
4 KV heads: MHA, LayerNorm with a bias, an ungated gelu MLP, sinusoidal
positions, vocab 97, 2 layers, no token table: the inputs are frame
embeddings; sigma_init 0.02) is converted with calibration factor 0.4 and
carried across with ``load_numpy_params``. The same seeded numpy frame
embeddings go through ``repro.models.lm`` and the port's ``lm``: the
forward in DET and PFP (both formulations), ``prefill`` and three
``decode_step`` calls on the contiguous cache (each step adds the sinusoid
of position 0, as the reference does). A second config sets head_dim 64,
musicgen's own width, so that width runs through the plain versions too.
Port against port: the paged pool gives the contiguous pool's logits bit
for bit when both prefill in chunks through ``decode_step``. Tolerances
are tests/test_impl_dispatch.py's model-level ones: mean rtol 1e-3 / atol
1e-4, var rtol 1e-2 / atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.bayes.convert import svi_to_pfp as jax_svi_to_pfp
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import lm as jlm
from repro.nn.module import Context as JContext
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.modes import Mode
from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
from repro_torch.models import lm
from repro_torch.nn.module import Context, load_numpy_params
from repro_torch.serving import decode
from repro_torch.serving.engine import DecodeStatePool, PagedDecodeStatePool

ARCH = "musicgen-medium"
SIGMA = 0.02
CAL = 0.4
MEAN_TOL = dict(rtol=1e-3, atol=1e-4)
VAR_TOL = dict(rtol=1e-2, atol=1e-5)
B, PROMPT, STEPS, MAX_LEN = 2, 12, 3, 32
# Configs by id: the reduced config, and the same at musicgen's head_dim.
HEAD_DIMS = {"d16": 16, "d64": 64}


def _frames(b, t, seed):
    return np.random.default_rng(seed).normal(size=(b, t, 64)).astype(
        np.float32)


def _port_cfg(name):
    return dataclasses.replace(reduced_config(ARCH),
                               head_dim=HEAD_DIMS[name])


@pytest.fixture(scope="module", params=sorted(HEAD_DIMS))
def trees(request):
    """(id, reference config, variational tree, PFP tree, PFP numpy tree)."""
    cfg = dataclasses.replace(jax_reduced_config(ARCH), sigma_init=SIGMA,
                              head_dim=HEAD_DIMS[request.param])
    params = jlm.init_params(cfg, jax.random.PRNGKey(0))
    pfp = jax_svi_to_pfp(params, calibration_factor=CAL)
    return (request.param, cfg, params, pfp,
            jax.tree_util.tree_map(np.asarray, pfp))


def _port(trees, tree=None):
    name, _, _, _, pfp_np = trees
    return load_numpy_params(lm.init_params(_port_cfg(name), device="cpu"),
                             pfp_np if tree is None else tree)


def _ctx(impl, formulation="srm"):
    return Context(mode=Mode.PFP, impl=impl, formulation=formulation,
                   device="cpu")


def _close(got, want):
    assert float(got.var.min()) > 0
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               **MEAN_TOL)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var),
                               **VAR_TOL)


def _flat(tree, prefix=""):
    """{dotted path: shape} of a reference tree, its stacked layer groups
    spread over their leading axis as the port's ModuleList numbers them."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and k == "stack":
            n = len(jax.tree_util.tree_leaves(v)[0])
            for i in range(n):
                out.update(_flat(jax.tree_util.tree_map(lambda a: a[i], v),
                                 f"{prefix}stack.{i}."))
        elif isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(np.shape(v))
    return out


def test_config_and_param_count_match_reference():
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (reduced_config(ARCH), jax_reduced_config(ARCH))):
        got = dataclasses.asdict(port)
        want = dataclasses.asdict(ref)
        assert got == {k: want[k] for k in got}
        assert port.param_count() == ref.param_count()
    full = get_config(ARCH)
    assert (full.family, full.embed_inputs, full.d_model, full.num_heads,
            full.num_kv_heads, full.head_dim, full.d_ff, full.num_layers) == \
        ("audio", False, 1536, 24, 24, 64, 6144, 48)
    assert full.param_count() == 1_362_100_224


def test_parameter_paths_match_reference(trees):
    """No ``embed``: the reference's tree loads as it is, every leaf under
    its own path and shape."""
    model = _port(trees)
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert got == _flat(trees[4])
    assert not any(k.startswith("embed") for k in got)
    variational = lm.init_params(_port_cfg(trees[0]), device="cpu")
    assert {k: tuple(v.shape) for k, v in variational.named_parameters()} \
        == _flat(jax.tree_util.tree_map(np.asarray, trees[2]))


@pytest.mark.parametrize("formulation", ["srm", "var"])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_pfp_forward_matches_reference(trees, impl, formulation):
    _, cfg, _, pfp, _ = trees
    frames = _frames(B, PROMPT, 0)
    want, _, _ = jlm.forward(pfp, cfg, {"frame_embeddings": jnp.asarray(
        frames)}, JContext(mode="pfp", impl="xla", formulation=formulation))
    model = _port(trees)
    got, _, state = lm.forward(model, model.cfg, {"frame_embeddings": frames},
                               _ctx(impl, formulation))
    assert tuple(got.mean.shape) == (B, PROMPT, 97) and state is None
    _close(got, want)


def test_deterministic_forward_matches_reference(trees):
    _, cfg, params, _, _ = trees
    frames = _frames(B, PROMPT, 1)
    want, _, _ = jlm.forward(params, cfg, {"frame_embeddings": jnp.asarray(
        frames)}, JContext(mode="deterministic"))
    model = _port(trees, jax.tree_util.tree_map(np.asarray, params))
    got, _, _ = lm.forward(model, model.cfg, {"frame_embeddings": frames},
                           Context(mode=Mode.DETERMINISTIC, device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MEAN_TOL)


@pytest.fixture(scope="module")
def jax_decode(trees):
    """The reference's prefill of PROMPT frames and STEPS decode steps
    (each fed one seeded frame) on the contiguous cache."""
    _, cfg, _, pfp, _ = trees
    ctx = JContext(mode="pfp", impl="xla", compute_dtype=None)
    last, states = jlm.prefill(pfp, cfg, {"frame_embeddings": jnp.asarray(
        _frames(B, PROMPT, 2))}, ctx, MAX_LEN)
    steps = []
    for i in range(STEPS):
        logits, states = jlm.decode_step(pfp, cfg, {
            "frame_embeddings": jnp.asarray(_frames(B, 1, 10 + i)),
            "positions": jnp.full((B, 1), PROMPT + i, jnp.int32)}, states,
            ctx)
        steps.append(logits)
    return last, steps


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_prefill_and_decode_match_reference(trees, jax_decode, impl):
    model = _port(trees)
    want_last, want_steps = jax_decode
    last, states = lm.prefill(model, model.cfg,
                              {"frame_embeddings": _frames(B, PROMPT, 2)},
                              _ctx(impl), MAX_LEN)
    assert tuple(last.mean.shape) == (B, 1, 97)
    _close(last, want_last)
    for i, want in enumerate(want_steps):
        logits, states = lm.decode_step(model, model.cfg, {
            "frame_embeddings": _frames(B, 1, 10 + i),
            "positions": np.full((B, 1), PROMPT + i)}, states, _ctx(impl))
        _close(logits, want)


def _pool_run(model, ctx, paged, ps=4, chunk=8):
    """Two slots through a pool: prompts of PROMPT and PROMPT - 5 frames,
    each prefilled in chunks of ``chunk`` through ``decode_step`` on its
    own (contiguous: the slot's view, then written back), then STEPS
    lockstep steps of both slots. Returns every pass's logits."""
    cfg = model.cfg
    if paged:
        pool = PagedDecodeStatePool(cfg, B, MAX_LEN, ps, device="cpu")
    else:
        pool = DecodeStatePool(cfg, B, MAX_LEN, device="cpu")
    outs = []
    lens = (PROMPT, PROMPT - 5)
    for uid, n in enumerate(lens):
        slot = pool.alloc(uid)
        frames = _frames(1, n, 20 + uid)
        sub = None if paged else pool.take_slot(slot)
        for c0 in range(0, n, chunk):
            part = np.zeros((1, chunk, 64), np.float32)
            part[0, :min(chunk, n - c0)] = frames[0, c0:c0 + chunk]
            inputs = {"frame_embeddings": part,
                      "positions": (c0 + np.arange(chunk))[None],
                      "cache_len": np.asarray([min(n, c0 + chunk)])}
            if paged:
                assert pool.ensure_capacity(slot, min(n, c0 + chunk))
                inputs["page_table"] = pool.device_table(np.asarray([slot]))
                logits, pool.states = lm.decode_step(model, cfg, inputs,
                                                     pool.states, ctx)
            else:
                logits, sub = lm.decode_step(model, cfg, inputs, sub, ctx)
            outs.append(logits)
        if not paged:
            pool.write_slot(slot, sub)
        pool.positions[slot] = n
    for i in range(STEPS):
        pos = np.asarray(pool.positions, np.int64)
        inputs = {"frame_embeddings": _frames(B, 1, 30 + i),
                  "positions": pos[:, None], "cache_len": pos + 1}
        if paged:
            for slot in range(B):
                assert pool.ensure_capacity(slot, int(pos[slot]) + 1)
            inputs["page_table"] = pool.device_table()
        logits, pool.states = lm.decode_step(model, cfg, inputs, pool.states,
                                             ctx)
        outs.append(logits)
        for slot in range(B):
            pool.positions[slot] += 1
    pool.check_invariants()
    return outs


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_paged_equals_contiguous_bit_for_bit(trees, impl):
    """Port against port, the same chunks and steps on both pools: every
    pass's logits are equal, bit for bit."""
    model = _port(trees)
    ctx = _ctx(impl)
    cont = _pool_run(model, ctx, paged=False)
    paged = _pool_run(model, ctx, paged=True)
    assert len(cont) == len(paged) == 2 + 1 + STEPS
    for a, b in zip(cont, paged):
        assert torch.equal(a.mean, b.mean) and torch.equal(a.var, b.var)


def test_serve_and_prefill_steps_take_frame_embeddings(trees):
    model = _port(trees)
    frames = {"frame_embeddings": _frames(B, PROMPT, 2)}
    (mean, var), states = decode.make_prefill_step(
        model.cfg, MAX_LEN, impl="kernel", device="cpu")(model, frames)
    last, want_states = lm.prefill(model, model.cfg, frames, _ctx("kernel"),
                                   MAX_LEN)
    assert torch.equal(mean, last.mean) and torch.equal(var, last.var)
    inputs = {"frame_embeddings": _frames(B, 1, 10),
              "positions": np.full((B, 1), PROMPT)}
    (mean, var), _ = decode.make_serve_step(
        model.cfg, impl="kernel", device="cpu")(model, inputs, states)
    logits, _ = lm.decode_step(model, model.cfg, inputs, want_states,
                               _ctx("kernel"))
    assert torch.equal(mean, logits.mean) and torch.equal(var, logits.var)
    out = decode.uncertainty_decode(mean, var,
                                    torch.Generator().manual_seed(0))
    assert tuple(out.token.shape) == (B,)


def test_kernel_impl_on_cpu_launches_nothing(trees):
    model = _port(trees)
    reset_launch_counts()
    model({"frame_embeddings": _frames(B, PROMPT, 0)}, _ctx("kernel"))
    assert all(v == 0 for v in LAUNCHES.values()), LAUNCHES
