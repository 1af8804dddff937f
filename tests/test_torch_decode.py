"""KV-cache and paged PFP decode in the port against the JAX package.

Kernels: on the CPU ``ops.pfp_attention_cache`` / ``pfp_attention_paged``
run their plain versions, held against ``repro.kernels.ops``'s Pallas
kernels in interpret mode (``impl="kernel"``) and, where every query row
has a valid key, against the reference's oracles (``impl="xla"``): on a
row without one (a slot with ``kv_len`` 0) the oracle averages uniformly
while the Pallas kernel, and the port, return 0. Tolerance: attention's,
rtol 1e-4 / atol 1e-5 (tests/test_kernels.py).

Model: one JAX init of the reduced granite-8b (d_model 64, 4 heads of 16,
2 KV heads, d_ff 128, vocab 97, 2 layers; sigma_init 0.02), converted with
calibration 0.4, is carried across with ``load_numpy_params``. The same
numpy token ids go through ``repro.models.lm.prefill`` / ``decode_step``
(``impl="xla"``, ``compute_dtype=None``: the port stays in fp32) and the
port's, under both port impls. Logits at the model tolerance (mean rtol
1e-3 / atol 1e-4, var rtol 1e-2 / atol 1e-5), caches after prefill at
1e-5.

The tests marked ``gpu`` hold the CUDA kernels against their plain
versions on the card and skip where there is none. JAX is imported only
by the fixtures that need it, so ``python -m pytest -m gpu
tests/test_torch_decode.py`` also runs where it is absent.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import dispatch
from repro_torch.core.modes import Mode
from repro_torch.kernels import ops, ref
from repro_torch.kernels._launch import LAUNCHES, reset_launch_counts
from repro_torch.models import lm
from repro_torch.nn.attention import KVCache, PagedKVCache
from repro_torch.nn.module import Context, load_numpy_params
from repro_torch.serving import decode

ARCH = "granite-8b"
SIGMA = 0.02
CAL = 0.4
ATT_TOL = dict(rtol=1e-4, atol=1e-5)
MEAN_TOL = dict(rtol=1e-3, atol=1e-4)
VAR_TOL = dict(rtol=1e-2, atol=1e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT, MAX_LEN, STEPS = 12, 48, 4


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's modules, imported only where a test needs them."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.bayes.convert import svi_to_pfp
    from repro.configs import reduced_config as jax_reduced_config
    from repro.kernels import ops as jops
    from repro.models import lm as jlm
    from repro.nn.module import Context as JContext
    from repro.serving import decode as jdecode
    return dict(jax=jax, jnp=jnp, ops=jops, lm=jlm, Context=JContext,
                decode=jdecode, svi_to_pfp=svi_to_pfp,
                reduced_config=jax_reduced_config)


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
# Rows 10 and 11: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
def _q_kv(b, h, hkv, tq, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, tq, d)).astype(np.float32)
    k, vm = (rng.normal(size=(b, hkv, s, d)).astype(np.float32)
             for _ in range(2))
    vv = np.log1p(np.exp(rng.normal(size=(b, hkv, s, d)))).astype(np.float32)
    return q, k, vm, vv


def _pages(k, vm, vv, kv_len, ps, seed):
    """Scatter a contiguous cache (B, Hkv, S, D) into shuffled pages of a
    pool (page 0 the trash page, left random) and a table whose unused
    slots point at page 0. Returns (pools, table)."""
    rng = np.random.default_rng(seed)
    b, hkv, s, d = k.shape
    p = -(-s // ps)
    used = [-(-int(n) // ps) for n in kv_len]
    ids = rng.permutation(np.arange(1, 1 + sum(used) + 3))
    table = np.zeros((b, p), np.int32)
    pools = [rng.normal(size=(len(ids) + 1, hkv, ps, d)).astype(np.float32)
             for _ in range(3)]
    nxt = 0
    for bi in range(b):
        for j in range(used[bi]):
            page = ids[nxt]
            nxt += 1
            table[bi, j] = page
            rows = slice(j * ps, min((j + 1) * ps, s))
            n = rows.stop - rows.start
            for pool, src in zip(pools, (k, vm, vv)):
                pool[page, :, :n] = src[bi, :, rows].copy()
    return pools, table


# (B, H, Hkv, Tq, S, D, q_start, kv_len, window)
CACHE_CASES = {
    "decode_gqa4": (3, 8, 2, 1, 40, 16, [36, 9, 0], [37, 10, 1], None),
    "chunk": (2, 8, 2, 8, 40, 16, [0, 20], [8, 28], None),
    "window": (2, 4, 2, 6, 40, 16, [10, 30], [16, 36], 5),
    "kv_len0": (3, 4, 2, 1, 40, 16, [0, 5, 0], [0, 6, 0], None),
    "d128": (2, 8, 2, 3, 33, 128, [4, 29], [7, 32], None),
    "mha_d64": (3, 4, 4, 2, 40, 64, [0, 17, 38], [2, 19, 40], None),
}


def _cache_args(case, seed=0):
    b, h, hkv, tq, s, d, q_start, kv_len, window = CACHE_CASES[case]
    q, k, vm, vv = _q_kv(b, h, hkv, tq, s, d, seed)
    return (q, k, vm, vv, np.asarray(q_start, np.int32),
            np.asarray(kv_len, np.int32)), d ** -0.5, window


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_attention_matches_pallas_kernel(jax_ref, case):
    args, scale, window = _cache_args(case)
    got = ops.pfp_attention_cache(*_t(*args), scale=scale, window=window)
    want = jax_ref["ops"].pfp_attention_cache(*args, scale=scale,
                                              window=window, impl="kernel")
    _close(got, want, ATT_TOL)
    kv_len = args[5]
    dead = kv_len == 0
    if dead.any():   # a slot without a valid key comes out 0
        assert float(got[0][torch.from_numpy(dead)].abs().max()) == 0.0
        assert float(got[1][torch.from_numpy(dead)].abs().max()) == 0.0
    else:
        oracle = jax_ref["ops"].pfp_attention_cache(*args, scale=scale,
                                                    window=window, impl="xla")
        _close(got, oracle, ATT_TOL)
        _close(dispatch.pfp_attention_cache(*_t(*args), scale=scale,
                                            window=window, impl="eager"),
               oracle, ATT_TOL)


@pytest.mark.parametrize("ps", [1, 16, 24])
@pytest.mark.parametrize("case", ["decode_gqa4", "chunk", "window",
                                  "kv_len0", "mha_d64"])
def test_paged_attention_matches_pallas_kernel(jax_ref, case, ps):
    (q, k, vm, vv, q_start, kv_len), scale, window = _cache_args(case, 1)
    pools, table = _pages(k, vm, vv, kv_len, ps, seed=ps)
    args = (q, *pools, table, q_start, kv_len)
    got = ops.pfp_attention_paged(*_t(*args), scale=scale, window=window)
    want = jax_ref["ops"].pfp_attention_paged(*args, scale=scale,
                                              window=window, impl="kernel")
    _close(got, want, ATT_TOL)
    # The same keys through the contiguous plain version.
    _close(got, ops.pfp_attention_cache(*_t(q, k, vm, vv, q_start, kv_len),
                                        scale=scale, window=window),
           dict(rtol=1e-6, atol=1e-6))
    if not (kv_len == 0).any():
        oracle = jax_ref["ops"].pfp_attention_paged(*args, scale=scale,
                                                    window=window, impl="xla")
        _close(got, oracle, ATT_TOL)


def test_gather_kv_pages_matches_reference(jax_ref):
    rng = np.random.default_rng(3)
    pages = rng.normal(size=(7, 2, 4, 8)).astype(np.float32)
    table = np.asarray([[3, 1, 0], [6, 2, 5]], np.int32)
    from repro.kernels.ref import gather_kv_pages as jgather
    np.testing.assert_array_equal(
        ref.gather_kv_pages(*_t(pages, table)).numpy(),
        np.asarray(jgather(pages, table)))


def test_cache_ops_on_cpu_launch_nothing_and_check_window():
    args, scale, _ = _cache_args("chunk")
    reset_launch_counts()
    for impl in ("eager", "kernel"):
        dispatch.pfp_attention_cache(*_t(*args), scale=scale, impl=impl)
    assert LAUNCHES["attention_cache"] == LAUNCHES["attention_paged"] == 0
    from repro_torch.kernels.pfp_attention import _window
    assert _window(None) == 0 and _window(4) == 4
    with pytest.raises(ValueError, match="window"):
        _window(0)


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_kernel_matches_plain_on_card(cuda, case):
    args, scale, window = _cache_args(case)
    args = [a.to(cuda) for a in _t(*args)]
    before = LAUNCHES["attention_cache"]
    got = ops.pfp_attention_cache(*args, scale=scale, window=window)
    torch.cuda.synchronize()
    want = ref.pfp_attention_cache_ref(*args, scale, window=window)
    _close(got, [w.cpu() for w in want], ATT_TOL)
    assert LAUNCHES["attention_cache"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [1, 16, 24])
@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_paged_kernel_matches_plain_and_cache_kernel_on_card(cuda, case, ps):
    """Against the plain version at tolerance, and bit for bit against the
    cache kernel on the same keys (one template, one accumulation order)."""
    (q, k, vm, vv, q_start, kv_len), scale, window = _cache_args(case, 1)
    pools, table = _pages(k, vm, vv, kv_len, ps, seed=ps)
    args = [a.to(cuda) for a in _t(q, *pools, table, q_start, kv_len)]
    before = LAUNCHES["attention_paged"]
    got = ops.pfp_attention_paged(*args, scale=scale, window=window)
    torch.cuda.synchronize()
    want = ref.pfp_attention_paged_ref(*args, scale, window=window)
    _close(got, [w.cpu() for w in want], ATT_TOL)
    assert LAUNCHES["attention_paged"] == before + 1
    contiguous = ops.pfp_attention_cache(
        *[a.to(cuda) for a in _t(q, k, vm, vv, q_start, kv_len)],
        scale=scale, window=window)
    assert all(torch.equal(g, c) for g, c in zip(got, contiguous))


# ---------------------------------------------------------------------------
# The LM's decode path against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trees(jax_ref):
    jax = jax_ref["jax"]
    out = {}
    for window in (0, 8):
        cfg = dataclasses.replace(jax_ref["reduced_config"](ARCH),
                                  sigma_init=SIGMA, window=window)
        params = jax_ref["lm"].init_params(cfg, jax.random.PRNGKey(0))
        pfp = jax_ref["svi_to_pfp"](params, calibration_factor=CAL)
        out[window] = (cfg, pfp, jax.tree_util.tree_map(np.asarray, pfp))
    return out


def _port(tree, window=0):
    cfg = dataclasses.replace(reduced_config(ARCH), window=window)
    return load_numpy_params(lm.init_params(cfg, device="cpu"), tree)


def _prompt(b=2):
    return np.random.default_rng(0).integers(0, 97, (b, PROMPT)).astype(
        np.int32)


def _ctx(impl):
    return Context(mode=Mode.PFP, impl=impl, device="cpu")


def _np_moments(logits):
    return np.asarray(logits.mean), np.asarray(logits.var)


def _greedy(mean):
    return np.argmax(np.asarray(mean)[:, -1], -1)[:, None].astype(np.int32)


@pytest.fixture(scope="module")
def jax_decode(jax_ref, trees):
    """The reference's prefill and STEPS greedy decode steps on the
    contiguous cache, per window: (prefill logits, prefill states, [(fed
    tokens, logits)])."""
    jlm, jnp, JContext = jax_ref["lm"], jax_ref["jnp"], jax_ref["Context"]
    ctx = JContext(mode="pfp", impl="xla", compute_dtype=None)
    out = {}
    for window, (cfg, pfp, _) in trees.items():
        last, states = jlm.prefill(pfp, cfg, {"tokens": jnp.asarray(_prompt())},
                                   ctx, MAX_LEN)
        steps, tok = [], _greedy(last.mean)
        for i in range(STEPS):
            pos = np.full((2, 1), PROMPT + i, np.int32)
            logits, states_i = jlm.decode_step(
                pfp, cfg, {"tokens": jnp.asarray(tok),
                           "positions": jnp.asarray(pos)},
                states if i == 0 else states_i, ctx)
            steps.append((tok, _np_moments(logits)))
            tok = _greedy(logits.mean)
        out[window] = (_np_moments(last), states, steps)
    return out


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_prefill_and_decode_match_reference(trees, jax_decode, impl, window):
    model = _port(trees[window][2], window)
    want_last, want_states, want_steps = jax_decode[window]
    last, states = lm.prefill(model, model.cfg, {"tokens": _prompt()},
                              _ctx(impl), MAX_LEN)
    assert tuple(last.mean.shape) == (2, 1, 97)
    _close((last.mean, last.var), want_last, MEAN_TOL)
    _close((last.var,), want_last[1:], VAR_TOL)
    got_cache = states["stack"]["b0"]
    assert isinstance(got_cache, KVCache)
    assert tuple(got_cache.k_mu.shape) == (2, 2, 2, MAX_LEN, 16)
    _close(got_cache, [np.asarray(a) for a in want_states["stack"]["b0"]],
           CACHE_TOL)
    for i, (tok, want) in enumerate(want_steps):
        pos = np.full((2, 1), PROMPT + i, np.int32)
        logits, states = lm.decode_step(model, model.cfg,
                                        {"tokens": tok, "positions": pos},
                                        states, _ctx(impl))
        _close((logits.mean,), want[:1], MEAN_TOL)
        _close((logits.var,), want[1:], VAR_TOL)
        assert float(logits.var.min()) > 0


def test_decode_state_carries_across_from_the_reference(jax_ref, trees,
                                                       jax_decode):
    """A JAX prefill's cache, converted, decodes in the port as the port's
    own prefill does."""
    model = _port(trees[0][2])
    _, want_states, want_steps = jax_decode[0]
    states = lm.load_numpy_decode_state(
        jax_ref["jax"].tree_util.tree_map(np.asarray, want_states),
        device="cpu")
    assert isinstance(states["stack"]["b0"], KVCache)
    tok, want = want_steps[0]
    logits, _ = lm.decode_step(model, model.cfg,
                               {"tokens": tok,
                                "positions": np.full((2, 1), PROMPT)},
                               states, _ctx("kernel"))
    _close((logits.mean,), want[:1], MEAN_TOL)
    _close((logits.var,), want[1:], VAR_TOL)


def _paged_inputs(ps, tokens, positions, cache_len):
    """Page table of a 2-slot pool: slot b owns pages 1 + b * P ... ."""
    p = -(-MAX_LEN // ps)
    table = np.asarray([np.arange(1, 1 + p), np.arange(1 + p, 1 + 2 * p)],
                       np.int32)
    return {"tokens": tokens, "positions": positions, "page_table": table,
            "cache_len": np.asarray(cache_len, np.int32)}, 1 + 2 * p


def _paged_run(step, init, ps, steps_tokens):
    """Prefill the prompt as one chunk through the paged decode step, then
    feed ``steps_tokens``; returns the logits of every pass."""
    pos = np.broadcast_to(np.arange(PROMPT, dtype=np.int32), (2, PROMPT))
    inputs, num_pages = _paged_inputs(ps, _prompt(), pos, [PROMPT] * 2)
    states = init(num_pages)
    logits, states = step(inputs, states)
    outs = [logits]
    for i, tok in enumerate(steps_tokens):
        inputs, _ = _paged_inputs(ps, tok, np.full((2, 1), PROMPT + i,
                                                   np.int32),
                                  [PROMPT + i + 1] * 2)
        logits, states = step(inputs, states)
        outs.append(logits)
    return outs


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_paged_decode_matches_reference(jax_ref, trees, jax_decode, impl):
    ps = 16
    cfg, pfp, tree = trees[0]
    jlm, jnp = jax_ref["lm"], jax_ref["jnp"]
    jctx = jax_ref["Context"](mode="pfp", impl="xla", compute_dtype=None)
    toks = [tok for tok, _ in jax_decode[0][2]][:2]
    want = _paged_run(
        lambda inp, st: jlm.decode_step(
            pfp, cfg, {k: jnp.asarray(v) for k, v in inp.items()}, st, jctx),
        lambda n: jlm.init_paged_decode_state(cfg, n, ps), ps, toks)
    model = _port(tree)
    got = _paged_run(
        lambda inp, st: lm.decode_step(model, model.cfg, inp, st,
                                       _ctx(impl)),
        lambda n: lm.init_paged_decode_state(model.cfg, n, ps, device="cpu"),
        ps, toks)
    for g, w in zip(got, want):
        _close((g.mean,), (np.asarray(w.mean),), MEAN_TOL)
        _close((g.var,), (np.asarray(w.var),), VAR_TOL)


@pytest.mark.parametrize("ps", [1, 16, 24])
@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_paged_equals_contiguous_in_the_port(trees, impl, ps):
    """Port against port: the paged pool (one-chunk prefill, then decode)
    gives the contiguous cache's tokens, and its logits within 1e-6. (On
    the card the two kernels agree bit for bit, which chip_smoke.py and
    the gpu tests check; on the CPU both run PyTorch's plain versions,
    whose BLAS calls are not promised to be bitwise across buffers.)"""
    model = _port(trees[0][2])
    ctx = _ctx(impl)
    last, states = lm.prefill(model, model.cfg, {"tokens": _prompt()}, ctx,
                              MAX_LEN)
    tok, want = _greedy(last.mean), [last]
    fed = []
    for i in range(STEPS):
        fed.append(tok)
        logits, states = lm.decode_step(
            model, model.cfg,
            {"tokens": tok, "positions": np.full((2, 1), PROMPT + i)},
            states, ctx)
        want.append(logits)
        tok = _greedy(logits.mean)
    got = _paged_run(
        lambda inp, st: lm.decode_step(model, model.cfg, inp, st, ctx),
        lambda n: lm.init_paged_decode_state(model.cfg, n, ps, device="cpu"),
        ps, fed)
    same = dict(rtol=1e-6, atol=1e-6)
    _close((got[0].mean[:, -1:], got[0].var[:, -1:]),
           (want[0].mean, want[0].var), same)
    for g, w in zip(got[1:], want[1:]):
        _close((g.mean, g.var), (w.mean, w.var), same)
    assert [_greedy(g.mean).tolist() for g in got[:-1]] == \
        [t.tolist() for t in fed]


def test_paged_insert_redirects_to_the_trash_page(trees):
    """Rows at or past cache_len and below write_start land on page 0."""
    model = _port(trees[0][2])
    ps = 4
    states = lm.init_paged_decode_state(model.cfg, 6, ps, device="cpu")
    assert isinstance(states["stack"]["b0"], PagedKVCache)
    assert tuple(states["stack"]["b0"].k_mu.shape) == (2, 6, 2, ps, 16)
    inputs = {"tokens": _prompt(1)[:, :8],
              "positions": np.arange(8, dtype=np.int32)[None],
              "page_table": np.asarray([[2, 5, 0]], np.int32),
              "cache_len": np.asarray([6], np.int32),
              "write_start": np.asarray([2], np.int32)}
    _, new = lm.decode_step(model, model.cfg, inputs, states, _ctx("eager"))
    k = new["stack"]["b0"].k_mu
    assert float(k[:, 2, :, :2].abs().max()) == 0.0    # positions 0, 1
    assert float(k[:, 2, :, 2:].abs().min()) > 0.0     # positions 2, 3
    assert float(k[:, 5, :, :2].abs().min()) > 0.0     # positions 4, 5
    assert float(k[:, 5, :, 2:].abs().max()) == 0.0    # 6, 7: trash
    assert float(k[:, 0].abs().max()) > 0.0
    for p in (1, 3, 4):
        assert float(k[:, p].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# serving/decode.py
# ---------------------------------------------------------------------------
def test_uncertainty_decode_matches_reference_on_the_same_noise(jax_ref):
    jax, jnp = jax_ref["jax"], jax_ref["jnp"]
    rng = np.random.default_rng(5)
    mean = rng.normal(size=(3, 1, 97)).astype(np.float32)
    var = (0.5 * rng.random((3, 1, 97))).astype(np.float32)
    var[0, 0, 3] = -1e-9      # clamped at 0, as in the reference
    key = jax.random.PRNGKey(4)
    want = jax_ref["decode"].uncertainty_decode(
        jnp.asarray(mean), jnp.asarray(var), key, num_uncertainty_samples=16,
        mi_threshold=0.05)
    # The noise the reference drew, fed to the port.
    k_samp, _ = jax.random.split(key)
    eps = np.array(jax.random.normal(k_samp, (16, 3, 97), jnp.float32))
    got = decode.uncertainty_decode(*_t(mean, var), eps=torch.from_numpy(eps),
                                    mi_threshold=0.05)
    np.testing.assert_array_equal(got.token.numpy(), np.asarray(want.token))
    _close((got.mutual_info, got.total_unc),
           (want.mutual_info, want.total_unc), dict(rtol=1e-5, atol=1e-6))
    np.testing.assert_array_equal(got.abstain.numpy(),
                                  np.asarray(want.abstain))
    _close((got.logit_mean, got.logit_var), (want.logit_mean, want.logit_var),
           dict(rtol=0, atol=0))
    # Drawn from a generator: same shapes, greedy token unchanged.
    drawn = decode.uncertainty_decode(*_t(mean, var),
                                      torch.Generator().manual_seed(0))
    assert torch.equal(drawn.token, got.token)
    sampled = decode.uncertainty_decode(*_t(mean, var),
                                        torch.Generator().manual_seed(0),
                                        greedy=False)
    assert tuple(sampled.token.shape) == (3,)


def test_serve_and_prefill_steps_wrap_the_model(trees):
    model = _port(trees[0][2])
    (mean, var), states = decode.make_prefill_step(
        model.cfg, MAX_LEN, impl="kernel", device="cpu")(
        model, {"tokens": _prompt()})
    last, want_states = lm.prefill(model, model.cfg, {"tokens": _prompt()},
                                   _ctx("kernel"), MAX_LEN)
    assert torch.equal(mean, last.mean) and torch.equal(var, last.var)
    inputs = {"tokens": _greedy(mean), "positions": np.full((2, 1), PROMPT)}
    (mean, var), _ = decode.make_serve_step(
        model.cfg, impl="kernel", device="cpu")(model, inputs, states)
    logits, _ = lm.decode_step(model, model.cfg, inputs, want_states,
                               _ctx("kernel"))
    assert torch.equal(mean, logits.mean) and torch.equal(var, logits.var)
    (mean, var), _ = decode.make_serve_step(
        model.cfg, mode=Mode.DETERMINISTIC, device="cpu")(model, inputs,
                                                          states)
    assert float(var.abs().max()) == 0.0
