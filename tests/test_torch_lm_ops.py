"""The LM ops of the port against the JAX package, one op at a time.

On the CPU each wrapper of ``repro_torch.kernels.ops`` runs its kernel's
plain version; it is held against ``repro.kernels.ops.<op>(...,
impl="kernel")``, the Pallas kernel in interpret mode, on ragged shapes.
Attention is also held against the reference's oracle (``impl="xla"``)
where every query row has a valid key: on a row without one the oracle
returns a uniform average, while the Pallas kernel, and the port, return 0.
Tolerances are the reference's own (tests/test_kernels.py): norms and
attention rtol 1e-4 / atol 1e-5, GLU and the elementwise ops 1e-5 / 1e-5.

The tests marked ``gpu`` hold each CUDA kernel against its plain version
on the card and skip where there is none. JAX is imported only by the
tests that need it, so this file also runs where it is absent:
``python -m pytest -m gpu tests/test_torch_lm_ops.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import dispatch, pfp_attention, pfp_math
from repro_torch.core.gaussian import SRM, VAR, GaussianTensor
from repro_torch.kernels import ops, ref
from repro_torch.kernels._launch import LAUNCHES
from repro_torch.nn import attention, layers

NORM_TOL = dict(rtol=1e-4, atol=1e-5)
ELEMENTWISE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's modules, imported only where a test needs them."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import dispatch as jdispatch
    from repro.core import pfp_attention as jattention
    from repro.core import pfp_math as jmath
    from repro.core.gaussian import GaussianTensor as JGaussian
    from repro.kernels import ops as jops
    from repro.nn import layers as jlayers
    return dict(jnp=jnp, ops=jops, dispatch=jdispatch, math=jmath,
                attention=jattention, layers=jlayers, G=JGaussian)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pair(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    mu = (scale * rng.normal(size=shape)).astype(np.float32)
    var = (scale * np.log1p(np.exp(rng.normal(size=shape)))).astype(np.float32)
    return mu, var


def _second(mu, var, rep):
    return var if rep == "var" else var + mu ** 2


def _close(got, want, tol):
    for g, w in zip(got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# Norms, GLU: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d", [100, 128])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("rep", ["var", "srm"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_matches_pallas_kernel(jax_ref, norm, rep, act, d):
    mu, var = _pair((3, 5, d), d)
    second = _second(mu, var, rep)
    gain = np.random.default_rng(1).normal(size=d).astype(np.float32)
    bias = np.random.default_rng(2).normal(size=d).astype(np.float32)
    jops = jax_ref["ops"]
    if norm == "rmsnorm":
        got = ops.pfp_rmsnorm(*_t(mu, second, gain), rep=rep, act=act)
        want = jops.pfp_rmsnorm(mu, second, gain, rep=rep, act=act,
                                impl="kernel")
    else:
        got = ops.pfp_layernorm(*_t(mu, second, gain, bias), rep=rep, act=act)
        want = jops.pfp_layernorm(mu, second, gain, bias, rep=rep, act=act,
                                  impl="kernel")
    assert tuple(got[0].shape) == (3, 5, d)
    _close(got, want, NORM_TOL)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_registry_matches_reference_registry(jax_ref, norm):
    """Both port impls against the reference's xla impl, at the
    GaussianTensor level (the output rep follows the activation)."""
    mu, var = _pair((6, 48), 8)
    gain = np.random.default_rng(9).normal(size=48).astype(np.float32)
    bias = np.random.default_rng(10).normal(size=48).astype(np.float32)
    jd, jnp, JG = jax_ref["dispatch"], jax_ref["jnp"], jax_ref["G"]
    jx = JG(jnp.asarray(mu), jnp.asarray(var), VAR)
    x = GaussianTensor(*_t(mu, var), VAR)
    for act in (None, "relu", "gelu"):
        if norm == "rmsnorm":
            want = jd.pfp_rmsnorm(jx, jnp.asarray(gain), act=act, impl="xla")
        else:
            want = jd.pfp_layernorm(jx, jnp.asarray(gain), jnp.asarray(bias),
                                    act=act, impl="xla")
        for impl in ("eager", "kernel"):
            if norm == "rmsnorm":
                got = dispatch.pfp_rmsnorm(x, torch.from_numpy(gain), act=act,
                                           impl=impl)
            else:
                got = dispatch.pfp_layernorm(x, *_t(gain, bias), act=act,
                                             impl=impl)
            assert got.rep == want.rep == (SRM if act else VAR)
            _close((got.mean, got.second), (want.mean, want.second), NORM_TOL)


def test_layernorm_keeps_precision_under_a_large_mean():
    """The centred spread: rows offset by 100 against an fp64 version. The
    TPU kernel's moment form, sum(var + mu^2)/d - mu_tok^2, cancels there."""
    mu, var = _pair((4, 4096), 21)
    mu = mu + np.float32(100.0)
    gain = np.ones(4096, np.float32)
    got = ops.pfp_layernorm(*_t(mu, var, gain))
    want = _layernorm_fp64(mu, var)
    _close(got, want, NORM_TOL)
    m, v = _t(mu, var)
    tok = m.mean(-1, keepdim=True)
    moment = torch.mean(v + m * m, -1, keepdim=True) - tok * tok
    moment_mean = (m - tok) * torch.rsqrt(moment + 1e-6)
    assert np.abs(moment_mean.numpy() - want[0]).max() > \
        10 * np.abs(got[0].numpy() - want[0]).max()


def _layernorm_fp64(mu, var, eps=1e-6):
    mu, var = mu.astype(np.float64), var.astype(np.float64)
    tok = mu.mean(-1, keepdims=True)
    scale = 1.0 / np.sqrt((var + (mu - tok) ** 2).mean(-1, keepdims=True) + eps)
    return (mu - tok) * scale, var * scale ** 2


@pytest.mark.parametrize("shape", [(3, 7, 50), (4, 128)])
def test_glu_matches_pallas_kernel(jax_ref, shape):
    mu_a, var_a = _pair(shape, 3)
    mu_b, var_b = _pair(shape, 4)
    args = (mu_a, var_a + mu_a ** 2, mu_b, var_b + mu_b ** 2)
    got = ops.pfp_glu_product(*_t(*args))
    want = jax_ref["ops"].pfp_glu_product(*args, impl="kernel")
    _close(got, want, ELEMENTWISE_TOL)


def test_glu_registry_matches_reference(jax_ref):
    jd, jnp, JG = jax_ref["dispatch"], jax_ref["jnp"], jax_ref["G"]
    a, b = _pair((5, 24), 5), _pair((5, 24), 6)
    want = jd.pfp_glu_product(JG(*map(jnp.asarray, a), VAR),
                              JG(*map(jnp.asarray, b), VAR), impl="xla")
    for impl in ("eager", "kernel"):
        got = dispatch.pfp_glu_product(GaussianTensor(*_t(*a), VAR),
                                       GaussianTensor(*_t(*b), VAR), impl=impl)
        assert got.rep == SRM
        _close((got.mean, got.second), (want.mean, want.second),
               ELEMENTWISE_TOL)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
ATTENTION_CASES = [
    (16, 16, True), (16, 16, False),
    (37, 37, True), (37, 37, False),     # ragged
    (5, 37, True),                       # Tq < Tk: right-aligned causality
    (37, 16, True),                      # Tq > Tk: rows without a key
]


def _attention_inputs(tq, tk, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, 4, tq, d)).astype(np.float32)
    k, vm = (rng.normal(size=(2, 2, tk, d)).astype(np.float32)
             for _ in range(2))
    vv = np.log1p(np.exp(rng.normal(size=(2, 2, tk, d)))).astype(np.float32)
    return q, k, vm, vv


@pytest.mark.parametrize("tq,tk,causal", ATTENTION_CASES)
def test_attention_matches_pallas_kernel(jax_ref, tq, tk, causal):
    args = _attention_inputs(tq, tk)
    scale = 16 ** -0.5
    got = ops.pfp_attention(*_t(*args), scale=scale, causal=causal)
    want = jax_ref["ops"].pfp_attention(*args, scale=scale, causal=causal,
                                        impl="kernel")
    _close(got, want, NORM_TOL)
    if tq > tk and causal:  # rows without a valid key come out 0
        dead = tq - tk
        assert float(got[0][:, :, :dead].abs().max()) == 0.0
        assert float(got[1][:, :, :dead].abs().max()) == 0.0
    else:
        oracle = jax_ref["ops"].pfp_attention(*args, scale=scale,
                                              causal=causal, impl="xla")
        _close(got, oracle, NORM_TOL)
        _close(dispatch.pfp_attention(*_t(*args), scale=scale, causal=causal,
                                      impl="eager"), oracle, NORM_TOL)


@pytest.mark.parametrize("mode", ["mean_field", "variance_corrected"])
def test_core_pfp_attention_matches_reference(jax_ref, mode):
    jnp, JG = jax_ref["jnp"], jax_ref["G"]
    rng = np.random.default_rng(7)
    q, k, v = (_pair((2, 3, 9, 8), s) for s in (11, 12, 13))
    mask = np.tril(np.ones((9, 9), bool)) | (rng.random((9, 9)) < 0.2)
    want = jax_ref["attention"].pfp_attention(
        *(JG(jnp.asarray(m), jnp.asarray(s), VAR) for m, s in (q, k, v)),
        0.3, mask=jnp.asarray(mask), mode=mode)
    got = pfp_attention.pfp_attention(
        *(GaussianTensor(*_t(m, s), VAR) for m, s in (q, k, v)), 0.3,
        mask=torch.from_numpy(mask), mode=mode)
    _close((got.mean, got.var), (want.mean, want.var), NORM_TOL)


@pytest.mark.parametrize("variance_corrected", [False, True])
def test_chunked_core_matches_one_block(variance_corrected):
    """Queries in blocks of ``chunk_size`` give what one block gives."""
    rng = np.random.default_rng(24)
    q_mu, q_var = (torch.from_numpy(rng.random((2, 2, 2, 16, 8),
                                               dtype=np.float32))
                   for _ in range(2))
    k_mu, v_mu, v_var = (torch.from_numpy(rng.random((2, 2, 16, 8),
                                                     dtype=np.float32))
                         for _ in range(3))
    pos = torch.arange(16).expand(2, 16)
    kw = dict(q_pos=pos, k_pos=pos, causal=True, window=None, scale=0.3)
    q_var = q_var if variance_corrected else None
    one = attention._attention_core(q_mu, q_var, k_mu, v_mu, v_var,
                                    chunk_size=16, **kw)
    blocks = attention._attention_core(q_mu, q_var, k_mu, v_mu, v_var,
                                       chunk_size=4, **kw)
    _close(blocks, one, ELEMENTWISE_TOL)


# ---------------------------------------------------------------------------
# Elementwise algebra, RoPE, embedding, residual
# ---------------------------------------------------------------------------
def test_product_and_probit_algebra_match_reference(jax_ref):
    jm = jax_ref["math"]
    (ma, va), (mb, vb) = _pair((40,), 14), _pair((40,), 15)
    _close(pfp_math.product_moments(*_t(ma, va, mb, vb)),
           jm.product_moments(ma, va, mb, vb), ELEMENTWISE_TOL)
    _close(pfp_math.product_srm(*_t(ma, va, mb, vb)),
           jm.product_srm(ma, va, mb, vb), ELEMENTWISE_TOL)
    _close([pfp_math.probit_corrected_logits(*_t(ma, va))],
           [jm.probit_corrected_logits(ma, va)], ELEMENTWISE_TOL)


@pytest.mark.parametrize("gaussian", [True, False])
def test_rope_matches_reference(jax_ref, gaussian):
    jl, jnp, JG = jax_ref["layers"], jax_ref["jnp"], jax_ref["G"]
    positions = np.broadcast_to(np.arange(37, dtype=np.int32), (2, 37))
    cos, sin = layers.rope_angles(torch.from_numpy(positions.copy()), 16)
    jcos, jsin = jl.rope_angles(jnp.asarray(positions), 16)
    _close((cos, sin), (jcos, jsin), ELEMENTWISE_TOL)
    mu, var = _pair((2, 3, 37, 16), 16)
    cos, sin, jcos, jsin = cos[:, None], sin[:, None], jcos[:, None], jsin[:, None]
    if gaussian:
        got = layers.rope_apply(GaussianTensor(*_t(mu, var), VAR), cos, sin)
        want = jl.rope_apply(JG(jnp.asarray(mu), jnp.asarray(var), VAR),
                             jcos, jsin)
        _close((got.mean, got.var), (want.mean, want.var), ELEMENTWISE_TOL)
    else:
        _close([layers.rope_apply(torch.from_numpy(mu), cos, sin)],
               [jl.rope_apply(jnp.asarray(mu), jcos, jsin)], ELEMENTWISE_TOL)


def test_sinusoidal_embedding_matches_reference(jax_ref):
    got = layers.sinusoidal_embedding(torch.arange(37), 64)
    want = jax_ref["layers"].sinusoidal_embedding(jax_ref["jnp"].arange(37), 64)
    _close([got], [want], ELEMENTWISE_TOL)


@pytest.mark.parametrize("rep", ["var", "srm"])
def test_embedding_matches_reference(jax_ref, rep):
    jd, jnp, JG = jax_ref["dispatch"], jax_ref["jnp"], jax_ref["G"]
    mu, var = _pair((97, 24), 17)
    second = _second(mu, var, rep)
    ids = np.random.default_rng(18).integers(0, 97, (3, 11))
    want = jd.pfp_embedding(JG(jnp.asarray(mu), jnp.asarray(second), rep),
                            jnp.asarray(ids), impl="xla")
    for impl in ("eager", "kernel"):
        got = dispatch.pfp_embedding(GaussianTensor(*_t(mu, second), rep),
                                     torch.from_numpy(ids), impl=impl)
        assert got.rep == VAR
        _close((got.mean, got.second), (want.mean, want.second),
               ELEMENTWISE_TOL)


def test_residual_matches_reference(jax_ref):
    jd, jnp, JG = jax_ref["dispatch"], jax_ref["jnp"], jax_ref["G"]
    (ma, va), (mb, _) = _pair((4, 9), 19), _pair((4, 9), 20)
    sa = va + ma ** 2
    want = jd.pfp_residual(JG(jnp.asarray(ma), jnp.asarray(sa), SRM),
                           jnp.asarray(mb))
    for impl in ("eager", "kernel"):
        got = dispatch.pfp_residual(GaussianTensor(*_t(ma, sa), SRM),
                                    torch.from_numpy(mb), impl=impl)
        _close((got.mean, got.second), (want.mean, want.second),
               ELEMENTWISE_TOL)


def test_cpu_tensors_run_the_plain_versions():
    """The CPU path is the plain version itself and launches nothing."""
    before = dict(LAUNCHES)
    mu, var = _t(*_pair((3, 40), 22))
    gain = torch.ones(40)
    assert all(torch.equal(g, w) for g, w in zip(
        ops.pfp_rmsnorm(mu, var, gain, act="silu"),
        ref.pfp_rmsnorm_ref(mu, var, gain, act="silu")))
    assert all(torch.equal(g, w) for g, w in zip(
        ops.pfp_glu_product(mu, var, var, mu), ref.pfp_glu_ref(mu, var, var, mu)))
    q, k, vm, vv = _t(*_attention_inputs(7, 9))
    assert all(torch.equal(g, w) for g, w in zip(
        ops.pfp_attention(q, k, vm, vv, scale=0.25),
        ref.pfp_attention_ref(q, k, vm, vv, 0.25)))
    assert LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("rows,d", [(2048, 4096), (33, 100), (1, 4096)])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("rep", ["var", "srm"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_kernel_matches_plain_on_card(cuda, norm, rep, act, rows, d):
    mu, var = _pair((rows, d), rows + d)
    second = _second(mu, var, rep)
    mu, second = (a.to(cuda) for a in _t(mu, second))
    gain = torch.from_numpy(np.random.default_rng(3).normal(size=d)
                            .astype(np.float32)).to(cuda)
    bias = torch.from_numpy(np.random.default_rng(4).normal(size=d)
                            .astype(np.float32)).to(cuda)
    before = LAUNCHES[norm]
    if norm == "rmsnorm":
        got = ops.pfp_rmsnorm(mu, second, gain, rep=rep, act=act)
        want = ref.pfp_rmsnorm_ref(mu, second, gain, rep=rep, act=act)
    else:
        got = ops.pfp_layernorm(mu, second, gain, bias, rep=rep, act=act)
        want = ref.pfp_layernorm_ref(mu, second, gain, bias, rep=rep, act=act)
    torch.cuda.synchronize()
    _close(got, [w.cpu() for w in want], NORM_TOL)
    assert LAUNCHES[norm] == before + 1


@pytest.mark.gpu
def test_layernorm_kernel_keeps_precision_under_a_large_mean(cuda):
    mu, var = _pair((4, 4096), 23)
    mu = mu + np.float32(100.0)
    args = [a.to(cuda) for a in _t(mu, var)]
    got = ops.pfp_layernorm(*args, torch.ones(4096, device=cuda))
    torch.cuda.synchronize()
    _close(got, _layernorm_fp64(mu, var), NORM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2048, 14336), (7, 333)])
def test_glu_kernel_matches_plain_on_card(cuda, shape):
    mu_a, var_a = _pair(shape, 5)
    mu_b, var_b = _pair(shape, 6)
    args = [a.to(cuda) for a in _t(mu_a, var_a + mu_a ** 2, mu_b,
                                   var_b + mu_b ** 2)]
    before = LAUNCHES["glu_product"]
    got = ops.pfp_glu_product(*args)
    # An operand 4 bytes off 16-byte alignment takes the scalar path.
    got_odd = ops.pfp_glu_product(*(a.reshape(-1)[1:] for a in args))
    torch.cuda.synchronize()
    _close(got, [w.cpu() for w in ref.pfp_glu_ref(*args)], ELEMENTWISE_TOL)
    _close(got_odd, [w.cpu() for w in ref.pfp_glu_ref(
        *(a.reshape(-1)[1:] for a in args))], ELEMENTWISE_TOL)
    assert LAUNCHES["glu_product"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,hkv,tq,tk,d,causal", [
    (4, 32, 8, 512, 512, 128, True), (4, 32, 8, 512, 512, 128, False),
    (2, 4, 2, 37, 37, 16, True), (2, 4, 2, 5, 37, 128, True),
    (2, 4, 2, 37, 16, 128, True), (1, 2, 1, 70, 70, 16, True),
    (2, 4, 4, 33, 33, 128, False),
])
def test_attention_kernel_matches_plain_on_card(cuda, b, h, hkv, tq, tk, d,
                                                causal):
    rng = np.random.default_rng(tq + tk + d)
    q = rng.normal(size=(b, h, tq, d)).astype(np.float32)
    k, vm = (rng.normal(size=(b, hkv, tk, d)).astype(np.float32)
             for _ in range(2))
    vv = np.log1p(np.exp(rng.normal(size=(b, hkv, tk, d)))).astype(np.float32)
    args = [a.to(cuda) for a in _t(q, k, vm, vv)]
    before = LAUNCHES["attention"]
    got = ops.pfp_attention(*args, scale=d ** -0.5, causal=causal)
    torch.cuda.synchronize()
    want = ref.pfp_attention_ref(*args, d ** -0.5, causal)
    _close(got, [w.cpu() for w in want], NORM_TOL)
    assert LAUNCHES["attention"] == before + 1
