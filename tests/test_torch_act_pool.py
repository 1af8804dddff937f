"""Rows 3 and 4 of the TPU kernels, the activation and the Clark max pool,
as the port runs them: their launch plans, the pool's SRM input, and on
the card the kernels against their plain versions.

On the CPU: the ``kernel`` impl's pool of an SRM ``GaussianTensor`` is bit
for bit the pool of ``x.to_var()`` and matches the JAX package's Pallas
kernel (interpret mode) at the reference's elementwise tolerance (rtol
1e-5 / atol 1e-5); LeNet-5 through the ``kernel`` impl matches the JAX
reference at the model tolerance (mean rtol 1e-3 / atol 1e-4, var rtol
1e-2 / atol 1e-5); the launch plans cover every element exactly once
(hypothesis, n up to 10^7, every pointer offset mod 4).

The tests marked ``gpu`` skip where there is no card: misaligned operands,
stress inputs, equal bits under two plans and the SRM-input pool bit for
bit the VAR one. JAX is imported only by the fixtures that need it, so the
``gpu`` tests also run where it is absent:
``python -m pytest -m gpu tests/test_torch_act_pool.py``.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import dispatch
from repro_torch.core.gaussian import SRM, VAR, GaussianTensor
from repro_torch.kernels import ops, ref
from repro_torch.kernels._launch import LAUNCHES
from repro_torch.kernels.pfp_activations import (SM_THREADS, SMS, WAVE,
                                                 ElementwisePlan,
                                                 activation_plan)
from repro_torch.kernels.pfp_maxpool import pool_plan

ELEMENTWISE_TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ("relu", "gelu", "silu", "tanh", "sigmoid")
POOL_SHAPES = [(2, 6, 10, 5), (1, 28, 28, 6), (3, 14, 4, 16)]


@pytest.fixture(scope="module")
def jops():
    pytest.importorskip("jax")
    from repro.kernels import ops as jax_ops
    return jax_ops


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


def _srm_input(shape, seed):
    """An SRM GaussianTensor as an activation emits it, with a window of
    point masses."""
    mu, var = (torch.from_numpy(a) for a in _pair(shape, seed))
    var[0, :2, :2] = 0.0
    return GaussianTensor(mu, var + torch.square(mu), SRM)


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_kernel_pool_of_srm_is_pool_of_to_var(jops, shape):
    x = _srm_input(shape, 23)
    got = dispatch.pfp_maxpool2d(x, impl="kernel")
    want = dispatch.pfp_maxpool2d(x.to_var(), impl="kernel")
    assert got.rep == VAR
    assert torch.equal(got.mean, want.mean)
    assert torch.equal(got.second, want.second)
    mu, var = x.mean.numpy(), x.to_var().second.numpy()
    jm, jv = jops.pfp_maxpool2d(mu, var, impl="kernel")
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(jm),
                               **ELEMENTWISE_TOL)
    np.testing.assert_allclose(got.second.numpy(), np.asarray(jv),
                               **ELEMENTWISE_TOL)


def test_kernel_pool_passes_the_rep_through(monkeypatch):
    """The kernel impl hands the SRM moment to the kernel, which converts
    it; nothing converts before."""
    seen = []
    real = ops.pfp_maxpool2d

    def spy(mu, second, *, rep="var"):
        seen.append(rep)
        return real(mu, second, rep=rep)

    monkeypatch.setattr(ops, "pfp_maxpool2d", spy)
    x = _srm_input((2, 6, 10, 5), 29)
    monkeypatch.setattr(GaussianTensor, "to_var", lambda self: pytest.fail(
        "the kernel impl converted before the kernel"))
    dispatch.pfp_maxpool2d(x, impl="kernel")
    assert seen == ["srm"]


def test_cpu_pool_with_srm_runs_the_plain_version():
    before = dict(LAUNCHES)
    x = _srm_input((3, 14, 4, 16), 31)
    got = ops.pfp_maxpool2d(x.mean, x.second, rep="srm")
    want = ref.pfp_maxpool2d_ref(x.mean, x.var)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="rep"):
        ops.pfp_maxpool2d(x.mean, x.second, rep="sd")


def test_lenet5_kernel_forward_matches_reference():
    """Batch 2, posterior sigma 0.05 (the pools see real variances)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.bayes.convert import svi_to_pfp as jax_svi_to_pfp
    from repro.core.modes import Mode as JMode
    from repro.models.simple import lenet5_forward, lenet5_init
    from repro.nn.module import Context as JContext
    from repro_torch.core.modes import Mode
    from repro_torch.models.simple import LeNet5
    from repro_torch.nn.module import Context, load_numpy_params
    pfp = jax.jit(lambda key: jax_svi_to_pfp(
        lenet5_init(key, sigma_init=5e-2), calibration_factor=0.4))(
            jax.random.PRNGKey(1))
    x = np.random.default_rng(2).random((2, 28, 28, 1), dtype=np.float32)
    ctx = JContext(mode=JMode.PFP, impl="xla")
    want = jax.jit(lambda p, x: lenet5_forward(p, x, ctx))(pfp,
                                                           jnp.asarray(x))
    model = load_numpy_params(LeNet5(device="cpu"),
                              jax.tree_util.tree_map(np.asarray, pfp))
    got = model(x, Context(mode=Mode.PFP, impl="kernel", device="cpu"))
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var),
                               rtol=1e-2, atol=1e-5)


def plan_elements(plan: ElementwisePlan, n: int):
    """How many times each of ``n`` elements is computed under ``plan``,
    as ``csrc/pfp_activations.cu``'s kernel walks them (an int64 numpy
    array of length ``n``): the float4 groups strided over the grid, then
    the ``n % 4`` elements past the last group, one each for the first
    threads; or, at ``vec`` 1, the elements strided over the grid."""
    threads = np.arange(plan.block * plan.grid, dtype=np.int64)
    stride = threads.size
    hits = np.zeros(n, dtype=np.int64)
    # Each pass's indices are distinct, so ``+=`` counts every one.
    if plan.vec == 4:
        groups = n // 4
        for start in range(0, groups, stride):
            g = threads[threads + start < groups] + start
            for j in range(4):
                hits[4 * g + j] += 1
        tail = 4 * groups + threads
        hits[tail[tail < n]] += 1
    else:
        for start in range(0, n, stride):
            hits[threads[threads + start < n] + start] += 1
    return hits


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 10 ** 7) | st.integers(1, 3 * WAVE),
       offsets=st.tuples(*[st.integers(0, 3)] * 4))
def test_activation_plan_covers_every_element_once(n, offsets):
    """Four pointers, each ``offset`` floats past a 16-byte boundary."""
    aligned = not any(offsets)
    plan = activation_plan(n, aligned)
    assert (plan_elements(plan, n) == 1).all()
    assert plan.vec == 1 or aligned
    assert 64 <= plan.block <= 256 and plan.block % 32 == 0
    # Never more than one wave: at most SM_THREADS threads on any SM.
    assert -(-plan.grid // SMS) * plan.block <= SM_THREADS
    if n <= WAVE:
        assert plan.vec == 1 and plan.grid * plan.block >= n


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 1024), hw=st.integers(1, 20),
       c=st.integers(1, 20), align=st.sampled_from((4, 8, 16)))
def test_pool_plan_covers_every_output_once(n, hw, c, align):
    h = w = 2 * hw
    plan = pool_plan(n, h, w, c, align)
    units = n * hw * hw * c // plan.vec
    assert c % plan.vec == 0 and 4 * plan.vec <= align
    assert units * plan.vec == n * hw * hw * c
    want = 4 if c % 4 == 0 and align == 16 else 2 if c % 2 == 0 and \
        align >= 8 else 1
    assert plan.vec == want
    threads = plan.grid * plan.block
    # The kernel strides unit u, u + threads, ...: one thread a unit under
    # a wave, exactly one wave above.
    assert threads >= units or (plan.block, plan.grid) == (256, WAVE // 256)
    assert -(-plan.grid // SMS) * plan.block <= SM_THREADS


def test_plans_at_the_main_path_shapes():
    """LeNet-5 and the MLP at batch 100: the small calls take one element
    a thread, the two conv activations groups of 4, under one wave;
    granite's silu one full wave that strides."""
    for n in (12000, 8400, 10000):
        assert activation_plan(n, True).vec == 1
    for n in (470400, 313600):
        plan = activation_plan(n, True)
        assert plan.vec == 4 and plan.grid * plan.block >= n // 4
    assert activation_plan(2048 * 14336, True) == ElementwisePlan(
        4, 256, WAVE // 256)
    assert activation_plan(2048 * 14336, False).vec == 1
    assert pool_plan(100, 28, 28, 6, 16).vec == 2
    assert pool_plan(100, 14, 14, 16, 16).vec == 4


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
def _stress(n_rep, device, gh):
    """(mu, var) holding the stress cases: var 0 and 1e-13 (point masses),
    |mu|/sd 0, 5 and 40, var 1e4, and for the Gauss-Hermite kinds mu +-90;
    each case repeated ``n_rep`` times."""
    cases = [(0.0, 0.0), (-1.5, 0.0), (2.0, 1e-13), (-2.0, 1e-13),
             (0.0, 1.0), (5.0, 1.0), (-5.0, 1.0), (40.0, 1.0), (-40.0, 1.0),
             (3.0, 1e4), (-300.0, 1e4), (0.5, 2e-12)]
    if gh:
        cases += [(90.0, 1.0), (-90.0, 1.0), (90.0, 0.0), (-90.0, 1e-13)]
    mu = torch.tensor([m for m, _ in cases] * n_rep, device=device)
    var = torch.tensor([v for _, v in cases] * n_rep, device=device)
    return mu, var


def _offset(a, k, device):
    """``a`` on the card as a view ``k`` floats into a larger buffer."""
    buf = torch.zeros(a.size + 4, device=device)
    view = buf[k:k + a.size].view(a.shape)
    view.copy_(torch.as_tensor(a, device=device))
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("kind", ["relu", "silu"])
def test_activation_misaligned_matches_plain_on_card(cuda, kind, k):
    for shape in ((100, 14, 14, 16), (3, 37, 70)):
        mu, var = (_offset(a, k, cuda) for a in _pair(shape, 41))
        assert mu.data_ptr() % 16
        got = ops.pfp_activation(mu, var, kind=kind)
        torch.cuda.synchronize()
        want = ref.pfp_activation_ref(mu, var, kind)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **ELEMENTWISE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("rep", ["var", "srm"])
def test_pool_misaligned_matches_plain_on_card(cuda, rep, k):
    for shape in ((100, 28, 28, 6), (100, 14, 14, 16)):
        mu_np, var_np = _pair(shape, 43)
        second_np = var_np + mu_np ** 2 if rep == "srm" else var_np
        mu, second = _offset(mu_np, k, cuda), _offset(second_np, k, cuda)
        got = ops.pfp_maxpool2d(mu, second, rep=rep)
        torch.cuda.synchronize()
        var = second - torch.square(mu) if rep == "srm" else second
        want = ref.pfp_maxpool2d_ref(mu, var)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **ELEMENTWISE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_activation_stress_inputs_on_card(cuda, kind):
    mu, var = _stress(1000, cuda, kind != "relu")
    before = LAUNCHES["activation"]
    got = ops.pfp_activation(mu, var, kind=kind)
    torch.cuda.synchronize()
    assert LAUNCHES["activation"] == before + 1
    want = ref.pfp_activation_ref(mu, var, kind)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **ELEMENTWISE_TOL)


@pytest.mark.gpu
def test_pool_stress_inputs_on_card(cuda):
    """Windows of the stress cases. Where a Clark max's variance is a small
    difference of two large moments (|mu| / sd 40), every fp32 version
    loses digits, so the kernel is held against fp64: no worse than 4x the
    fp32 plain version, as the dense kernel's cancellation test asks."""
    from repro_torch.core import pfp_math
    mu, var = _stress(600, cuda, False)             # 7200 = 75 x 4 x 4 x 6
    mu, var = mu.view(75, 4, 4, 6), var.view(75, 4, 4, 6)
    got = ops.pfp_maxpool2d(mu, var)
    torch.cuda.synchronize()
    plain = ref.pfp_maxpool2d_ref(mu, var)
    m, v = mu.double(), var.double()
    for pair in (lambda t: (t[:, :, 0::2], t[:, :, 1::2]),
                 lambda t: (t[:, 0::2], t[:, 1::2])):
        (ma, mb), (va, vb) = pair(m), pair(v)
        m, s = pfp_math.clark_max_moments(ma, va, mb, vb)
        v = torch.clamp(s - m * m, min=0.0)
    for g, p, exact in zip(got, plain, (m, v)):
        assert torch.isfinite(g).all()
        err_k = float((g.double() - exact).abs().max())
        err_p = float((p.double() - exact).abs().max())
        assert err_k <= 4 * max(err_p, 1e-9), (err_k, err_p)
    assert got[1].min() >= 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_activation_bits_do_not_depend_on_the_plan(cuda, kind):
    from repro_torch.kernels.pfp_activations import pfp_activation_cuda
    mu, var = (torch.from_numpy(a).to(cuda)
               for a in _pair((100, 14, 14, 16), 47))
    var[0] = 0.0
    n = mu.numel()
    outs = [pfp_activation_cuda(mu, var, kind=kind, plan=plan) for plan in (
        None, ElementwisePlan(1, 64, -(-n // 64)), ElementwisePlan(1, 256, 7),
        ElementwisePlan(4, 128, -(-n // 512)), ElementwisePlan(4, 256, 3))]
    for got in outs[1:]:
        assert all(torch.equal(g, w) for g, w in zip(got, outs[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("rep", ["var", "srm"])
def test_pool_bits_do_not_depend_on_the_plan(cuda, rep):
    from repro_torch.kernels.pfp_maxpool import pfp_maxpool2d_cuda
    x = _srm_input((100, 14, 14, 16), 53)
    mu = x.mean.to(cuda)
    second = (x.second if rep == "srm" else x.var).to(cuda)
    units = mu.numel() // 4
    outs = [pfp_maxpool2d_cuda(mu, second, rep=rep, plan=plan) for plan in (
        None, ElementwisePlan(1, 64, -(-units // 64)),
        ElementwisePlan(2, 256, 5), ElementwisePlan(4, 96, 11))]
    for got in outs[1:]:
        assert all(torch.equal(g, w) for g, w in zip(got, outs[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(100, 28, 28, 6), (100, 14, 14, 16),
                                   (3, 14, 4, 16), (2, 6, 10, 5)])
def test_srm_pool_is_bit_for_bit_the_var_pool_on_card(cuda, shape):
    x = _srm_input(shape, 59)
    x = GaussianTensor(x.mean.to(cuda), x.second.to(cuda), SRM)
    before = LAUNCHES["maxpool2d"]
    got = dispatch.pfp_maxpool2d(x, impl="kernel")
    assert LAUNCHES["maxpool2d"] == before + 1
    want = dispatch.pfp_maxpool2d(x.to_var(), impl="kernel")
    assert torch.equal(got.mean, want.mean)
    assert torch.equal(got.second, want.second)
    plain = ref.pfp_maxpool2d_ref(x.mean, x.var)
    torch.testing.assert_close(got.mean, plain[0], **ELEMENTWISE_TOL)
    torch.testing.assert_close(got.second, plain[1], **ELEMENTWISE_TOL)


@pytest.mark.gpu
def test_wrappers_refuse_a_bad_plan_on_card(cuda):
    from repro_torch.kernels.pfp_activations import pfp_activation_cuda
    from repro_torch.kernels.pfp_maxpool import pfp_maxpool2d_cuda
    mu = torch.zeros(4 * 6 * 6 * 6 + 1, device=cuda)[1:]
    with pytest.raises(RuntimeError, match="pfp_activation_launch"):
        pfp_activation_cuda(mu, mu, plan=ElementwisePlan(4, 128, 1))
    with pytest.raises(RuntimeError, match="pfp_activation_launch"):
        pfp_activation_cuda(mu, mu, plan=ElementwisePlan(1, 100, 1))
    x = mu.view(4, 6, 6, 6)
    with pytest.raises(RuntimeError, match="pfp_maxpool2d_launch"):
        pfp_maxpool2d_cuda(x, x, plan=ElementwisePlan(2, 64, 1))
    with pytest.raises(RuntimeError, match="pfp_maxpool2d_launch"):
        pfp_maxpool2d_cuda(x, x, plan=ElementwisePlan(4, 64, 1))
