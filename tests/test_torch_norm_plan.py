"""The norm kernels' launch plan (``kernels/pfp_norms.py`` ``norm_plan``)
and the bit rules of ``csrc/pfp_norm.cuh``.

On the CPU: the plan is a function of the row width alone, its blocks are
whole warps of at most 1024 threads, it covers every entry of the row
once at every width the configs use and at ragged ones, and every plan it
gives is one that ``csrc/pfp_norms.cu`` and ``csrc/pfp_fused.cu``
instantiate (``PFP_NORM_GROUPS``, read from ``csrc/pfp_norm.cuh``). At
the plans' edges the port's norms (their plain versions here) are held
against the JAX package's Pallas kernels in interpret mode at the
reference's tolerance (rtol 1e-4 / atol 1e-5).

The tests marked ``gpu`` skip where there is no card. They hold each norm
kernel against its plain version at those widths (``rep`` var / srm,
``act`` None / silu / gelu), with operands 4 bytes off 16-byte alignment,
a row's bits equal at M = 1, 4, 33 and 2048 and aligned or not, and the
fused unit's norm pass equal to the norm kernel plus torch's ``to_srm``
(through the whole fused unit against its unfused chain) bit for bit. JAX
is imported only by the tests that need it, so
``python -m pytest -m gpu tests/test_torch_norm_plan.py`` runs where it
is absent.
"""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels._launch import LAUNCHES
from repro_torch.kernels.pfp_norms import (GROUPS, PLAN_THREADS, NormPlan,
                                           norm_plan, pfp_norm_cuda,
                                           plan_ok)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
NORM_TOL = dict(rtol=1e-4, atol=1e-5)
CONFIG_WIDTHS = (1536, 2048, 2560, 3072, 4096, 5120, 6144, 8192)
WIDTHS = (1, 3, 100, 333) + CONFIG_WIDTHS + (4097,)
NORMS = ("rmsnorm", "layernorm")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pair(shape, seed, offset=0.0):
    rng = np.random.default_rng(seed)
    mu = (rng.normal(size=shape) + offset).astype(np.float32)
    var = np.log1p(np.exp(rng.normal(size=shape))).astype(np.float32)
    return mu, var


def _vectors(d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(1.0, 0.1, size=d).astype(np.float32),
            rng.normal(0.0, 0.1, size=d).astype(np.float32))


def _entries(plan, d):
    """The row entries each (thread, group, lane) of ``plan`` holds, as the
    kernel's load_slice maps them: 4 (g T + t) + l, those under d."""
    threads, groups = plan
    t, g, lane = np.meshgrid(np.arange(threads), np.arange(groups),
                             np.arange(4), indexing="ij")
    j = 4 * (g * threads + t) + lane
    return j[j < d]


def _norm(name, mu, second, gain, bias, **kw):
    if name == "rmsnorm":
        return ops.pfp_rmsnorm(mu, second, gain, **kw)
    return ops.pfp_layernorm(mu, second, gain, bias, **kw)


def _plain(name, mu, second, gain, bias, **kw):
    if name == "rmsnorm":
        return ref.pfp_rmsnorm_ref(mu, second, gain, **kw)
    return ref.pfp_layernorm_ref(mu, second, gain, bias, **kw)


def _offset(array, device, k=1):
    """``array`` on ``device`` in a buffer ``k`` floats past its start: a
    contiguous view that is not 16-byte aligned."""
    flat = torch.from_numpy(np.ascontiguousarray(array)).reshape(-1)
    buf = torch.empty(flat.numel() + 4, device=device)
    view = buf[k:k + flat.numel()]
    view.copy_(flat.to(device))
    assert view.data_ptr() % 16 != 0
    return view.view(array.shape)


# ---------------------------------------------------------------------------
# The plan, on the CPU
# ---------------------------------------------------------------------------
def test_norm_plan_is_a_function_of_the_width_alone():
    """norm_plan takes d and nothing else (not the rows, not the
    alignment), and gives the same plan every call."""
    assert list(inspect.signature(norm_plan).parameters) == ["d"]
    wrapper = inspect.signature(pfp_norm_cuda).parameters
    assert "rows" not in wrapper and "aligned" not in wrapper
    for d in WIDTHS:
        assert norm_plan(d) == norm_plan(d)
        assert isinstance(norm_plan(d), NormPlan)


@pytest.mark.parametrize("d", WIDTHS)
def test_norm_plan_is_whole_warps_and_covers_the_row_once(d):
    plan = norm_plan(d)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.threads <= PLAN_THREADS[plan.groups] <= GROUPS[plan.groups]
    assert plan_ok(plan, d)
    held = _entries(plan, d)
    assert len(held) == d and np.array_equal(np.sort(held), np.arange(d))
    # The fewest threads for its groups: no warp without an entry.
    assert _entries(NormPlan(plan.threads - 32, plan.groups), d).size < d \
        or plan.threads == 32


def test_norm_plan_at_the_config_widths():
    """A thread holds one or two float4 groups at every width the configs
    use: one up to 2048 (512 threads), two above (tools/norm_plan_sweep.py
    measured these against the other plans)."""
    want = {1536: (384, 1), 2048: (512, 1), 2560: (320, 2), 3072: (384, 2),
            4096: (512, 2), 5120: (640, 2), 6144: (768, 2), 8192: (1024, 2)}
    assert {d: tuple(norm_plan(d)) for d in CONFIG_WIDTHS} == want
    assert tuple(norm_plan(4097)) == (544, 2)
    assert tuple(norm_plan(1)) == tuple(norm_plan(100)) == (32, 1)
    assert tuple(norm_plan(333)) == (96, 1)


def _norm_groups():
    text = (CSRC / "pfp_norm.cuh").read_text()
    body = re.search(r"#define PFP_NORM_GROUPS\(X\)(.*?)\n\n", text,
                     re.S).group(1)
    return {int(g): int(t) for g, t in re.findall(r"X\((\d+), (\d+)\)",
                                                   body)}


def test_every_plan_is_one_the_sources_instantiate():
    """GROUPS is csrc/pfp_norm.cuh's PFP_NORM_GROUPS, which both the norm
    kernel and the fused unit's norm pass are instantiated on, and every
    width up to the widest plan gets a plan the C side takes."""
    assert _norm_groups() == GROUPS
    for source in ("pfp_norms.cu", "pfp_fused.cu"):
        assert "PFP_NORM_GROUPS(PFP_NORM_CASE)" in (CSRC / source).read_text()
    for d in range(1, 8193):
        plan = norm_plan(d)
        assert plan.groups in GROUPS and plan_ok(plan, d)


@pytest.mark.parametrize("d", [0, 8193, 16384])
def test_a_width_no_plan_takes_raises(d):
    with pytest.raises(ValueError, match="norm plan"):
        norm_plan(d)


def test_bad_plans_are_refused():
    assert not plan_ok(NormPlan(96, 3), 100)      # no such groups
    assert not plan_ok(NormPlan(100, 1), 100)     # not whole warps
    assert not plan_ok(NormPlan(32, 1), 129)      # does not cover the row
    assert not plan_ok(NormPlan(1056, 1), 4097)   # more than 1024 threads
    assert not plan_ok(NormPlan(256, 4), 4096)    # no such groups
    assert plan_ok(NormPlan(1024, 1), 4096)


@pytest.mark.parametrize("norm", NORMS)
def test_cpu_runs_the_plain_version_at_any_width(norm):
    """On the CPU the wrapper runs the plain version, which needs no plan:
    a row wider than every plan is normalised there and launches
    nothing."""
    mu, var = _pair((2, 8200), 3)
    gain, bias = _vectors(8200, 4)
    args = [torch.from_numpy(a) for a in (mu, var, gain, bias)]
    before = dict(LAUNCHES)
    got = _norm(norm, *args, act="silu")
    want = _plain(norm, *args, act="silu")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert LAUNCHES == before


@pytest.fixture(scope="module")
def jops():
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    return jops


@pytest.mark.parametrize("d", [333, 4097])
@pytest.mark.parametrize("rep", ["var", "srm"])
@pytest.mark.parametrize("norm", NORMS)
def test_port_matches_pallas_kernel_at_the_plan_edges(jops, norm, rep, d):
    """At a width off every float4 group (333) and one past granite's 4096
    (4097: a last group of one entry), the port's norm against the
    reference's Pallas kernel in interpret mode, with the gelu epilogue."""
    mu, var = _pair((3, d), d)
    second = var if rep == "var" else var + mu * mu
    gain, bias = _vectors(d, d + 1)
    args = [torch.from_numpy(a) for a in (mu, second, gain, bias)]
    if norm == "rmsnorm":
        got = ops.pfp_rmsnorm(*args[:3], rep=rep, act="gelu")
        want = jops.pfp_rmsnorm(mu, second, gain, rep=rep, act="gelu",
                                impl="kernel")
    else:
        got = ops.pfp_layernorm(*args, rep=rep, act="gelu")
        want = jops.pfp_layernorm(mu, second, gain, bias, rep=rep,
                                  act="gelu", impl="kernel")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **NORM_TOL)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "silu", "gelu"])
@pytest.mark.parametrize("rep", ["var", "srm"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("d", WIDTHS)
def test_norm_kernel_matches_plain_at_every_width(cuda, d, norm, rep, act):
    mu, var = _pair((5, d), d)
    second = var if rep == "var" else var + mu * mu
    gain, bias = _vectors(d, d + 7)
    args = [torch.from_numpy(a).to(cuda) for a in (mu, second, gain, bias)]
    before = LAUNCHES[norm]
    got = _norm(norm, *args, rep=rep, act=act)
    torch.cuda.synchronize()
    assert LAUNCHES[norm] == before + 1
    want = _plain(norm, *[a.cpu() for a in args], rep=rep, act=act)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.cpu(), w, **NORM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("rep", ["var", "srm"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("d", [333, 1536, 4096, 4097])
def test_unaligned_operands_give_the_aligned_bits(cuda, d, norm, rep, act):
    """Operands 4 bytes off 16-byte alignment take the scalar loads, into
    the same registers: the plain version's values within NORM_TOL and
    the aligned call's bits."""
    mu, var = _pair((7, d), d + 3)
    second = var if rep == "var" else var + mu * mu
    gain, bias = _vectors(d, d + 11)
    aligned = [torch.from_numpy(a).to(cuda) for a in (mu, second, gain, bias)]
    odd = [_offset(a, cuda) for a in (mu, second, gain, bias)]
    got = _norm(norm, *odd, rep=rep, act=act)
    want = _norm(norm, *aligned, rep=rep, act=act)
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    plain = _plain(norm, *[a.cpu() for a in aligned], rep=rep, act=act)
    for g, w in zip(got, plain):
        torch.testing.assert_close(g.cpu(), w, **NORM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("rep", ["var", "srm"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("d", [333, 1536, 2048, 4096, 4097, 5120])
def test_row_bits_do_not_depend_on_the_rows(cuda, d, norm, rep):
    """The first row's outputs bit for bit at M = 1, 4, 33 and 2048, and
    at M 33 with unaligned operands."""
    mu, var = _pair((2048, d), d + 5)
    second = var if rep == "var" else var + mu * mu
    gain, bias = _vectors(d, d + 13)
    args = [torch.from_numpy(a).to(cuda) for a in (mu, second, gain, bias)]
    first = None
    for m in (1, 4, 33, 2048):
        got = [t[:1] for t in _norm(norm, args[0][:m], args[1][:m],
                                    *args[2:], rep=rep)]
        if first is None:
            first = got
        assert all(torch.equal(g, f) for g, f in zip(got, first)), m
    odd = [_offset(a[:33].cpu().numpy(), cuda) for a in args[:2]]
    got = [t[:1] for t in _norm(norm, *odd, *args[2:], rep=rep)]
    assert all(torch.equal(g, f) for g, f in zip(got, first))


@pytest.mark.gpu
@pytest.mark.parametrize("rep", ["var", "srm"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("m,k", [(33, 1536), (4, 2048), (9, 333),
                                 (250, 4096), (4, 5120), (250, 5120)])
def test_fused_norm_pass_is_the_norm_kernel_and_to_srm(cuda, m, k, norm,
                                                       rep):
    """The fused unit, whose norm pass runs the norm kernel's plan and
    norm_row, against the unfused kernel chain (norm kernel, to_srm, dense,
    activation), bit for bit at every width's plan; at K 5120 both split
    K in 4 (the fused unit over a cluster, the chain's large regime in
    one block in turn)."""
    from repro_torch.tuning.measure import unfused_chain
    mu, var = _pair((m, k), k + m)
    second = var if rep == "var" else var + mu * mu
    gain, bias = _vectors(k, k + 17)
    rng = np.random.default_rng(k)
    mu_w = (0.05 * rng.normal(size=(k, 300))).astype(np.float32)
    srm_w = (mu_w ** 2 + 1e-4).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda)
            for a in (mu, second, gain, bias, mu_w, srm_w)]
    if norm == "rmsnorm":
        args[3] = None
    before = LAUNCHES["norm_dense_act"]
    got = ops.pfp_norm_dense_act(*args, norm=norm, rep=rep, act="silu")
    want = unfused_chain(*args, norm=norm, rep=rep, act="silu")
    torch.cuda.synchronize()
    assert LAUNCHES["norm_dense_act"] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.gpu
def test_card_refuses_what_no_plan_takes(cuda):
    """A CUDA row wider than every plan raises, with no quiet plain path;
    a forced plan the kernel does not take raises in the wrapper, and the
    C side refuses one the wrapper would let through."""
    from repro_torch.kernels import _build
    x = torch.ones((2, 8193), device=cuda)
    with pytest.raises(ValueError, match="norm plan"):
        ops.pfp_rmsnorm(x, x, torch.ones(8193, device=cuda))
    x = torch.ones((2, 4096), device=cuda)
    gain = torch.ones(4096, device=cuda)
    with pytest.raises(ValueError, match="norm plan"):
        pfp_norm_cuda(x, x, gain, plan=NormPlan(256, 2))
    lib = _build.load()
    out = torch.empty_like(x)
    status = lib.pfp_norm_launch(
        0, 0, -1, 512, 3, x.data_ptr(), x.data_ptr(), gain.data_ptr(),
        gain.data_ptr(), out.data_ptr(), out.data_ptr(), 2, 4096, 1e-6,
        torch.cuda.current_stream(cuda).cuda_stream)
    assert status != 0
