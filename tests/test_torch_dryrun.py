"""The dry-run on PyTorch's ``fake`` process group, with no device.

One fixture makes a ``fake`` group of 512 ranks (asserting there was none)
and destroys it in ``finally``; the pod (16, 16) and multipod (2, 16, 16)
meshes sit on it, and programs run under ``FakeTensorMode``, so nothing
is allocated. With the reduced granite-8b:

* ``build_program``'s meta for the train, prefill and decode programs;
* per-device argument bytes are the local shards' sizes, computed here
  from the rules' placements with DTensor's own offset arithmetic;
* a row-parallel dense under the kernel impl records two all-reduces
  (mean and variance) over the 16 ranks of 'model', with the reference's
  operand and ring-link bytes;
* the matmul FLOPs ``CostMode`` counts for a forward equal their
  analytic count (3 products a Eq. 12 dense, 3 an attention), and its
  peak of live storages leaves out views and the arguments;
* ``roofline_terms`` on the H100 constants;
* ``run_cell`` writes a JSON with the reference's keys (``fits_80gb_hbm``
  for ``fits_16gb_hbm``) under ``tmp_path``, and ``report.py`` renders
  both tables and the hill-climb pick from it.
"""
import json
import math

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

from repro_torch.bayes.convert import svi_to_pfp
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import dispatch
from repro_torch.core.gaussian import SRM, GaussianTensor
from repro_torch.launch import report, roofline
from repro_torch.launch import sharding as shlib
from repro_torch.launch.costs import CostMode
from repro_torch.launch.dryrun import _local_bytes, run_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.programs import build_program
from repro_torch.models import lm
from repro_torch.nn import pjit_hints
from repro_torch.nn.module import Context

ARCH = "granite-8b"


@pytest.fixture(scope="module")
def world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield
    finally:
        pjit_hints.set_rules(None)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def pod(world):
    return make_production_mesh(device_type="cpu")


SHAPES = {"train": ShapeConfig("train_small", 16, 32, "train"),
          "prefill": ShapeConfig("prefill_small", 16, 32, "prefill"),
          "decode": ShapeConfig("decode_small", 16, 32, "decode")}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_program_meta(pod, kind):
    cfg = reduced_config(ARCH)
    try:
        with FakeTensorMode():
            prog = build_program(ARCH, SHAPES[kind], pod, cfg=cfg)
    finally:
        pjit_hints.set_rules(None)
    meta = prog.meta
    assert meta["arch"] == ARCH and meta["kind"] == kind
    assert meta["params"] == cfg.param_count()
    assert meta["active_params"] == cfg.active_param_count()
    assert meta["formulation"] == "srm" and meta["impl"] == "kernel"
    assert meta["serve_params"] == "tp"
    assert prog.name.startswith(f"{cfg.name}:{SHAPES[kind].name}:")
    if kind == "train":
        assert meta["num_microbatches"] == 1


def _local_numel(shape, placements, sizes):
    local, _ = _compute_local_shape_and_global_offset(
        shape, sizes, [0] * len(sizes), placements)
    return math.prod(local)


def test_argument_bytes_are_the_local_shards(pod):
    cfg = reduced_config(ARCH)
    sizes = (16, 16)
    try:
        with FakeTensorMode():
            prog = build_program(ARCH, SHAPES["train"], pod, cfg=cfg)
            got = _local_bytes(prog.args)
            model = lm.init_params(cfg, device="meta")
    finally:
        pjit_hints.set_rules(None)
    want = 0
    for name, ps in shlib.params_shardings(model, pod).items():
        shape = tuple(model.get_parameter(name).shape)
        want += 3 * 4 * _local_numel(shape, ps, sizes)   # param, m, v
    for name in ("tokens", "targets"):
        shape = (32, 16)
        ps = shlib.placements(shlib.batch_pspec(name, shape, pod), pod)
        want += 8 * _local_numel(shape, ps, sizes)
    assert got == want


def test_row_parallel_dense_records_two_all_reduces(pod):
    """wo-like: x (B, T, K) split over K on 'model', w (K, N) split over K
    on 'model': each rank holds partial mean and variance sums; the route
    all-reduces both over the 16 ranks of 'model'."""
    b, t, k, n = 32, 8, 256, 64
    with FakeTensorMode():
        x = GaussianTensor(torch.empty(b, t, k), torch.empty(b, t, k), SRM)
        w = GaussianTensor(torch.empty(k, n), torch.empty(k, n), SRM)
        xs = [Shard(0), Shard(2)]
        ws = [Replicate(), Shard(0)]
        dx = GaussianTensor(*(shlib.distribute(a, pod, xs)
                              for a in (x.mean, x.second)), SRM)
        dw = GaussianTensor(*(shlib.distribute(a, pod, ws)
                              for a in (w.mean, w.second)), SRM)
        cost = CostMode()
        with cost:
            out = dispatch.pfp_dense(dx, dw, impl="kernel")
    assert list(out.mean.placements) == [Shard(0), Replicate()]
    ar = cost.collectives["all-reduce"]
    out_bytes = (b // 16) * t * n * 4       # one local output half
    assert ar["count"] == 2
    assert ar["operand"] == 2 * out_bytes
    assert ar["link"] == pytest.approx(2 * 2 * 15 / 16 * out_bytes)
    assert cost.collectives["all-gather"]["count"] == 0
    assert cost.collective_s == pytest.approx(ar["link"] / roofline.NODE_BW)


def test_matmul_flops_of_a_forward_equal_their_count():
    cfg = reduced_config(ARCH)
    b, t = 2, 8
    model = svi_to_pfp(lm.init_params(cfg, device="cpu"))
    cost = CostMode()
    with cost:
        lm.forward(model, cfg, {"tokens": torch.zeros(b, t,
                                                      dtype=torch.long)},
                   Context(mode="pfp", impl="kernel", device="cpu"))
    m, d, hd = b * t, cfg.d_model, cfg.head_dim
    h, hkv, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    per_layer = [(d, h * hd), (d, hkv * hd), (d, hkv * hd), (h * hd, d),
                 (d, ff), (d, ff), (ff, d)]
    dense = sum(3 * 2 * m * k * n for k, n in per_layer) * cfg.num_layers
    dense += 3 * 2 * m * d * cfg.vocab_size                   # lm_head
    attention = 3 * 2 * b * h * t * t * hd * cfg.num_layers
    assert cost.matmul_flops == dense + attention


def test_cost_mode_tracks_the_peak_of_live_storages():
    """Bytes of the storages the run makes, from their op until they are
    freed; views and the arguments' storages are not counted."""
    a = torch.ones(1000)                   # an argument: 4000 B, not counted
    cost = CostMode()
    with cost:
        b = a * 2                          # +4000
        c = b + 1                          # +4000: peak 8000
        v = c[:10]                         # a view: nothing
        del b                              # -4000
        d = c * 3                          # +4000: 8000 again
        del c, v, d
    assert cost.peak == 8000
    assert cost.live == 0
    assert cost.summary()["peak_bytes"] == 8000.0


def test_roofline_terms_on_the_h100_rates():
    terms = roofline.roofline_terms(67e12, 3.35e12 * 2, 0.0,
                                    collective_s=0.5)
    assert terms["compute_s"] == pytest.approx(1.0)
    assert terms["memory_s"] == pytest.approx(2.0)
    assert terms["collective_s"] == 0.5
    assert terms["bottleneck"] == "memory"
    assert terms["step_time_lower_bound_s"] == pytest.approx(2.0)
    assert terms["roofline_fraction"] == pytest.approx(0.5)
    assert roofline.link_rate(range(8)) == roofline.NVLINK_BW
    assert roofline.link_rate(range(0, 256, 16)) == roofline.NODE_BW
    assert roofline.model_flops({"active_params": 10}, "train", 4, 2) == 480


def test_run_cell_writes_the_references_keys_and_report_renders(world,
                                                                tmp_path):
    cfg = reduced_config(ARCH)
    out = str(tmp_path)
    cells = [run_cell(ARCH, "decode_32k", multi_pod=mp, cfg=cfg,
                      out_dir=out, probe=mp) for mp in (False, True)]
    cells.append(run_cell(ARCH, "long_500k", multi_pod=False, cfg=cfg,
                          out_dir=out))
    assert [c["status"] for c in cells] == ["ok", "ok", "skipped"]
    with open(tmp_path / f"{ARCH}__decode_32k__pod.json") as f:
        saved = json.load(f)
    for key in ("arch", "shape", "mesh", "status", "chips", "program",
                "impl", "schedules", "lower_s", "compile_s",
                "flops_per_device", "bytes_per_device", "collective_bytes",
                "collective_bytes_operand", "collective_bytes_link",
                "collective_bytes_total", "memory_analysis",
                "model_flops_total", "model_flops_per_device",
                "useful_flops_ratio", "compute_s", "memory_s",
                "collective_s", "bottleneck", "step_time_lower_bound_s",
                "roofline_fraction", "hbm_bytes_per_device",
                "fits_80gb_hbm"):
        assert key in saved, key
    assert "fits_16gb_hbm" not in saved
    assert saved["chips"] == 256 and cells[1]["chips"] == 512
    assert saved["impl"] == "eager"
    assert saved["memory_analysis"]["argument_size_in_bytes"] > 0
    assert "serving" not in saved and cells[1]["serving"]["status"] == "ok"
    table = report.roofline_table("pod", results_dir=out)
    assert f"| {ARCH} | decode_32k |" in table
    assert f"| {ARCH} | long_500k | skipped" in table
    assert f"| {ARCH} | decode_32k | decode[pfp] |" in report.dryrun_table(
        "multipod", results_dir=out)
    worst, coll = report.pick_hillclimb_cells("pod", results_dir=out)
    assert worst["shape"] == coll["shape"] == "decode_32k"
