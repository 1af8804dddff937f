"""The port's sharding rules against the reference's, with no process group.

For every config of ``ASSIGNED_ARCHS``, reduced (the port's real
parameters) and at full size (shapes only, built on the ``meta`` device),
on the meshes (4, 2), (2, 2), (16, 16) and (2, 16, 16), for training and
serving: the port's spec of every parameter leaf path, of every input of
every shape and of every leaf of the family's decode state equals the
reference's ``PartitionSpec``, computed on ``jax.sharding.AbstractMesh``
(no devices). The converted (mu, srm) leaves take the weights' specs.
Beside them: ``placements`` on a dimension over ("pod", "data") gives
every rank of the (2, 16, 16) mesh the block of a row-major
``PartitionSpec`` (DTensor's own offset arithmetic, every coordinate), and
the per-parameter placements ``params_shardings`` gives a module.
"""
import itertools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

from repro.configs import get_config as jget_config
from repro.launch import programs as jprograms
from repro.launch import sharding as jsharding
from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced_config
from repro_torch.configs.base import SHAPES
from repro_torch.core.mesh_route import row_offset
from repro_torch.launch import sharding
from repro_torch.launch.mesh import MeshSpec, dp_axes, production_spec
from repro_torch.launch.programs import input_batch
from repro_torch.models import lm
from repro_torch.nn.module import param_layout

MESHES = [((4, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _meshes(sizes, names):
    return MeshSpec(sizes, names), AbstractMesh(sizes, names)


def _leaves(layout, prefix=""):
    """(path, stacked shape) of every leaf of a ``param_layout`` tree."""
    for key, sub in layout.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(sub, dict):
            yield from _leaves(sub, path)
        else:
            yield path, sub


def _param_shapes(model):
    params = dict(model.named_parameters())
    for path, leaf in _leaves(param_layout(model)):
        shape = tuple(params[leaf.names[0]].shape)
        yield path, ((len(leaf.names),) + shape if leaf.stacked else shape)


def _models(arch):
    yield "reduced", lm.init_params(reduced_config(arch), device="cpu")
    yield "full", lm.init_params(get_config(arch), device="meta")


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_the_reference(arch):
    checked = 0
    for _, model in _models(arch):
        shapes = list(_param_shapes(model))
        for (sizes, names), serve in itertools.product(MESHES,
                                                       (False, True)):
            mesh, amesh = _meshes(sizes, names)
            for path, shape in shapes:
                got = sharding.param_pspec(path, shape, mesh, serve=serve)
                want = tuple(jsharding.param_pspec(path, shape, amesh,
                                                   serve=serve))
                assert got == want, (path, shape, sizes, serve)
                converted = path.replace("/rho", "/srm")
                assert sharding.param_pspec(converted, shape, mesh,
                                            serve=serve) == want
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_batch_and_state_specs_match_the_reference(arch):
    for cfg, jcfg in ((reduced_config(arch), None),
                      (get_config(arch), jget_config(arch))):
        jcfg = jcfg or _jreduced(arch)
        for shape in SHAPES.values():
            got_inputs = input_batch(cfg, shape, device="meta")
            want_inputs = jprograms.input_specs(jcfg, shape)
            assert set(got_inputs) == set(want_inputs)
            for sizes, names in MESHES:
                mesh, amesh = _meshes(sizes, names)
                for name, t in got_inputs.items():
                    assert tuple(t.shape) == want_inputs[name].shape
                    assert sharding.batch_pspec(name, t.shape, mesh) == \
                        tuple(jsharding.batch_pspec(name, t.shape, amesh))
        batch, max_len = 128, 4096
        states = lm.init_decode_state(cfg, batch, max_len, device="meta")
        got = {}
        sharding.map_with_path(
            lambda path, leaf: got.setdefault(path, tuple(leaf.shape)),
            states)
        want = {jsharding._path_str(p): leaf.shape for p, leaf in
                jax.tree_util.tree_flatten_with_path(
                    jprograms.decode_state_specs(jcfg, batch, max_len))[0]}
        assert got == want
        for sizes, names in MESHES:
            mesh, amesh = _meshes(sizes, names)
            for path, shape in got.items():
                assert sharding.state_pspec(path, shape, mesh) == tuple(
                    jsharding.state_pspec(path, shape, amesh)), (path, sizes)


def _jreduced(arch):
    from repro.configs import reduced_config as jreduced_config

    return jreduced_config(arch)


def test_multi_axis_dim_gives_each_rank_its_row_major_block():
    """Batch 64 over ("pod", "data") of (2, 16, 16): rank (p, d, m) holds
    rows [(16 p + d) * 2, +2), whatever m."""
    spec = production_spec(True)
    ps = sharding.placements((("pod", "data"), None), spec)
    assert ps == [Shard(0), Shard(0), Replicate()]
    for coord in itertools.product(*(range(n) for n in spec.sizes)):
        shape, offset = _compute_local_shape_and_global_offset(
            (64, 8), spec.sizes, list(coord), ps)
        p, d, _ = coord
        assert shape == (2, 8) and offset == ((16 * p + d) * 2, 0), coord


class _Coords:
    """The size and local rank queries of a mesh at one coordinate."""

    def __init__(self, sizes, coord):
        self.sizes, self.coord = sizes, coord

    def size(self, i):
        return self.sizes[i]

    def get_local_rank(self, i):
        return self.coord[i]


def test_vocab_row_offset_follows_dtensors_blocks():
    sizes = (2, 16, 16)
    ps = [Shard(0), Replicate(), Shard(0)]
    for coord in itertools.product(*(range(n) for n in sizes)):
        _, offset = _compute_local_shape_and_global_offset(
            (49152, 16), sizes, list(coord), ps)
        assert row_offset(49152, _Coords(sizes, coord), ps) == offset[0]


def test_placements_refuse_reused_or_unordered_axes():
    mesh = MeshSpec((2, 4), ("data", "model"))
    assert sharding.placements((), mesh) == [Replicate(), Replicate()]
    assert sharding.placements((None, "model"), mesh) == [Replicate(),
                                                          Shard(1)]
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(("data", "data"), mesh)
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements((("model", "data"),), mesh)


def test_params_shardings_drop_the_stacked_axis():
    cfg = reduced_config("granite-8b")
    model = lm.init_params(cfg, device="cpu")
    mesh = MeshSpec((4, 2), ("data", "model"))
    got = sharding.params_shardings(model, mesh)
    assert set(got) == {n for n, _ in model.named_parameters()}
    # wq (64, 64): FSDP rows over 'data', heads over 'model'.
    assert got["stack.0.b0.attn.wq.w.mu"] == [Shard(0), Shard(1)]
    # wo: rows over 'model' (row-parallel), columns over 'data'.
    assert got["stack.1.b0.attn.wo.w.rho"] == [Shard(1), Shard(0)]
    # embed (97, 64): 97 divides no axis, so it stays whole.
    assert got["embed.table.mu"] == [Replicate(), Replicate()]
    assert got["ln_f.g"] == [Replicate(), Replicate()]
    serve = sharding.params_shardings(model, mesh, serve=True)
    assert serve["stack.0.b0.attn.wq.w.mu"] == [Replicate(), Shard(1)]
    assert dp_axes(MeshSpec((2, 2, 2), ("pod", "data", "model"))) == \
        ("pod", "data")


def test_torch_tensor_shapes_are_not_needed_for_specs():
    mesh = MeshSpec((16, 16), ("data", "model"))
    assert sharding.batch_pspec("tokens", torch.Size([256, 4096]), mesh) == \
        ("data", None)
    assert sharding.state_pspec("stack/b0/k_mu", (36, 128, 8, 32768, 128),
                                mesh) == (None, "data", None, "model", None)
