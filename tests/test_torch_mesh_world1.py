"""The mesh modules on a world-1 gloo group, on the CPU.

A (1, 1) mesh over one rank runs every mesh code path with DTensors: the
sharding rules' placements, the kernel impl's DTensor route, DTensor
propagation under the eager impl, the sampled noise's local blocks, the
DTensor checkpoint and the train CLI's mesh flags. On one rank each must
give the unmeshed result:

* the PFP forward of a reduced granite-8b on DTensors equals the unmeshed
  one bit for bit, under both impls;
* one SVI step (parameters, Adam's moments, loss) equals the
  single-device step bit for bit;
* a DTensor train state saved and restored elastically
  (``restore(shardings=)``) comes back as DTensors with the same bits;
* ``compressed_psum`` at world 1 is ``dequantize(quantize(x))``;
* ``main([... "--devices", "1", "--mesh", "1,1" ...])`` runs in-process
  and its step-10 checkpoint equals the unmeshed run's, file for file.

The file's one fixture makes the group (asserting there was none before)
and destroys it in ``finally``; no test starts a process or a thread.
Multi-rank meshes run in ``chip_smoke.py`` (8 gloo processes).
"""
import copy
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.bayes.convert import svi_to_pfp
from repro_torch.configs import reduced_config
from repro_torch.launch import sharding as shlib
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.nn.module import Context
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.compression import (compressed_psum,
                                              dequantize_int8,
                                              quantize_int8)
from repro_torch.training.optimizer import Adam, AdamState
from repro_torch.training.train_loop import (init_train_state,
                                             load_train_state_tree,
                                             make_svi_train_step,
                                             train_state_layout,
                                             train_state_tree, TrainState)

ARCH = "granite-8b"


@pytest.fixture(scope="module")
def mesh():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _model(seed=0):
    return lm.init_params(reduced_config(ARCH),
                          generator=torch.Generator().manual_seed(seed),
                          device="cpu")


def _batch(b=2, t=8):
    g = torch.Generator().manual_seed(5)
    return {"tokens": torch.randint(0, 97, (b, t), generator=g),
            "targets": torch.randint(0, 97, (b, t), generator=g)}


def _placed(tree, mesh):
    return shlib.distribute_tree(tree, shlib.batch_shardings(tree, mesh),
                                 mesh)


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_forward_on_dtensors_equals_unmeshed_bit_for_bit(mesh, impl):
    cfg = reduced_config(ARCH)
    plain = svi_to_pfp(_model())
    sharded = shlib.distribute_params(copy.deepcopy(plain), mesh, serve=True)
    assert all(isinstance(p, DTensor) for p in sharded.parameters())
    tokens = {"tokens": _batch()["tokens"]}
    ctx = Context(mode="pfp", impl=impl, device="cpu")
    want, _, _ = lm.forward(plain, cfg, tokens, ctx)
    with implicit_replication():
        got, _, _ = lm.forward(sharded, cfg, _placed(tokens, mesh), ctx)
    assert isinstance(got.mean, DTensor)
    assert torch.equal(got.mean.full_tensor(), want.mean)
    assert torch.equal(got.var.full_tensor(), want.var)


def _state_tensors(state):
    out = {f"p/{n}": p.detach() for n, p in state.model.named_parameters()}
    for part in ("m", "v"):
        out.update({f"{part}/{n}": t for n, t in
                    getattr(state.opt_state, part).items()})
    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in out.items()}


def test_svi_step_on_the_mesh_equals_the_single_device_step(mesh):
    cfg = reduced_config(ARCH)
    opt = Adam(learning_rate=1e-3, clip_norm=1.0)

    def fwd(model, batch, ctx):
        logits, aux, _ = lm.forward(model, cfg, batch, ctx)
        return logits, aux

    step = make_svi_train_step(fwd, opt, num_data=1000)
    batch = _batch()
    single, m1 = step(init_train_state(_model(), opt), batch,
                      torch.Generator().manual_seed(3))
    model = shlib.distribute_params(_model(), mesh)
    with implicit_replication():
        sharded, m2 = step(init_train_state(model, opt),
                           _placed(batch, mesh),
                           torch.Generator().manual_seed(3))
    for k in ("loss", "nll", "kl", "grad_norm"):
        assert torch.equal(m2[k].full_tensor(), m1[k]), k
    want, got = _state_tensors(single), _state_tensors(sharded)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_dtensor_checkpoint_round_trips_elastically(mesh, tmp_path):
    opt = Adam(learning_rate=1e-3)
    model = shlib.distribute_params(_model(), mesh)
    state = init_train_state(model, opt)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, train_state_tree(state), blocking=True)
    layout = train_state_layout(model)
    ls = shlib.layout_shardings(layout["params"], model, mesh)
    tree, step = mgr.restore(layout, shardings={
        "params": ls, "opt_state": AdamState(None, ls, ls), "step": None})
    assert step == 3
    assert isinstance(tree["params"]["lm_head"]["w"]["mu"], DTensor)
    fresh = shlib.distribute_params(_model(seed=9), mesh)
    restored = load_train_state_tree(TrainState(fresh, None, 0), tree)
    want, got = _state_tensors(state), _state_tensors(restored)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert all(isinstance(p, DTensor) for p in restored.model.parameters())


def test_compressed_psum_at_world_one_is_the_quantized_tensor(mesh):
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8, 100)).astype(np.float32))
    q, s = quantize_int8(x)
    assert torch.equal(compressed_psum(x, mesh, "data"),
                       dequantize_int8(q, s, x.shape))


def _step_files(directory, step):
    d = directory / f"step_{step:09d}"
    return (json.loads((d / "MANIFEST.json").read_text()),
            {p.name: np.load(p) for p in sorted(d.glob("*.npy"))})


def test_cli_on_a_one_rank_mesh_checkpoints_the_unmeshed_bits(mesh,
                                                              tmp_path,
                                                              capsys):
    argv = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "16",
            "--steps", "10"]
    plain, meshed = tmp_path / "plain", tmp_path / "mesh"
    assert train.main(argv + ["--ckpt-dir", str(plain)]) == 0
    assert train.main(argv + ["--devices", "1", "--mesh", "1,1",
                              "--ckpt-dir", str(meshed)]) == 0
    out = capsys.readouterr().out
    assert "mesh={'data': 1, 'model': 1}" in out
    assert dist.is_initialized()      # the fixture's group, still there
    (want_manifest, want), (got_manifest, got) = (
        _step_files(d, 10) for d in (plain, meshed))
    assert got_manifest == want_manifest
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
