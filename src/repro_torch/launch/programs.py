"""Program builders for the dry-run.

Counterpart of ``repro/launch/programs.py``: every (arch x input-shape)
cell maps to a program and its arguments, placed on a mesh by the
sharding rules:

  train_4k     -> the SVI ELBO train step (the paper's training mode, one
                  sample, Adam) on fp32 variational parameters
  prefill_32k  -> the PFP prefill (one analytic pass that fills the decode
                  state) on the converted (mu, srm) parameters
  decode_32k / long_500k -> the PFP serve step (one new token against a
                  seq_len-sized decode state)

The reference traces abstract ``ShapeDtypeStruct`` arguments. The port is
eager, so its arguments are real tensors: build the program under
``FakeTensorMode`` on a ``fake`` process group (the dry-run does) and
nothing is allocated. Parameters are made on the ``meta`` device (nothing
drawn) and then as fake CPU tensors; every argument is a DTensor with the
rules' placements, each rank holding its own block.

Differences from the reference: the port stays in IEEE fp32 (no bf16
casts, no remat), and its ``serve_params="auto"`` rule counts fp32 bytes
against the H100's 80 GB (below), which moves some cells between ``tp`` and
``fsdp`` against the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core.modes import Mode
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import dp_axes
from repro_torch.launch.roofline import HBM_BYTES


class Program(NamedTuple):
    name: str
    fn: Callable        # fn(*args) runs the program once
    args: tuple         # its arguments, placed on the mesh
    meta: dict


def fake_params(module: torch.nn.Module) -> torch.nn.Module:
    """Give every parameter of ``module`` (built on ``meta``) an
    uninitialised CPU tensor of its shape and dtype: a fake tensor under an
    active ``FakeTensorMode``. In place; returns ``module``."""
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[name] = torch.nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device="cpu"),
                    requires_grad=p.requires_grad)
    return module


def input_batch(cfg: ModelConfig, shape: ShapeConfig,
                device: str = "cpu") -> dict:
    """Zero stand-ins for every model input of this cell."""
    b = shape.global_batch
    t = 1 if shape.kind == "decode" else shape.seq_len
    ids = dict(dtype=torch.long, device=device)
    batch: dict = {}
    if cfg.embed_inputs:
        batch["tokens"] = torch.zeros((b, t), **ids)
    else:
        batch["frame_embeddings"] = torch.zeros((b, t, cfg.d_model),
                                                device=device)
    if cfg.family == "vlm":
        batch["image_embeddings"] = torch.zeros(
            (b, cfg.num_image_tokens, cfg.d_model), device=device)
    if shape.kind == "train":
        batch["targets"] = torch.zeros((b, t), **ids)
    if shape.kind == "decode":
        batch["positions"] = torch.zeros((b, 1), **ids)
        batch["cache_len"] = torch.zeros((b,), **ids)
    return batch


def logical_rules(cfg: ModelConfig, kind: str, mesh) -> dict:
    """The logical activation axes of one (cfg, shape kind, mesh), as the
    reference binds them: the residual stream's d_model over 'model' for
    training; an SSM folds 'model' into the batch, and the sequence takes
    it where the batch cannot."""
    batch_axes = dp_axes(mesh)
    embed_axis = "model" if kind == "train" else None
    seq_axis = None
    if cfg.family == "ssm":
        batch_axes = batch_axes + ("model",)
        embed_axis = None
        seq_axis = "model"
    return {"mesh": mesh, "batch": batch_axes, "state_batch": dp_axes(mesh),
            "seq": seq_axis, "embed": embed_axis, "vocab": "model",
            "expert": "model", "capacity": "data", "ffn": None}


def serve_params_for(cfg: ModelConfig, serve_params: str) -> str:
    """'tp' or 'fsdp'. "auto" keeps the reference's rule (TP-only weights
    while the deployment pytree at TP-16 takes at most a quarter of a
    chip's memory), counted in the port's fp32 (mu, srm) bytes against the
    card's 80 GB: the reference counts bf16 against 16 GB, so a model
    between 16e9 and 40e9 parameters is 'fsdp' there and 'tp' here."""
    if serve_params in ("auto", "tp"):
        per_device = cfg.param_count() * 4 * 2 / 16
        return "fsdp" if per_device > HBM_BYTES / 4 else "tp"
    return serve_params


def num_microbatches(params: int) -> int:
    """Gradient-accumulation microbatches by total parameters, as the
    reference picks them."""
    if params > 3e10:
        return 8
    if params > 5e9:
        return 4
    return 1


def build_program(arch: str, shape_name: Union[str, ShapeConfig], mesh, *,
                  mode_override: Optional[str] = None,
                  formulation: str = "srm",
                  impl: Optional[str] = None,
                  serve_params: str = "tp",
                  cfg: Optional[ModelConfig] = None) -> Program:
    """The program of one cell on ``mesh``. ``shape_name`` is a key of
    ``SHAPES`` or a ``ShapeConfig``; ``cfg`` replaces ``arch``'s config
    (tests pass reduced ones). Binds the cell's logical activation rules
    (``pjit_hints.set_rules``); the caller clears them."""
    from repro_torch.core.dispatch import resolve_impl
    from repro_torch.nn import pjit_hints

    cfg = cfg or get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}
    pjit_hints.set_rules(logical_rules(cfg, shape.kind, mesh))
    meta["formulation"] = formulation
    meta["impl"] = resolve_impl(impl)
    meta["serve_params"] = serve_params_for(cfg, serve_params)
    serve_tp = meta["serve_params"] == "tp"
    if shape.kind == "train":
        return _train_program(cfg, shape, mesh, meta, mode_override)
    return _serve_program(cfg, shape, mesh, meta, mode_override, formulation,
                          serve_tp)


def _placed(fn):
    """``fn`` run with plain tensors the model makes counted as replicas
    beside the DTensors."""
    def run(*args):
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            return fn(*args)
    return run


def _model(cfg: ModelConfig):
    from repro_torch.models import lm

    return fake_params(lm.init_params(cfg, device="meta"))


def _converted(model):
    """``model`` (on ``meta``) with every variational leaf (mu, rho) made a
    converted PFP leaf (mu, srm) of the same shape, as ``svi_to_pfp``
    makes it; nothing is computed. In place; returns ``model``."""
    from repro_torch.nn.module import BayesParam

    leaves = [(name, m) for name, m in model.named_modules()
              if isinstance(m, BayesParam) and "rho" in m.keys()]
    for name, leaf in leaves:
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent), attr,
                BayesParam(mu=leaf.mu, srm=torch.empty_like(leaf.rho)))
    return model


def _train_program(cfg, shape, mesh, meta, mode_override) -> Program:
    from repro_torch.bayes.variational import KLSchedule
    from repro_torch.core.gaussian import is_gaussian
    from repro_torch.models import lm
    from repro_torch.training.optimizer import Adam
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_svi_train_step)

    optimizer = Adam(learning_rate=1e-3, clip_norm=1.0)
    mode = Mode.parse(mode_override) if mode_override else Mode.SVI
    meta["num_microbatches"] = num_microbatches(meta["params"])

    def forward_fn(model, batch, ctx):
        if mode != Mode.SVI:
            ctx = dataclasses.replace(ctx, mode=mode)
        logits, aux, _ = lm.forward(model, cfg, batch, ctx)
        if is_gaussian(logits):
            logits = logits.mean
        return logits, aux

    step = make_svi_train_step(
        forward_fn, optimizer,
        num_data=shape.global_batch * shape.seq_len * 1000,
        kl_schedule=KLSchedule(alpha_max=0.25, anneal_steps=1000),
        num_microbatches=meta["num_microbatches"])
    model = shlib.distribute_params(_model(cfg), mesh)
    state = init_train_state(model, optimizer)
    batch = input_batch(cfg, shape)
    batch = shlib.distribute_tree(batch, shlib.batch_shardings(batch, mesh),
                                  mesh)
    return Program(name=f"{cfg.name}:{shape.name}:train[{mode.value}]",
                   fn=_placed(step),
                   args=(state, batch, torch.Generator().manual_seed(0)),
                   meta=meta)


def _serve_program(cfg, shape, mesh, meta, mode_override, formulation,
                   serve_tp) -> Program:
    from repro_torch.models import lm
    from repro_torch.serving.decode import make_prefill_step, make_serve_step

    mode = Mode.parse(mode_override) if mode_override else Mode.PFP
    model = lm.init_params(cfg, device="meta")
    if mode == Mode.PFP:
        model = _converted(model)
    model = shlib.distribute_params(fake_params(model), mesh,
                                    serve=serve_tp)
    batch = input_batch(cfg, shape)
    batch = shlib.distribute_tree(batch, shlib.batch_shardings(batch, mesh),
                                  mesh)
    kw = dict(mode=mode, formulation=formulation, impl=meta["impl"],
              device="cpu")
    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, max_len=shape.seq_len, **kw)
        args: Any = (model, batch)
    else:
        fn = make_serve_step(cfg, **kw)
        states = lm.init_decode_state(cfg, shape.global_batch, shape.seq_len,
                                      device="cpu")
        states = shlib.distribute_tree(
            states, shlib.state_shardings(states, mesh), mesh)
        args = (model, batch, states)
    return Program(name=f"{cfg.name}:{shape.name}:{shape.kind}[{mode.value}]",
                   fn=_placed(fn), args=args, meta=meta)


def cell_is_applicable(arch: str, shape_name: str) -> tuple[bool, str]:
    """long_500k runs only on sub-quadratic archs."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 524k-token decode requires "
                       "sub-quadratic attention")
    return True, ""
