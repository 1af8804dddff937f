"""The SVI train step (the paper's pipeline) for the paper models and the
LM zoo, with gradient-accumulation microbatching.

Counterpart of ``repro/training/train_loop.py``. The model's parameters
are the trained state and are updated in place: ``TrainState`` holds the
model, the optimizer's state and the step. Gradients come from autograd
through the SVI forward's plain torch ops (the reference defines no custom
gradient either); one reparameterised sample per microbatch.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.bayes.variational import KLSchedule, elbo_loss
from repro_torch.core.modes import Mode
from repro_torch.nn.module import (Context, layout_tree, layout_values,
                                   load_numpy_params, param_layout)
from repro_torch.training.optimizer import Adam, AdamState


class TrainState(NamedTuple):
    model: nn.Module
    opt_state: AdamState
    step: int


def init_train_state(model: nn.Module, optimizer: Adam) -> TrainState:
    """Turn gradients on for every parameter of ``model`` (the Bayesian
    leaves and the norm gains and biases, as the reference's Adam maps
    over its whole tree) and start the optimizer's state."""
    model.requires_grad_(True)
    return TrainState(model, optimizer.init(dict(model.named_parameters())),
                      0)


def train_state_layout(model: nn.Module) -> dict:
    """The tree :func:`train_state_tree` gives for ``model``, with
    ``param_layout`` leaves (Adam's ``m`` and ``v`` name the parameter they
    belong to) and ``"step"`` at both steps: a proto for
    ``CheckpointManager.restore`` that copies nothing."""
    layout = param_layout(model)
    return {"params": layout, "opt_state": AdamState("step", layout, layout),
            "step": "step"}


def train_state_tree(state: TrainState) -> dict:
    """``state`` in the reference's ``TrainState`` layout, as host numpy
    arrays: ``{'params': numpy_params(model), 'opt_state': AdamState(step,
    m, v), 'step'}``, with ``m`` and ``v`` nested and stacked as the
    parameters are, and both steps 0-d int32 as the reference's are. Each
    package's ``CheckpointManager`` reads the other's files of this tree."""
    layout = param_layout(state.model)
    named = dict(state.model.named_parameters(remove_duplicate=False))
    opt = state.opt_state
    return {"params": layout_tree(layout, named),
            "opt_state": AdamState(np.asarray(opt.step, np.int32),
                                   layout_tree(layout, opt.m),
                                   layout_tree(layout, opt.v)),
            "step": np.asarray(state.step, np.int32)}


def load_train_state_tree(state: TrainState, tree) -> TrainState:
    """The inverse of :func:`train_state_tree`: load ``tree`` (numpy arrays
    or tensors, the port's layout or the reference's ``TrainState``) into
    ``state.model``. ``load_numpy_params`` replaces the model's Bayesian
    leaves, so gradients are turned back on and Adam's moments are keyed by
    the new parameters' names, on the model's device. Returns the new
    state; ``state``'s moments are not used."""
    get = (lambda t, k: t[k] if isinstance(t, dict) else getattr(t, k))
    model = load_numpy_params(state.model, get(tree, "params"))
    model.requires_grad_(True)
    layout = param_layout(model)
    device = next(model.parameters()).device
    opt = get(tree, "opt_state")
    m, v = (layout_values(layout, get(opt, k), device) for k in ("m", "v"))
    names = [n for n, _ in model.named_parameters()]
    if set(m) != set(names):
        raise KeyError(f"the tree's moments name {sorted(set(m) ^ set(names))}"
                       " differently from the model")
    return TrainState(model, AdamState(int(get(opt, "step")),
                                       {n: m[n] for n in names},
                                       {n: v[n] for n in names}),
                      int(get(tree, "step")))


def make_svi_train_step(forward_fn: Callable, optimizer: Adam, *,
                        num_data: int,
                        kl_schedule: KLSchedule = KLSchedule(),
                        prior_sigma: float = 1.0,
                        num_microbatches: int = 1):
    """Build an SVI train step.

    ``forward_fn(model, batch, ctx) -> (logits, aux)``: ``aux`` is a scalar
    loss term or ``lm.forward``'s MoE aux dict, whose ``'loss'`` entry is
    the term the objective takes. ``batch`` is a dict of tensors on the
    model's device that carries ``'targets'``; its leading axis is split
    into ``num_microbatches`` equal parts whose gradients and losses are
    averaged (the metrics ``nll`` and ``kl`` are the last part's).

    The step is ``train_step(state, batch, generator=None, *, eps=None)``:
    every leaf's ε comes from ``generator`` or from ``eps`` (the context's
    hook, called for every leaf of every microbatch in turn). Returns
    ``(new_state, metrics)`` with ``loss``, ``nll``, ``kl``, ``grad_norm``
    (tensors on the device, not synchronised) and ``lr``."""

    def loss_fn(model, batch, ctx, step):
        logits, aux = forward_fn(model, batch, ctx)
        if isinstance(aux, dict):
            aux = aux["loss"]
        return elbo_loss(logits, batch["targets"], model,
                         kl_scale=kl_schedule(step), num_data=num_data,
                         prior_sigma=prior_sigma, aux_loss=aux)

    def train_step(state: TrainState, batch, generator=None, *,
                   eps: Optional[Callable] = None):
        names, params = zip(*state.model.named_parameters())
        device = params[0].device
        ctx = Context(mode=Mode.SVI, device=device, generator=generator,
                      eps=eps)
        n = num_microbatches
        size = len(batch["targets"]) // n
        grads = loss = None
        for i in range(n):
            part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            part_loss, stats = loss_fn(state.model, part, ctx, state.step)
            part_grads = torch.autograd.grad(part_loss, params,
                                             materialize_grads=True)
            part_loss = part_loss.detach()
            if grads is None:
                grads, loss = list(part_grads), part_loss
            else:
                torch._foreach_add_(grads, part_grads)
                loss = loss + part_loss
            del part_grads
        if n > 1:
            torch._foreach_div_(grads, n)
            loss = loss / n
        _, opt_state, opt_stats = optimizer.update(
            dict(zip(names, grads)), state.opt_state, dict(zip(names, params)))
        metrics = {"loss": loss, **{k: v.detach() for k, v in stats.items()},
                   **opt_stats}
        return TrainState(state.model, opt_state, state.step + 1), metrics

    return train_step
