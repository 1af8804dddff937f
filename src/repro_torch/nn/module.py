"""Bayesian weight leaves, the execution context and weight resolution.

Counterpart of ``repro/nn/module.py``. A Bayesian weight is a
:class:`BayesParam` module whose parameters are one of the reference's
three leaf flavours:

  variational        : ``mu``, ``rho``  (sigma = exp(rho))
  converted PFP (SRM): ``mu``, ``srm``  (precomputed E[w^2], paper §5)
  converted PFP (VAR): ``mu``, ``var``

so a model's parameter names are the reference's leaf paths
(``dense0.w.mu``, ``conv1.b.rho``, ...). Deterministic leaves (norm gains
``g``, LayerNorm biases ``b``) are parameters of the layer module.
``resolve_weight`` turns a leaf into what the active mode needs: a tensor
(DETERMINISTIC), a reparameterised sample ``mu + sigma * eps`` (SVI) or a
:class:`GaussianTensor` (PFP).

Every leaf is an ``nn.Parameter`` created with ``requires_grad=False``, so
a model built for serving never builds an autograd graph;
``training.train_loop.init_train_state`` turns gradients on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.device import DeviceLike, init_generator, resolve_device
from repro_torch.core.gaussian import SRM, VAR, GaussianTensor
from repro_torch.core.modes import Mode

LEAF_KEYS = (frozenset({"mu", "rho"}), frozenset({"mu", "srm"}),
             frozenset({"mu", "var"}))


def frozen(t: torch.Tensor) -> nn.Parameter:
    """``t`` as a leaf parameter that needs no gradient until training
    turns it on (detached from any graph ``t`` belongs to)."""
    return nn.Parameter(t.detach(), requires_grad=False)


class BayesParam(nn.Module):
    """One Bayesian weight: parameters ``mu`` plus ``rho``, ``srm`` or
    ``var``."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        if frozenset(tensors) not in LEAF_KEYS:
            raise ValueError(f"a Bayesian leaf holds one of {LEAF_KEYS}, "
                             f"got {sorted(tensors)}")
        shapes = {tuple(t.shape) for t in tensors.values()}
        if len(shapes) != 1:
            raise ValueError(f"leaf tensors differ in shape: {shapes}")
        for name, t in tensors.items():
            self.register_parameter(name, frozen(t))

    def keys(self) -> frozenset:
        return frozenset(self._parameters)

    @property
    def shape(self):
        return self.mu.shape


def is_bayes_leaf(tree) -> bool:
    """A dict of numpy-like arrays with one of the leaf key sets."""
    return isinstance(tree, Mapping) and frozenset(tree) in LEAF_KEYS


@dataclasses.dataclass
class Context:
    """Per-forward execution context.

    Under SVI every Bayesian leaf draws its ε from ``generator`` (on the
    weights' device), or, where ``eps`` is given, from ``eps``: a callable
    that receives each leaf's ``mu`` in the order the forward resolves the
    leaves and returns that leaf's ε (tests hand in the reference's own
    noise this way)."""

    mode: Mode
    formulation: str = "srm"          # 'srm' (Eq. 12) | 'var' (Eq. 7)
    attention_mode: str = "mean_field"  # | 'variance_corrected'
    # 'eager' | 'kernel' | None (core/dispatch.py's DEFAULT_IMPL, 'kernel').
    impl: Optional[str] = None
    device: DeviceLike = None         # None: the CUDA card
    generator: Optional[torch.Generator] = None
    eps: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __post_init__(self):
        self.mode = Mode.parse(self.mode)

    def sample_eps(self, mu: torch.Tensor) -> torch.Tensor:
        """Standard normal noise of ``mu``'s shape, dtype and device."""
        if self.eps is not None:
            eps = self.eps(mu)
            if tuple(eps.shape) != tuple(mu.shape):
                raise ValueError(f"eps of shape {tuple(eps.shape)} for a "
                                 f"leaf of shape {tuple(mu.shape)}")
            return eps.to(device=mu.device, dtype=mu.dtype)
        if self.generator is None:
            raise ValueError("SVI mode needs ctx.generator (or ctx.eps)")
        return torch.randn(mu.shape, generator=self.generator,
                           dtype=mu.dtype, device=mu.device)


def bayes_variance(param: BayesParam) -> torch.Tensor:
    keys = param.keys()
    if "rho" in keys:
        return torch.exp(2.0 * param.rho)
    if "var" in keys:
        return param.var
    return param.srm - torch.square(param.mu)


def bayes_srm(param: BayesParam) -> torch.Tensor:
    if "srm" in param.keys():
        return param.srm
    return bayes_variance(param) + torch.square(param.mu)


def resolve_weight(param, ctx: Context):
    """Tensor for DETERMINISTIC, a sample ``mu + sigma * eps`` for SVI
    (sigma = exp(rho), or the converted leaf's sqrt(max(var, 0))),
    GaussianTensor for PFP."""
    if not isinstance(param, BayesParam):
        return param
    if ctx.mode == Mode.DETERMINISTIC:
        return param.mu
    if ctx.mode == Mode.SVI:
        sigma = (torch.exp(param.rho) if "rho" in param.keys() else
                 torch.sqrt(torch.clamp(bayes_variance(param), min=0.0)))
        return param.mu + sigma * ctx.sample_eps(param.mu)
    if "srm" in param.keys():
        return GaussianTensor(param.mu, param.srm, SRM)
    return GaussianTensor(param.mu, bayes_variance(param), VAR)


def init_bayes(shape, *, generator: Optional[torch.Generator] = None,
               scale: Optional[float] = None, fan_in: Optional[int] = None,
               sigma_init: float = 1e-4, mu_init: Optional[float] = None,
               dtype=torch.float32, device: DeviceLike = None) -> BayesParam:
    """Variational Gaussian weight. Default: mu from a normal truncated at
    +-2 and scaled by fan_in**-0.5; sigma = sigma_init (the paper's 1e-4).
    Draws on the device of ``generator`` (a CPU one seeded with 0 when none
    is given), then moves to ``device``."""
    device = resolve_device(device)
    shape = tuple(shape)
    if mu_init is not None:
        mu = torch.full(shape, mu_init, dtype=dtype, device=device)
    else:
        if scale is None:
            scale = (fan_in if fan_in is not None else shape[0]) ** -0.5
        g = init_generator(generator)
        mu = torch.empty(shape, dtype=dtype, device=g.device)
        nn.init.trunc_normal_(mu, 0.0, 1.0, -2.0, 2.0, generator=g)
        mu = mu.mul_(scale).to(device)
    rho = torch.full(shape, math.log(sigma_init), dtype=dtype, device=device)
    return BayesParam(mu=mu, rho=rho)


def load_numpy_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Fill ``module`` from the reference's parameter tree: nested dicts of
    numpy arrays (or of torch tensors, on any device: each is copied).

    * A ``{'mu','rho'}``, ``{'mu','srm'}`` or ``{'mu','var'}`` leaf replaces
      the module's :class:`BayesParam` of the same path (on the same
      device), so the key set follows the tree.
    * A plain array (a norm gain ``g``, a LayerNorm bias ``b``) replaces the
      parameter of that name.
    * Under an ``nn.ModuleList`` child the tree is stacked, as the
      reference stacks scanned layer groups (``params['stack']``): every
      array carries a leading axis of the list's length, and entry ``i``
      fills the list's module ``i``.

    Every loaded leaf starts without gradients, as a newly built one does.
    Returns ``module``."""
    children = dict(module.named_children())
    plain = dict(module.named_parameters(recurse=False))
    if set(tree) != set(children) | set(plain):
        raise KeyError(f"tree has {sorted(tree)}, module has "
                       f"{sorted(set(children) | set(plain))}")
    for name, sub in tree.items():
        if name in plain:
            old = plain[name]
            new = _copy_to(sub, old.device)
            if new.shape != old.shape:
                raise ValueError(f"{name}: shape {tuple(new.shape)} vs "
                                 f"{tuple(old.shape)}")
            setattr(module, name, frozen(new))
            continue
        child = children[name]
        if isinstance(child, nn.ModuleList):
            for i, layer in enumerate(child):
                load_numpy_params(layer, _layer_of(sub, i, len(child)))
            continue
        if not is_bayes_leaf(sub):
            load_numpy_params(child, sub)
            continue
        if not isinstance(child, BayesParam):
            raise TypeError(f"{name}: the tree holds a leaf, the module a "
                            f"{type(child).__name__}")
        # Registered in sorted order ('mu' first), as a new leaf registers
        # them: the order of named_parameters() is the order in which
        # training sums the gradient norm.
        tensors = {k: _copy_to(sub[k], child.mu.device) for k in sorted(sub)}
        if tuple(tensors["mu"].shape) != tuple(child.shape):
            raise ValueError(f"{name}: shape {tuple(tensors['mu'].shape)} "
                             f"vs {tuple(child.shape)}")
        setattr(module, name, BayesParam(**tensors))
    return module


def _copy_to(value, device) -> torch.Tensor:
    """A new tensor on ``device`` holding a numpy array or tensor."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device, copy=True)
    return torch.tensor(np.asarray(value), device=device)


@dataclasses.dataclass(frozen=True)
class LayoutLeaf:
    """A leaf of :func:`param_layout`: the dotted names of the parameters
    it holds, one, or one a layer where an ``nn.ModuleList`` stacks them
    along a leading axis."""
    names: tuple
    stacked: bool


def param_layout(module: nn.Module, prefix: str = "") -> dict:
    """The reference's tree of ``module``'s parameters (a
    :class:`BayesParam` as its leaf dict, a plain parameter by name, an
    ``nn.ModuleList`` child stacked), with a :class:`LayoutLeaf` naming
    the parameters at each leaf."""
    tree = {name: LayoutLeaf((prefix + name,), False)
            for name, _ in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        path = f"{prefix}{name}."
        if isinstance(child, BayesParam):
            tree[name] = {k: LayoutLeaf((path + k,), False)
                          for k, _ in child.named_parameters()}
        elif isinstance(child, nn.ModuleList):
            tree[name] = _stacked_layout([param_layout(m, f"{path}{i}.")
                                          for i, m in enumerate(child)])
        else:
            tree[name] = param_layout(child, path)
    return tree


def _stacked_layout(trees):
    if isinstance(trees[0], Mapping):
        return {k: _stacked_layout([t[k] for t in trees]) for k in trees[0]}
    return LayoutLeaf(tuple(n for t in trees for n in t.names), True)


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that shares no memory with it."""
    t = t.detach()
    return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()


def layout_tree(layout, values: Mapping[str, torch.Tensor]) -> dict:
    """``layout`` with each leaf a host copy of its named ``values`` as a
    numpy array (the layers of a stacked leaf stacked), sharing no memory
    with them."""
    if isinstance(layout, Mapping):
        return {k: layout_tree(v, values) for k, v in layout.items()}
    if layout.stacked:   # stacked where the tensors are: one host copy
        return torch.stack([values[n].detach()
                            for n in layout.names]).cpu().numpy()
    return _host_copy(values[layout.names[0]])


def layout_values(layout, tree, device) -> dict:
    """The inverse of :func:`layout_tree`: {parameter name: a new tensor on
    ``device``} from a tree of numpy arrays or tensors."""
    if isinstance(layout, Mapping):
        out = {}
        for k, v in layout.items():
            out.update(layout_values(v, tree[k], device))
        return out
    if not layout.stacked:
        return {layout.names[0]: _copy_to(tree, device)}
    return {n: _copy_to(_layer_of(tree, i, len(layout.names)), device)
            for i, n in enumerate(layout.names)}


def numpy_params(module: nn.Module) -> dict:
    """The inverse of :func:`load_numpy_params`: ``module``'s parameters as
    the reference's tree of numpy arrays (a :class:`BayesParam` as its leaf
    dict, a plain parameter by name, an ``nn.ModuleList`` child stacked
    along a leading axis)."""
    return layout_tree(param_layout(module),
                       dict(module.named_parameters(remove_duplicate=False)))


def _layer_of(tree, i: int, n: int):
    """Entry ``i`` of a stacked tree whose arrays lead with an axis of n."""
    if isinstance(tree, Mapping):
        return {k: _layer_of(v, i, n) for k, v in tree.items()}
    arr = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)
    if arr.ndim == 0 or arr.shape[0] != n:
        raise ValueError(f"stacked leaf of shape {arr.shape} for {n} layers")
    return arr[i]
