"""Impl-dispatch registry for the port's PFP operators.

Counterpart of ``repro/core/dispatch.py``, limited to the ops of the
paper's MLP and LeNet-5: ``dense``, ``conv2d_im2col``, ``activation`` and
``maxpool2d``. Each op is registered with two impls operating on
:class:`GaussianTensor`:

  * ``eager``  : pure torch from ``core/pfp_layers.py`` (the JAX package's
    ``xla`` impl);
  * ``kernel`` : the wrappers of ``kernels/ops.py``, which launch the
    hand-written CUDA kernels for CUDA tensors and run their plain versions
    for CPU tensors.

The representation contract (compute layers consume SRM and emit VAR,
activations consume VAR and emit SRM) is enforced here by the public
functions, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core import pfp_layers
from repro_torch.core.gaussian import SRM, VAR, GaussianTensor, is_gaussian
from repro_torch.kernels import ops

IMPLS = ("eager", "kernel")
FORMULATIONS = ("srm", "var")
DEFAULT_IMPL = "kernel"   # what ``Context.impl=None`` runs

# op name -> {'eager': fn, 'kernel': fn}
_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def resolve_impl(impl: Optional[str]) -> str:
    """None -> the default impl; otherwise validate and pass through."""
    if impl is None:
        return DEFAULT_IMPL
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    return impl


def register(name: str, impl: str):
    """Decorator: register ``fn`` as the ``impl`` implementation of ``name``."""
    def deco(fn):
        _REGISTRY.setdefault(name, {})[impl] = fn
        return fn

    return deco


def get_op(name: str, impl: Optional[str] = None) -> Callable:
    return _REGISTRY[name][resolve_impl(impl)]


def _check_formulation(formulation: str) -> None:
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown formulation: {formulation}")


# ---------------------------------------------------------------------------
# dense (Eqs. 4/7/12/13)
# ---------------------------------------------------------------------------
@register("dense", "eager")
def _dense_eager(x, w, formulation):
    return pfp_layers.pfp_dense(x, w, formulation=formulation)


@register("dense", "kernel")
def _dense_kernel(x, w, formulation):
    dtype = x.dtype
    if not is_gaussian(x):
        # Eq. 13 for deterministic inputs, whatever the formulation; the
        # weight's variance is taken from its SRM leaf here.
        mu, var = ops.pfp_dense(x, x, w.mean, w.var, first_layer=True)
    elif formulation == "var":
        # Eq. 7 consumes (mu, var) operands natively.
        mu, var = ops.pfp_dense_var(x.mean, x.var, w.mean, w.var)
    else:
        mu, var = ops.pfp_dense(x.mean, x.srm, w.mean, w.srm)
    return GaussianTensor(mu.to(dtype), var.to(dtype), VAR)


def pfp_dense(x, w, b=None, *, formulation: str = "srm",
              impl: Optional[str] = None) -> GaussianTensor:
    """PFP dense y = x @ W (+ b). Consumes SRM (VAR for Eq. 7), emits VAR.

    ``b`` may be None, a deterministic tensor, or a GaussianTensor (the
    paper's three bias configurations, §5).
    """
    _check_formulation(formulation)
    x = _to_compute_rep(x, formulation)
    out = get_op("dense", impl)(x, w, formulation)
    return _add_bias(out, b)


def _to_compute_rep(x, formulation):
    # Eq. 12 consumes SRM; the Eq. 7 ablation natively consumes variances.
    if not is_gaussian(x):
        return x
    return x.to_srm() if formulation == "srm" else x.to_var()


def _add_bias(out: GaussianTensor, b) -> GaussianTensor:
    if b is None:
        return out
    if is_gaussian(b):
        return GaussianTensor(out.mean + b.mean, out.var + b.var, VAR)
    return GaussianTensor(out.mean + b, out.var, VAR)


# ---------------------------------------------------------------------------
# conv2d (im2col) — lowered onto the dense kernel
# ---------------------------------------------------------------------------
@register("conv2d_im2col", "eager")
def _conv_eager(x, w, stride, padding, formulation):
    return pfp_layers.pfp_conv2d_im2col(x, w, stride=stride, padding=padding,
                                        formulation=formulation)


@register("conv2d_im2col", "kernel")
def _conv_kernel(x, w, stride, padding, formulation):
    # im2col takes x.srm, and Eq. 7 then reads the patches' variance back:
    # under formulation="var" the input goes VAR -> SRM -> VAR, as in the
    # reference.
    xp, w2 = pfp_layers.im2col(x, w, stride=stride, padding=padding)
    return _dense_kernel(xp, w2, formulation)


def pfp_conv2d_im2col(x, w, b=None, *, stride: int = 1,
                      padding: str = "VALID", formulation: str = "srm",
                      impl: Optional[str] = None) -> GaussianTensor:
    """PFP conv2d (NHWC input, HWIO weight). Consumes SRM, emits VAR."""
    _check_formulation(formulation)
    x = _to_compute_rep(x, formulation)
    out = get_op("conv2d_im2col", impl)(x, w, stride, padding, formulation)
    return _add_bias(out, b)


# ---------------------------------------------------------------------------
# activation — moment-matched elementwise nonlinearities
# ---------------------------------------------------------------------------
@register("activation", "eager")
def _activation_eager(x, kind):
    return pfp_layers.pfp_activation(x, kind)


@register("activation", "kernel")
def _activation_kernel(x, kind):
    mu, srm = ops.pfp_activation(x.mean, x.var, kind=kind)
    return GaussianTensor(mu.to(x.dtype), srm.to(x.dtype), SRM)


def pfp_activation(x: GaussianTensor, kind: str,
                   impl: Optional[str] = None) -> GaussianTensor:
    """Moment-matched activation. Consumes VAR, emits SRM."""
    return get_op("activation", impl)(x.to_var(), kind)


# ---------------------------------------------------------------------------
# maxpool2d — Clark tournament (k=2)
# ---------------------------------------------------------------------------
@register("maxpool2d", "eager")
def _maxpool_eager(x, window):
    return pfp_layers.pfp_maxpool2d(x, window=window)


@register("maxpool2d", "kernel")
def _maxpool_kernel(x, window):
    if window != 2:
        raise ValueError("the PFP max pool is specialised to k=2")
    mu, var = ops.pfp_maxpool2d(x.mean, x.var)
    return GaussianTensor(mu.to(x.dtype), var.to(x.dtype), VAR)


def pfp_maxpool2d(x: GaussianTensor, window: int = 2,
                  impl: Optional[str] = None) -> GaussianTensor:
    """PFP max pool (NHWC). Consumes VAR, emits VAR."""
    return get_op("maxpool2d", impl)(x.to_var(), window)
