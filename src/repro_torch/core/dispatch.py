"""Impl-dispatch registry for the port's PFP operators.

Counterpart of ``repro/core/dispatch.py``, limited to the ops of the
paper's MLP and LeNet-5 (``dense``, ``conv2d_im2col``, ``activation``,
``maxpool2d``), of the transformer LM (``rmsnorm``, ``layernorm``,
``glu_product``, ``attention``, ``attention_cache``, ``attention_paged``,
``embedding``, ``residual``) and of its MoE blocks (``dense_batched``).
Each op is registered with two impls:

  * ``eager``  : pure torch from ``core/pfp_layers.py`` (the JAX package's
    ``xla`` impl);
  * ``kernel`` : the wrappers of ``kernels/ops.py``, which launch the
    hand-written CUDA kernels for CUDA tensors and run their plain versions
    for CPU tensors.

The representation contract (compute layers consume SRM and emit VAR,
activations consume VAR and emit SRM) is enforced here by the public
functions, as in the reference. The embedding gather and the residual add
have no kernel in the reference either: both impls share one function.
The reference's opt-in ``norm_dense_act`` fusion pass and its general
``einsum`` op (with the depthwise lift onto ``dense_batched``) are not
ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core import pfp_layers
from repro_torch.core.gaussian import (SRM, VAR, GaussianTensor, as_gaussian,
                                       is_gaussian)
from repro_torch.kernels import ops, ref

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
# dense_batched — one PFP dense per expert (the MoE expert MLP)
# ---------------------------------------------------------------------------
@register("dense_batched", "eager")
def _dense_batched_eager(x, w, formulation):
    return pfp_layers.pfp_einsum("eck,ekn->ecn", x, w, formulation=formulation)


@register("dense_batched", "kernel")
def _dense_batched_kernel(x, w, formulation):
    dtype = x.dtype
    if not is_gaussian(x):
        # Eq. 13 with a leading expert axis, whatever the formulation.
        mu, var = ops.pfp_dense_batched(x, x, w.mean, w.var, first_layer=True)
    elif formulation == "var":
        mu, var = ops.pfp_dense_batched_var(x.mean, x.var, w.mean, w.var)
    else:
        mu, var = ops.pfp_dense_batched(x.mean, x.srm, w.mean, w.srm)
    return GaussianTensor(mu.to(dtype), var.to(dtype), VAR)


def pfp_dense_batched(x, w: GaussianTensor, *, formulation: str = "srm",
                      impl: Optional[str] = None) -> GaussianTensor:
    """Batched-expert PFP dense: (E, C, K) x (E, K, N) -> (E, C, N), one
    independent PFP dense per leading index (the MoE expert MLP's
    'ecd,edf->ecf'). Consumes SRM (VAR for Eq. 7), emits VAR. The kernel
    impl is one launch over all experts."""
    _check_formulation(formulation)
    return get_op("dense_batched", impl)(_to_compute_rep(x, formulation), w,
                                         formulation)


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


# ---------------------------------------------------------------------------
# attention — mean-field joint mean/variance softmax attention
# ---------------------------------------------------------------------------
@register("attention", "eager")
def _attention_eager(q_mu, k_mu, v_mu, v_var, scale, causal):
    return ref.pfp_attention_ref(q_mu, k_mu, v_mu, v_var, scale, causal)


@register("attention", "kernel")
def _attention_kernel(q_mu, k_mu, v_mu, v_var, scale, causal):
    return ops.pfp_attention(q_mu, k_mu, v_mu, v_var, scale=scale,
                             causal=causal)


def pfp_attention(q_mu, k_mu, v_mu, v_var, *, scale: float,
                  causal: bool = True, impl: Optional[str] = None):
    """Mean-field PFP attention: q (B, H, Tq, D), kv (B, Hkv, Tk, D),
    H % Hkv == 0 -> (mean, var) at H heads. Tensor-level, as in the
    reference: the layer assembles score means and value variances. Causal
    masking is right-aligned by index; callers with remapped positions or
    windows keep the chunked core of ``nn/attention.py``."""
    dtype = q_mu.dtype
    mu, var = get_op("attention", impl)(q_mu, k_mu, v_mu, v_var, scale, causal)
    return mu.to(dtype), var.to(dtype)


# ---------------------------------------------------------------------------
# attention_cache / attention_paged — KV-cache decode attention
# ---------------------------------------------------------------------------
@register("attention_cache", "eager")
def _attention_cache_eager(q_mu, k_mu, v_mu, v_var, q_start, kv_len, scale,
                           causal, window):
    return ref.pfp_attention_cache_ref(q_mu, k_mu, v_mu, v_var, q_start,
                                       kv_len, scale, causal=causal,
                                       window=window)


@register("attention_cache", "kernel")
def _attention_cache_kernel(q_mu, k_mu, v_mu, v_var, q_start, kv_len, scale,
                            causal, window):
    return ops.pfp_attention_cache(q_mu, k_mu, v_mu, v_var, q_start, kv_len,
                                   scale=scale, causal=causal, window=window)


def pfp_attention_cache(q_mu, k_mu, v_mu, v_var, q_start, kv_len, *,
                        scale: float, causal: bool = True, window=None,
                        impl: Optional[str] = None):
    """KV-cache PFP attention: q (B, H, Tq, D) x cache (B, Hkv, S, D),
    q_start / kv_len (B,) integer tensors. Query row i of batch b sits at
    absolute position ``q_start[b] + i`` (the cache-insert contract: a
    caller's positions are contiguous from each row's start); key j is real
    iff ``j < kv_len[b]``; optional sliding ``window``."""
    dtype = q_mu.dtype
    mu, var = get_op("attention_cache", impl)(q_mu, k_mu, v_mu, v_var,
                                              q_start, kv_len, scale, causal,
                                              window)
    return mu.to(dtype), var.to(dtype)


@register("attention_paged", "eager")
def _attention_paged_eager(q_mu, k_pages, v_pages, vv_pages, page_table,
                           q_start, kv_len, scale, causal, window):
    return ref.pfp_attention_paged_ref(q_mu, k_pages, v_pages, vv_pages,
                                       page_table, q_start, kv_len, scale,
                                       causal=causal, window=window)


@register("attention_paged", "kernel")
def _attention_paged_kernel(q_mu, k_pages, v_pages, vv_pages, page_table,
                            q_start, kv_len, scale, causal, window):
    return ops.pfp_attention_paged(q_mu, k_pages, v_pages, vv_pages,
                                   page_table, q_start, kv_len, scale=scale,
                                   causal=causal, window=window)


def pfp_attention_paged(q_mu, k_pages, v_pages, vv_pages, page_table,
                        q_start, kv_len, *, scale: float, causal: bool = True,
                        window=None, impl: Optional[str] = None):
    """Paged-KV PFP attention: q (B, H, Tq, D) against page pools
    (NP, Hkv, page_size, D) read through ``page_table`` (B, P). The kernel
    reads each key row through the table in place; the eager impl gathers
    the pages into a contiguous cache first. Masking as in
    :func:`pfp_attention_cache`: ``kv_len`` also masks the padded table
    slots."""
    dtype = q_mu.dtype
    mu, var = get_op("attention_paged", impl)(q_mu, k_pages, v_pages,
                                              vv_pages, page_table, q_start,
                                              kv_len, scale, causal, window)
    return mu.to(dtype), var.to(dtype)


# ---------------------------------------------------------------------------
# norms — delta-method RMSNorm / LayerNorm, optional activation epilogue
# ---------------------------------------------------------------------------
@register("rmsnorm", "eager")
def _rmsnorm_eager(x, gain, eps, act):
    out = pfp_layers.pfp_rmsnorm(x, gain, eps=eps)
    return pfp_layers.pfp_activation(out, act) if act is not None else out


@register("rmsnorm", "kernel")
def _rmsnorm_kernel(x, gain, eps, act):
    mu, sec = ops.pfp_rmsnorm(x.mean, x.second, gain, rep=x.rep, eps=eps,
                              act=act)
    rep = SRM if act is not None else VAR
    return GaussianTensor(mu.to(x.dtype), sec.to(x.dtype), rep)


def pfp_rmsnorm(x: GaussianTensor, gain, *, eps: float = 1e-6,
                act: Optional[str] = None,
                impl: Optional[str] = None) -> GaussianTensor:
    """RMSNorm under PFP. Emits VAR; with ``act`` the following activation
    runs as the norm's epilogue and the op emits SRM."""
    return get_op("rmsnorm", impl)(x, gain, eps, act)


@register("layernorm", "eager")
def _layernorm_eager(x, gain, bias, eps, act):
    out = pfp_layers.pfp_layernorm(x, gain, bias=bias, eps=eps)
    return pfp_layers.pfp_activation(out, act) if act is not None else out


@register("layernorm", "kernel")
def _layernorm_kernel(x, gain, bias, eps, act):
    mu, sec = ops.pfp_layernorm(x.mean, x.second, gain, bias, rep=x.rep,
                                eps=eps, act=act)
    rep = SRM if act is not None else VAR
    return GaussianTensor(mu.to(x.dtype), sec.to(x.dtype), rep)


def pfp_layernorm(x: GaussianTensor, gain, bias=None, *, eps: float = 1e-6,
                  act: Optional[str] = None,
                  impl: Optional[str] = None) -> GaussianTensor:
    """LayerNorm under PFP. Emits VAR (SRM with ``act``)."""
    return get_op("layernorm", impl)(x, gain, bias, eps, act)


# ---------------------------------------------------------------------------
# glu_product — exact gated product (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
@register("glu_product", "eager")
def _glu_eager(a, b):
    return pfp_layers.pfp_glu_product(a, b)


@register("glu_product", "kernel")
def _glu_kernel(a, b):
    mu, srm = ops.pfp_glu_product(a.mean, a.srm, b.mean, b.srm)
    return GaussianTensor(mu.to(a.dtype), srm.to(a.dtype), SRM)


def pfp_glu_product(a: GaussianTensor, b: GaussianTensor,
                    impl: Optional[str] = None) -> GaussianTensor:
    """Product of independent Gaussians. Consumes SRM, emits SRM (exact)."""
    return get_op("glu_product", impl)(a.to_srm(), b.to_srm())


# ---------------------------------------------------------------------------
# embedding / residual — one function for both impls
# ---------------------------------------------------------------------------
register("embedding", "eager")(pfp_layers.pfp_embedding)
register("embedding", "kernel")(pfp_layers.pfp_embedding)


def pfp_embedding(table: GaussianTensor, ids,
                  impl: Optional[str] = None) -> GaussianTensor:
    """Bayesian embedding gather. Emits VAR."""
    return get_op("embedding", impl)(table, ids)


register("residual", "eager")(pfp_layers.pfp_residual)
register("residual", "kernel")(pfp_layers.pfp_residual)


def pfp_residual(x, y, impl: Optional[str] = None) -> GaussianTensor:
    """Residual add of independent Gaussians. Emits VAR."""
    return get_op("residual", impl)(as_gaussian(x), as_gaussian(y))
