"""Impl-dispatch registry for the port's PFP operators.

Counterpart of ``repro/core/dispatch.py``, limited to the ops of the
paper's MLP and LeNet-5 (``dense``, ``conv2d_im2col``, ``activation``,
``maxpool2d``), of the transformer LM (``rmsnorm``, ``layernorm``,
``glu_product``, ``attention``, ``attention_cache``, ``attention_paged``,
``embedding``, ``residual``), of its MoE blocks (``dense_batched``) and
the general contraction ``einsum`` (the recurrent block's depthwise conv).
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

The opt-in fusion pass (``set_fusion`` / ``fusion()``) rewrites the chain
norm -> bias-free SRM dense -> activation onto the fused ``norm_dense_act``
kernel when the tuned-schedule cache (``repro_torch.tuning``) holds a
schedule for its shape; anything else runs the exact unfused chain. It is
the only op that consults the cache: no other kernel of the port takes a
tile from it.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

from repro_torch.core import pfp_layers
from repro_torch.core.gaussian import (SRM, VAR, GaussianTensor, as_gaussian,
                                       is_gaussian)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.pfp_activations import KINDS
from repro_torch.kernels.pfp_fused import fusable
from repro_torch.tuning import cache as schedule_cache

IMPLS = ("eager", "kernel")
FORMULATIONS = ("srm", "var")
DEFAULT_IMPL = "kernel"   # what ``Context.impl=None`` runs

# op name -> {'eager': fn, 'kernel': fn}
_REGISTRY: Dict[str, Dict[str, Callable]] = {}

# Active per-op profiler (repro_torch.obs.profiler.OpProfiler) or None.
# When set, get_op returns a fenced, timed wrapper around the resolved impl,
# _schedule_for reports each tuning-cache consult and the einsum fallback
# reports itself. The None check is the only cost the unprofiled path pays.
_PROFILER = None


def set_profiler(profiler):
    """Install (or clear, with None) the dispatch-level op profiler.
    Returns the previous profiler so scopes nest."""
    global _PROFILER
    prev = _PROFILER
    _PROFILER = profiler
    return prev


def get_profiler():
    return _PROFILER


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
    impl = resolve_impl(impl)
    fn = _REGISTRY[name][impl]
    if _PROFILER is not None:
        return _PROFILER.wrap(name, impl, fn)
    return fn


def _check_formulation(formulation: str) -> None:
    if formulation not in FORMULATIONS:
        raise ValueError(f"unknown formulation: {formulation}")


def _schedule_for(op: str, shape_key, dtype, device):
    """Consult the tuned-schedule cache for a kernel-impl call on
    ``device``: the Schedule, or None on a miss."""
    sched = schedule_cache.lookup(op, shape_key,
                                  str(dtype).replace("torch.", ""),
                                  schedule_cache.default_backend(device))
    if _PROFILER is not None:
        _PROFILER.on_cache_consult(op, sched is not None)
    return sched


def _rows(shape) -> int:
    n = 1
    for d in shape[:-1]:
        n *= int(d)
    return n


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
    if (isinstance(x, _PendingNorm) and formulation == "srm" and b is None
            and is_gaussian(w) and _fusion_active(impl)):
        # Fusion pass, step 2: a bias-free SRM dense over a pending norm
        # stays pending; an activation next may complete the fused unit.
        return _PendingNormDense(x, w, impl)
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
def _dense_batched_eager(x, w, formulation, rows):
    # Rows past a count are zero in x and come out as exact zeros here too.
    del rows
    return pfp_layers.pfp_einsum("eck,ekn->ecn", x, w, formulation=formulation)


@register("dense_batched", "kernel")
def _dense_batched_kernel(x, w, formulation, rows):
    dtype = x.dtype
    if not is_gaussian(x):
        # Eq. 13 with a leading expert axis, whatever the formulation.
        mu, var = ops.pfp_dense_batched(x, x, w.mean, w.var, first_layer=True,
                                        rows=rows)
    elif formulation == "var":
        mu, var = ops.pfp_dense_batched_var(x.mean, x.var, w.mean, w.var,
                                            rows=rows)
    else:
        mu, var = ops.pfp_dense_batched(x.mean, x.srm, w.mean, w.srm,
                                        rows=rows)
    return GaussianTensor(mu.to(dtype), var.to(dtype), VAR)


def pfp_dense_batched(x, w: GaussianTensor, *, formulation: str = "srm",
                      impl: Optional[str] = None,
                      rows=None) -> GaussianTensor:
    """Batched-expert PFP dense: (E, C, K) x (E, K, N) -> (E, C, N), one
    independent PFP dense per leading index (the MoE expert MLP's
    'ecd,edf->ecf'). Consumes SRM (VAR for Eq. 7), emits VAR. The kernel
    impl is one launch over all experts.

    ``rows``: None, or int32 (E,) counts of each expert's leading rows that
    hold tokens; the rows after them must be zero in ``x``. At decode the
    kernel impl writes their zeros without reading that expert's
    weights."""
    _check_formulation(formulation)
    return get_op("dense_batched", impl)(_to_compute_rep(x, formulation), w,
                                         formulation, rows)


# ---------------------------------------------------------------------------
# einsum — the general PFP contraction
# ---------------------------------------------------------------------------
# Specs the kernel impl has no kernel for run the eager impl; each such call
# adds one to FALLBACKS under "einsum:<spec>:<formulation>", so a silent
# fallback shows; an active op profiler counts it too (``on_fallback``).
FALLBACKS: Dict[str, int] = {}
_DENSE_SPECS = ("...k,kn->...n", "bk,kn->bn", "btk,kn->btn")


def reset_fallbacks() -> None:
    FALLBACKS.clear()


@register("einsum", "eager")
def _einsum_eager(subscripts, x, w, formulation):
    return pfp_layers.pfp_einsum(subscripts, x, w, formulation=formulation)


def _is_batched_mm(spec: str) -> bool:
    """Whether ``spec`` is 'bmk,bkn->bmn'-shaped (the MoE 'ecd,edf->ecf'):
    rank-3 operands sharing a leading batch letter and one contraction
    letter, a batch of independent PFP dense contractions."""
    if "->" not in spec or "." in spec:
        return False
    ins, out = spec.split("->")
    if ins.count(",") != 1:
        return False
    lhs, rhs = ins.split(",")
    if not len(lhs) == len(rhs) == len(out) == 3:
        return False
    return (lhs[0] == rhs[0] == out[0] and lhs[2] == rhs[1]
            and out[1] == lhs[1] and out[2] == rhs[2])


@register("einsum", "kernel")
def _einsum_kernel(subscripts, x, w, formulation):
    spec = subscripts.replace(" ", "")
    if is_gaussian(w):
        if spec in _DENSE_SPECS:
            return _dense_kernel(x, w, formulation)
        if _is_batched_mm(spec):
            return _dense_batched_kernel(x, w, formulation, None)
        if spec == "wbtr,wr->btr":
            return _depthwise_kernel(x, w, formulation)
    key = f"einsum:{spec}:{formulation}"
    FALLBACKS[key] = FALLBACKS.get(key, 0) + 1
    if _PROFILER is not None:
        _PROFILER.on_fallback(key)
    return _einsum_eager(subscripts, x, w, formulation)


def _depthwise_kernel(x, w, formulation):
    """'wbtr,wr->btr' on the batched dense kernel: out[b, t, r] =
    sum_w x[w, b, t, r] w[w, r] is, per channel r, a (B*T, W) x (W, 1)
    product, so the R channels are R "experts" of one launch."""
    wd, b, t, r = (x.mean if is_gaussian(x) else x).shape

    def to_tokens(a):   # (W, B, T, R) -> (R, B*T, W)
        return a.permute(3, 1, 2, 0).reshape(r, b * t, wd)

    def to_weights(a):  # (W, R) -> (R, W, 1)
        return a.t().unsqueeze(-1)

    xb = (GaussianTensor(to_tokens(x.mean), to_tokens(x.second), x.rep)
          if is_gaussian(x) else to_tokens(x))
    wb = GaussianTensor(to_weights(w.mean), to_weights(w.second), w.rep)
    out = _dense_batched_kernel(xb, wb, formulation, None)  # (R, B*T, 1)

    def back(a):
        return a.reshape(r, b, t).permute(1, 2, 0)

    return GaussianTensor(back(out.mean), back(out.var), VAR)


def pfp_einsum(subscripts: str, x, w: GaussianTensor, *,
               formulation: str = "srm",
               impl: Optional[str] = None) -> GaussianTensor:
    """General PFP contraction, for specs where each output is a sum of
    products of distinct (x, w) pairs. Consumes SRM (VAR for Eq. 7), emits
    VAR. The kernel impl runs dense-shaped specs on the dense kernel,
    'bmk,bkn->bmn' and the depthwise taps 'wbtr,wr->btr' on the batched
    dense kernel, and any other spec eagerly (counted in FALLBACKS)."""
    _check_formulation(formulation)
    return get_op("einsum", impl)(subscripts, _to_compute_rep(x, formulation),
                                  w, formulation)


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
    if isinstance(x, _PendingNormDense):
        # Fusion pass, step 3: the chain is complete. One kernel runs it
        # when its schedule is cached; otherwise the unfused chain runs.
        fused = x.fuse(kind, impl)
        if fused is not None:
            return fused
    return get_op("activation", impl)(x.to_var(), kind)


# ---------------------------------------------------------------------------
# maxpool2d — Clark tournament (k=2)
# ---------------------------------------------------------------------------
@register("maxpool2d", "eager")
def _maxpool_eager(x, window):
    return pfp_layers.pfp_maxpool2d(x, window=window)


@register("maxpool2d", "kernel")
def _maxpool_kernel(x, window):
    # The kernel takes SRM input and forms the variance itself, bit for
    # bit as to_var() does, without to_var()'s two elementwise launches.
    if window != 2:
        raise ValueError("the PFP max pool is specialised to k=2")
    mu, var = ops.pfp_maxpool2d(x.mean, x.second, rep=x.rep)
    return GaussianTensor(mu.to(x.dtype), var.to(x.dtype), VAR)


def pfp_maxpool2d(x: GaussianTensor, window: int = 2,
                  impl: Optional[str] = None) -> GaussianTensor:
    """PFP max pool (NHWC). Consumes VAR, emits VAR; each impl converts an
    SRM input."""
    return get_op("maxpool2d", impl)(x, window)


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
    if act is None and is_gaussian(x) and _fusion_active(impl):
        # Fusion pass, step 1: defer; a dense may consume this norm.
        return _PendingNorm(x, gain, None, "rmsnorm", eps, impl)
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
    if act is None and is_gaussian(x) and _fusion_active(impl):
        return _PendingNorm(x, gain, bias, "layernorm", eps, impl)
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
# norm_dense_act — the fused unit (norm -> dense -> activation)
# ---------------------------------------------------------------------------
# A transformer block's FFN entry is a fixed chain: pre-norm, a bias-free
# dense (the gate projection of a gated MLP, the up projection otherwise),
# then a moment-matched activation. With the fusion pass on (it is off by
# default) the public functions above hand out lazy "pending"
# GaussianTensors instead of running the norm and the dense. If the chain
# completes at an activation AND the tuned-schedule cache holds a
# ``norm_dense_act`` schedule for its shape, one kernel runs the whole
# chain (csrc/pfp_fused.cu, bit for bit the unfused kernel chain). Any
# other use of a pending (attention projections, residuals, the LM head,
# a cache miss) runs the exact unfused chain, so the pass never changes a
# result.
_FUSION = False


def set_fusion(enabled: bool) -> bool:
    """Turn the norm -> dense -> activation fusion pass on or off for the
    process. Returns the previous setting, so scopes nest."""
    global _FUSION
    prev = _FUSION
    _FUSION = bool(enabled)
    return prev


def get_fusion() -> bool:
    return _FUSION


@contextlib.contextmanager
def fusion(enabled: bool = True):
    """Scoped :func:`set_fusion`."""
    prev = set_fusion(enabled)
    try:
        yield
    finally:
        set_fusion(prev)


def _fusion_active(impl: Optional[str]) -> bool:
    return _FUSION and resolve_impl(impl) == "kernel"


class _PendingFusion(GaussianTensor):
    """A lazy GaussianTensor: it runs its unfused value on the first read
    of ``mean``, ``second`` or ``rep`` and keeps it. Being a GaussianTensor
    keeps ``is_gaussian`` and every layer helper working unchanged.

    GaussianTensor is a frozen dataclass: the three fields are overridden
    here as properties, and the dataclass ``__init__`` (which would assign
    them) is never called. Everything the base class derives from the
    fields (``var``, ``srm``, ``shape``, ``dtype``, ``reshape``,
    ``__add__``, ``to_var``, ``to_srm``, ``__repr__``) reads them through
    these properties and so forces the value; ``__eq__`` and ``__hash__``
    compare the forced value."""

    def __init__(self):
        object.__setattr__(self, "_value", None)

    def _run(self) -> GaussianTensor:  # pragma: no cover - abstract
        raise NotImplementedError

    def _force(self) -> GaussianTensor:
        if self._value is None:
            object.__setattr__(self, "_value", self._run())
        return self._value

    @property
    def mean(self):
        return self._force().mean

    @property
    def second(self):
        return self._force().second

    @property
    def rep(self):
        return self._force().rep

    def __eq__(self, other):
        if isinstance(other, _PendingFusion):
            other = other._force()
        return self._force() == other

    def __hash__(self):
        return hash(self._force())


class _PendingNorm(_PendingFusion):
    """A norm deferred in case a dense and an activation follow. Its value
    is the registered unfused norm op's, run once: a gated MLP's two
    projections share it."""

    def __init__(self, x, gain, bias, kind, eps, impl):
        super().__init__()
        for name, value in (("x", x), ("gain", gain), ("bias", bias),
                            ("kind", kind), ("eps", eps), ("impl", impl)):
            object.__setattr__(self, name, value)

    def _run(self) -> GaussianTensor:
        if self.kind == "rmsnorm":
            return get_op("rmsnorm", self.impl)(self.x, self.gain, self.eps,
                                                None)
        return get_op("layernorm", self.impl)(self.x, self.gain, self.bias,
                                              self.eps, None)


class _PendingNormDense(_PendingFusion):
    """A bias-free SRM dense over a pending norm. A fusable activation next
    runs the whole chain as one kernel (:meth:`fuse`, on a cache hit);
    otherwise its value is the unfused dense over the (shared) norm."""

    def __init__(self, pending_norm, w, impl):
        super().__init__()
        object.__setattr__(self, "pending_norm", pending_norm)
        object.__setattr__(self, "w", w)
        object.__setattr__(self, "impl", impl)

    def _run(self) -> GaussianTensor:
        h = self.pending_norm._force()
        return get_op("dense", self.impl)(_to_compute_rep(h, "srm"),
                                          self.w, "srm")

    def fuse(self, act: str, impl: Optional[str]):
        """The fused result, or None: the caller then runs the unfused
        activation over this pending's value. The cache is consulted on
        every attempt at a shape the fused kernel reproduces bit for bit
        (``pfp_fused.fusable``), hit or miss, so shape recording finds the
        unit and the consult counters see it."""
        norm = self.pending_norm
        x, w = norm.x, self.w
        if (self._value is not None or act not in KINDS
                or not _fusion_active(impl)
                or not fusable(x.shape[-1], w.mean.shape[-1])):
            return None
        shape_key = (_rows(x.shape), x.shape[-1], w.mean.shape[-1])
        sched = _schedule_for("norm_dense_act", shape_key, x.dtype,
                              x.mean.device)
        if sched is None:
            return None  # cache miss: the unfused chain, bit for bit
        return _nda_run(x, norm.gain, norm.bias, w, norm.kind, norm.eps, act,
                        sched)


def _nda_run(x, gain, bias, w, norm, eps, act, sched):
    """The fused kernel with a resolved schedule (None: the default tile).

    The reference also hands the fused kernel the standalone dense op's
    ``block_k``, so that its K tiling, and with it the fp32 sum, matches
    the unfused dense. There is nothing to hand over here: the port's
    dense kernel sums K in one fixed order whatever its tile, and so does
    the fused kernel, so only the fused unit's own schedule is read."""
    mu, srm = ops.pfp_norm_dense_act(
        x.mean, x.second, gain, bias, w.mean, w.srm, norm=norm, rep=x.rep,
        eps=eps, act=act, schedule=sched)
    return GaussianTensor(mu.to(x.dtype), srm.to(x.dtype), SRM)


@register("norm_dense_act", "eager")
def _norm_dense_act_eager(x, gain, bias, w, norm, eps, act):
    # The fused unit's eager impl is the unfused chain by construction.
    if norm == "rmsnorm":
        h = _rmsnorm_eager(x, gain, eps, None)
    else:
        h = _layernorm_eager(x, gain, bias, eps, None)
    out = _dense_eager(_to_compute_rep(h, "srm"), w, "srm")
    return _activation_eager(out.to_var(), act)


@register("norm_dense_act", "kernel")
def _norm_dense_act_kernel(x, gain, bias, w, norm, eps, act):
    shape_key = (_rows(x.shape), x.shape[-1], w.mean.shape[-1])
    sched = _schedule_for("norm_dense_act", shape_key, x.dtype,
                          x.mean.device)
    return _nda_run(x, gain, bias, w, norm, eps, act, sched)


def pfp_norm_dense_act(x: GaussianTensor, gain, bias, w: GaussianTensor, *,
                       norm: str = "rmsnorm", eps: float = 1e-6,
                       act: str = "silu",
                       impl: Optional[str] = None) -> GaussianTensor:
    """Fused norm -> bias-free dense -> activation. Emits SRM. ``bias`` is
    the LayerNorm shift (None for RMSNorm). Models rarely call this: the
    fusion pass rewrites eligible chains onto the fused kernel itself."""
    if norm not in ("rmsnorm", "layernorm"):
        raise ValueError(f"unknown norm {norm!r}")
    return get_op("norm_dense_act", impl)(x, gain, bias, w, norm, eps, act)


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
