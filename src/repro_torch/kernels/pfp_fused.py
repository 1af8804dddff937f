"""The fused PFP unit on Hopper: norm -> VAR to SRM -> Eq. 12 dense ->
moment-matched activation, in one kernel.

Replaces ``repro/kernels/pfp_fused.py``: ``pfp_norm_dense_act_pallas``
(``_norm_dense_act_kernel``). The kernel is ``csrc/pfp_fused.cu``, bound
by the fp32 operations of its dense at prefill and by the weight stream
at decode; its source says how it reproduces the unfused kernel chain bit
for bit. It is instantiated for the (block_m, block_n) output tiles of
``TILES``, the autotuner's search space. The plain version is
``pfp_norm_dense_act_ref`` (``kernels/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import LAUNCHES, cuda_operands, stream_ptr
from repro_torch.kernels.pfp_activations import KINDS
from repro_torch.kernels.pfp_norms import NORMS, REPS
from repro_torch.kernels.ref import pfp_norm_dense_act_ref  # noqa: F401

# The (block_m, block_n) tiles csrc/pfp_fused.cu is instantiated for:
# 16 x 16 threads, each holding block_m / 16 rows and block_n / 16 columns.
TILES = ((16, 64), (16, 128), (32, 64), (64, 64), (64, 128), (128, 64))
DEFAULT_TILE = (64, 64)


def check_config(norm: str, rep: str, act: str, tile) -> None:
    """Raise unless the kernel is instantiated for this norm, input
    representation, activation and tile."""
    if norm not in NORMS or rep not in REPS or act not in KINDS \
            or tuple(tile) not in TILES:
        raise ValueError(f"no fused norm_dense_act kernel for norm {norm!r}, "
                         f"rep {rep!r}, act {act!r}, tile {tuple(tile)}; "
                         f"tiles are {TILES}")


def pfp_norm_dense_act_cuda(mu, second, gain, bias, mu_w, srm_w, *,
                            norm: str = "rmsnorm", rep: str = "var",
                            eps: float = 1e-6, act: str = "silu",
                            tile=DEFAULT_TILE):
    """Launch the fused kernel on 2-D CUDA operands: the norm input
    (mu, second) (M, K), the norm's gain and (LayerNorm) bias (K,), the
    dense weight (mu_w, srm_w) (K, N). Returns fp32 (mean, srm) (M, N)."""
    check_config(norm, rep, act, tile)
    if bias is None:  # RMSNorm reads no bias
        bias = torch.zeros_like(gain) if norm == "layernorm" else gain
    mu, second, gain, bias, mu_w, srm_w = cuda_operands(
        mu, second, gain, bias, mu_w, srm_w)
    m, k = mu.shape
    n = mu_w.shape[1]
    if (second.shape != mu.shape or gain.shape != (k,) or bias.shape != (k,)
            or mu_w.shape != (k, n) or srm_w.shape != (k, n)):
        raise ValueError(f"norm_dense_act shapes x {tuple(mu.shape)} / "
                         f"{tuple(second.shape)}, gain {tuple(gain.shape)}, "
                         f"bias {tuple(bias.shape)}, w {tuple(mu_w.shape)} / "
                         f"{tuple(srm_w.shape)}")
    mean = torch.empty((m, n), dtype=torch.float32, device=mu.device)
    srm = torch.empty_like(mean)
    if m == 0 or n == 0:
        return mean, srm
    if k == 0:
        raise ValueError("norm_dense_act needs K >= 1: a norm over no "
                         "features is undefined")
    lib = _build.load()
    with torch.cuda.device(mu.device):
        status = lib.pfp_norm_dense_act_launch(
            NORMS[norm], REPS[rep], KINDS[act], tile[0], tile[1],
            mu.data_ptr(), second.data_ptr(), gain.data_ptr(),
            bias.data_ptr(), mu_w.data_ptr(), srm_w.data_ptr(),
            mean.data_ptr(), srm.data_ptr(), m, n, k, eps,
            stream_ptr(mu.device))
    _build.check(status, "pfp_norm_dense_act_launch")
    LAUNCHES["norm_dense_act"] += 1
    return mean, srm
