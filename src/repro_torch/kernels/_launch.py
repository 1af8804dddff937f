"""What every kernel launcher shares: operand checks, the stream, and the
launch counts.

``LAUNCHES`` holds one plain integer per kernel. A launcher adds one right
after its kernel was launched without error, and nowhere else, so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

LAUNCHES = {"dense": 0, "dense_first_layer": 0, "dense_var": 0,
            "activation": 0, "maxpool2d": 0, "rmsnorm": 0, "layernorm": 0,
            "glu_product": 0, "attention": 0, "attention_cache": 0,
            "attention_paged": 0, "dense_batched": 0,
            "dense_batched_first_layer": 0, "dense_batched_var": 0,
            "norm_dense_act": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def cuda_operands(*tensors: torch.Tensor):
    """Contiguous fp32 copies (or the tensors themselves) on one CUDA
    device. Raises on a mix of devices: a kernel never reads host memory."""
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"a CUDA kernel needs CUDA tensors, got {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"operands on {device} and {t.device}")
    return tuple(t.to(torch.float32).contiguous() for t in tensors)


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on a 16-byte
    boundary (a view into another tensor): kernels that load float4
    need the alignment."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_empty(device: torch.device) -> None:
    """Launch ``csrc/pfp_floor.cu``'s empty kernel on ``device``: what one
    launch costs the device when the kernel does nothing. Measurement
    only; it is on no path and has no launch count."""
    from repro_torch.kernels import _build
    lib = _build.load()
    with torch.cuda.device(device):
        status = lib.pfp_empty_launch(stream_ptr(device))
    _build.check(status, "pfp_empty_launch")
