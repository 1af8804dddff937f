"""Run provenance: the facts needed to compare two result files.

Counterpart of ``repro/obs/runmeta.py``. Every metrics export carries this
dict so that a CPU run and a run on the card can never be confused: git
sha (what code), device kind, backend and power limit (what hardware:
a card set below its maximum power runs slower under load), torch and
CUDA versions (what toolchain), and whether TF32 is off for cuBLAS and
cuDNN (``repro_torch/__init__.py`` turns it off: the port computes in
IEEE fp32). Without a card every device fact reads ``"unknown"``.
"""
from __future__ import annotations

import functools
import subprocess


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """Current commit sha ('unknown' outside a git checkout)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, check=False)
        sha = out.stdout.strip()
        if out.returncode == 0 and sha:
            return sha
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


@functools.lru_cache(maxsize=1)
def device_kind() -> str:
    """``torch.cuda.get_device_name(0)`` ('unknown' without a card)."""
    import torch

    if not torch.cuda.is_available():
        return "unknown"
    return torch.cuda.get_device_name(0)


@functools.lru_cache(maxsize=1)
def power_limit() -> str:
    """Card 0's power limit as ``nvidia-smi --query-gpu=power.limit``
    reports it ('unknown' without ``nvidia-smi`` or a card)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10, check=False)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines or "," not in lines[0]:
        return "unknown"
    return lines[0].rsplit(",", 1)[1].strip()


def run_metadata() -> dict:
    """Provenance dict for result files. Nothing here raises: a run
    without a card still stamps its files."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "git_sha": git_sha(),
        "device_kind": device_kind(),
        "backend": "cuda" if cuda else "cpu",
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda or "unknown",
        "power_limit": power_limit() if cuda else "unknown",
        "tf32_off": (not torch.backends.cuda.matmul.allow_tf32
                     and not torch.backends.cudnn.allow_tf32),
    }


__all__ = ["run_metadata", "git_sha", "device_kind", "power_limit"]
