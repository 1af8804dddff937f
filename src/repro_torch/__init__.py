"""PyTorch/CUDA port of the Probabilistic Forward Pass (PFP) system.

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``core``, ``kernels``, ``nn``, ``models``, ``bayes``, ``data``) and
imports nothing of it. Entry points take an explicit ``device`` and default
to the CUDA card; they raise rather than fall back to the CPU when no card
is present.

fp32 means IEEE fp32 here: the Eq. 12 variance is a small difference of two
large accumulated sums, and TF32 (cuDNN's default for fp32 convolutions)
keeps only ~3 decimal digits. The port therefore turns TF32 off for both
cuBLAS and cuDNN when it is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
