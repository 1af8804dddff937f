"""SVI -> PFP conversion (paper §4): the deployment artifact.

Counterpart of ``repro/bayes/convert.py``. Every variational leaf
(``mu``, ``rho``) becomes ``mu`` plus a calibrated second moment: the SRM
E[w^2] by default (what the kernels consume), or the variance. As in the
reference code, this holds for every ``rho`` leaf, first layer and biases
included.
"""
from __future__ import annotations

import copy

import torch
from torch import nn

from repro_torch.nn.module import BayesParam


def svi_to_pfp(model: nn.Module, *, calibration_factor: float = 1.0,
               rep: str = "srm") -> nn.Module:
    """A converted copy of ``model``; ``model`` itself is left as it is.

    ``calibration_factor`` globally rescales the variances (paper Table 1
    uses 0.3 / 0.4 for MLP / LeNet-5). The copy is a deployment artifact:
    none of its tensors requires a gradient, whatever the source's did.
    """
    if rep not in ("srm", "var"):
        raise ValueError(f"unknown rep {rep!r}")
    out = copy.deepcopy(model).requires_grad_(False)
    leaves = [(name, m) for name, m in out.named_modules()
              if isinstance(m, BayesParam) and "rho" in m.keys()]
    for name, leaf in leaves:
        mu = leaf.mu
        var = torch.exp(2.0 * leaf.rho) * calibration_factor
        new = (BayesParam(mu=mu, srm=var + torch.square(mu)) if rep == "srm"
               else BayesParam(mu=mu, var=var))
        parent_name, _, attr = name.rpartition(".")
        setattr(out.get_submodule(parent_name), attr, new)
    return out


def fit_calibration_factor(eval_fn, candidates=(0.1, 0.2, 0.3, 0.4, 0.5,
                                                0.7, 1.0, 1.5, 2.0)):
    """Line search for the global variance calibration factor.

    eval_fn(cal) -> scalar score (higher is better, e.g. OOD AUROC on a
    validation split). Returns (best_factor, best_score).
    """
    best, best_score = None, -float("inf")
    for c in candidates:
        s = float(eval_fn(c))
        if s > best_score:
            best, best_score = c, s
    return best, best_score
