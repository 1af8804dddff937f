"""GaussianTensor: mean plus a second moment in a static representation.

Counterpart of ``repro/core/gaussian.py``. ``rep='var'`` means ``second``
holds the variance, ``rep='srm'`` the second raw moment E[x^2]. The
contract is the paper's: compute layers consume SRM and emit VAR,
activations consume VAR and emit SRM; anything else converts explicitly
with ``E[x^2] = mu^2 + Var[x]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

VAR = "var"
SRM = "srm"

# Floor applied when interpreting `second` as a variance. Keeps erf/exp and
# sqrt paths finite when a distribution collapses to a point mass.
VAR_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class GaussianTensor:
    """Elementwise-independent Gaussian tensor (mean + second moment)."""

    mean: torch.Tensor
    second: torch.Tensor
    rep: str = VAR

    @classmethod
    def deterministic(cls, x: torch.Tensor) -> "GaussianTensor":
        """A point mass: variance 0."""
        return cls(x, torch.zeros_like(x), VAR)

    @property
    def shape(self):
        return self.mean.shape

    @property
    def dtype(self):
        return self.mean.dtype

    def reshape(self, *shape) -> "GaussianTensor":
        return GaussianTensor(self.mean.reshape(*shape),
                              self.second.reshape(*shape), self.rep)

    @property
    def var(self) -> torch.Tensor:
        """Variance, converting from SRM if necessary."""
        if self.rep == VAR:
            return self.second
        return self.second - torch.square(self.mean)

    @property
    def srm(self) -> torch.Tensor:
        """Second raw moment E[x^2], converting from VAR if necessary."""
        if self.rep == SRM:
            return self.second
        return self.second + torch.square(self.mean)

    def to_var(self) -> "GaussianTensor":
        if self.rep == VAR:
            return self
        return GaussianTensor(self.mean, self.var, VAR)

    def to_srm(self) -> "GaussianTensor":
        if self.rep == SRM:
            return self
        return GaussianTensor(self.mean, self.srm, SRM)

    def __add__(self, other: Any) -> "GaussianTensor":
        """Sum of independent Gaussians: means add, variances add."""
        if isinstance(other, GaussianTensor):
            return GaussianTensor(self.mean + other.mean,
                                  self.var + other.var, VAR)
        return GaussianTensor(self.mean + other, self.var, VAR)

    __radd__ = __add__


def is_gaussian(x: Any) -> bool:
    return isinstance(x, GaussianTensor)


def as_gaussian(x: Any) -> GaussianTensor:
    """Lift a plain tensor to a point mass; pass GaussianTensors through."""
    return x if is_gaussian(x) else GaussianTensor.deterministic(x)
