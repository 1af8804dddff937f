"""Execution modes (counterpart of ``repro/core/modes.py``).

  DETERMINISTIC : forward on weight means only
  SVI           : K reparameterized weight samples
  PFP           : one analytic moment-propagating pass
"""
from __future__ import annotations

import enum


class Mode(str, enum.Enum):
    DETERMINISTIC = "deterministic"
    SVI = "svi"
    PFP = "pfp"

    @classmethod
    def parse(cls, value: "Mode | str") -> "Mode":
        if isinstance(value, Mode):
            return value
        return cls(value.lower())
