"""Adam with decoupled weight decay, global-norm clipping and schedules.

Counterpart of ``repro/training/optimizer.py`` (paper §4 trains the
SVI-BNNs with Adam). The port's own code rather than ``torch.optim.Adam``,
so its state can be held against the reference's step for step: the
moments are dicts keyed by parameter name, and ``update`` returns the
reference's ``grad_norm`` and ``lr``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Sequence

import torch


class AdamState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Adam:
    learning_rate: Callable[[int], float] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        return AdamState(
            step=0,
            m={k: torch.zeros_like(p, memory_format=torch.preserve_format)
               for k, p in params.items()},
            v={k: torch.zeros_like(p, memory_format=torch.preserve_format)
               for k, p in params.items()})

    def _lr(self, step: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return self.learning_rate

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamState,
               params: Mapping[str, torch.Tensor]):
        """One step. ``params`` and the moments in ``state`` are updated in
        place, and ``grads`` may be scaled in place by the clipping.
        Returns (params, new_state, {'grad_norm', 'lr'})."""
        names = list(params)
        g = [grads[k] for k in names]
        p = [params[k] for k in names]
        m = [state.m[k] for k in names]
        v = [state.v[k] for k in names]
        gnorm = global_norm(g)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            torch._foreach_mul_(g, scale)

        step = state.step + 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        lr = self._lr(step)
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step

        # delta = mhat / (sqrt(vhat) + eps) (+ weight_decay * p), built in
        # one temporary list beside the denominators: the moments of a
        # large model are several GB each.
        delta = torch._foreach_div(m, bc1)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(delta, den)
        del den
        if self.weight_decay:
            torch._foreach_add_(delta, p, alpha=self.weight_decay)
        torch._foreach_add_(p, delta, alpha=-lr)
        return params, AdamState(step, state.m, state.v), {
            "grad_norm": gnorm, "lr": lr}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    if not tensors:
        return torch.zeros(())
    sums = [torch.sum(torch.square(t.to(torch.float32))) for t in tensors]
    return torch.sqrt(torch.stack(sums).sum())


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``."""
    def fn(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        frac = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return 0.5 * base_lr * (1 + math.cos(math.pi * frac))
    return fn
